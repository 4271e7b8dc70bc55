// Fused frozen-base linear + NeuroAda bypass, the training forward of every
// adapted projection:
//   y[m, n] = sum_c x[m, c] * W[c, n] + sum_j val[j, n] * x[m, idx[j, n]] (+ b[n])
// with float32 accumulation and one cast to x's dtype at the end.
//
// Replaces the TPU kernel src/repro/kernels/fused_linear.py:54
// fused_linear_pallas (body _fused_kernel). That kernel walks K in tiles of
// 512 and adds, per K tile, the bypass entries whose index falls inside it
// (a masked lane gather), so it needs K to divide by 512 -- qwen2-1.5b's
// wdown (K = 8960) does not. Here any M, N and K: the same function.
//
// Bound: operations. A training step's layer at M = 2048 rows (batch 4 x
// seq 512) does 2 * 2048 * 46.8 M flops on 0.2 GB: 0.194 ms of bf16 tensor
// work on an H100 against 0.06 ms of HBM traffic; the k * N bypass terms of
// a row are negligible. Three kernels, chosen by fused_linear.route before
// the launch:
//
// bf16 where TMA can describe x and W (K and N multiples of 8, both 16-byte
// aligned): the Hopper mainloop of linear.cuh with DenseW below, tiles from
// fused_linear.linear_plan. What it does about the four limits of the WMMA
// kernel below (12 % of the bf16 peak at M = 2048):
// - tensor path: wgmma m64nRk16 from shared memory (R = the block's x rows,
//   up to 256; W's TMA box is the MN-major A operand as it lands), issued a
//   warpgroup at a time with one group in flight while the next is issued,
//   instead of warp-level 16x16x16 fragments reloaded by load_matrix_sync;
// - depth and barriers: 64-deep K tiles in a ring of 3-4 TMA stages fed by
//   one producer warp; consumers meet the producer only at the stages'
//   mbarriers, never at a block-wide barrier in the loop (wdown's 140 tiles);
// - waves: a block owns 128 columns and R rows picked per shape, so qwen2's
//   N = 1536 projections make 12 x 11 blocks of 192 rows (one wave on 132
//   SMs), N = 256 makes 2 x 64 of 32 rows, N = 8960 70 x 11 (5.8 waves);
// - the bypass: three otherwise idle warps copy each entry's x column out of
//   the staged tile it falls in, so the epilogue reads it from shared memory
//   instead of gathering x's rows from L2.
// The tensor maps of x and W are encoded on the host per call.
//
// bf16 otherwise (the ragged shapes, K = 77 or 4500, an x not 16-byte
// aligned): the first version, one 128x128 output tile per block of 8 warps;
// each warp owns a 64x32 sub-tile as 4x2 WMMA 16x16x16 bf16 fragments with
// float32 accumulators; x and W tiles (128x32 and 32x128) double-buffered in
// shared memory with cp.async when rows are 16-byte aligned, plain loads
// otherwise; out-of-range elements load as zeros.
//
// float32: a plain FMA kernel (64x64 tile, 4x4 outputs per thread), so the
// result is a true float32 product (no TF32).
//
// Epilogue of the WMMA and FMA kernels: each warp stages one 16x16
// accumulator fragment at a time in shared memory; each lane then adds its
// elements' k bypass terms and the bias, casts once and stores.
#include <mma.h>

#include <chrono>

#include "linear.cuh"

namespace {

using namespace nvcuda;
using namespace rt;

// ------------------------------------------------------------- bf16, WMMA

template <bool VEC>
__device__ __forceinline__ void load_tiles(__nv_bfloat16 (*As)[A_LD],
                                           __nv_bfloat16 (*Bs)[B_LD],
                                           const __nv_bfloat16* __restrict__ x,
                                           const __nv_bfloat16* __restrict__ w, int m0,
                                           int n0, int k0, int M, int N, int K) {
  const int tid = threadIdx.x;
  load_x_tile<VEC>(As, x, m0, k0, M, K);
  if (VEC) {
    // W: 32 rows x 16 chunks of 8, 2 a thread
#pragma unroll
    for (int t = 0; t < 2; ++t) {
      const int c = tid + t * kThreadsTC;
      const int r = c >> 4, nc = (c & 15) * 8;
      const int gk = k0 + r, gn = n0 + nc;
      const bool ok = gk < K && gn < N;
      cp_async16(&Bs[r][nc], ok ? w + static_cast<size_t>(gk) * N + gn : w, ok);
    }
  } else {
    const __nv_bfloat16 zero = __float2bfloat16(0.f);
    for (int e = tid; e < BK * BN; e += kThreadsTC) {
      const int r = e / BN, nc = e % BN;
      const int gk = k0 + r, gn = n0 + nc;
      Bs[r][nc] = (gk < K && gn < N) ? w[static_cast<size_t>(gk) * N + gn] : zero;
    }
  }
}

template <typename TV, bool VEC>
__global__ void __launch_bounds__(kThreadsTC)
    fused_linear_bf16_kernel(const __nv_bfloat16* __restrict__ x,
                             const __nv_bfloat16* __restrict__ w,
                             const int32_t* __restrict__ idx, const TV* __restrict__ val,
                             const __nv_bfloat16* __restrict__ bias,
                             __nv_bfloat16* __restrict__ y, int M, int N, int K, int k) {
  __shared__ __align__(128) __nv_bfloat16 As[2][BM][A_LD];
  __shared__ __align__(128) __nv_bfloat16 Bs[2][BK][B_LD];
  __shared__ __align__(128) float scratch[kThreadsTC / 32][16 * 16];

  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = warp / (BN / WN), wn = warp % (BN / WN);

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[WM / 16][WN / 16];
#pragma unroll
  for (int i = 0; i < WM / 16; ++i)
#pragma unroll
    for (int j = 0; j < WN / 16; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  const int n_tiles = (K + BK - 1) / BK;
  load_tiles<VEC>(As[0], Bs[0], x, w, m0, n0, 0, M, N, K);
  cp_async_commit();
  for (int t = 0; t < n_tiles; ++t) {
    const int s = t & 1;
    if (t + 1 < n_tiles) load_tiles<VEC>(As[s ^ 1], Bs[s ^ 1], x, w, m0, n0, (t + 1) * BK, M, N, K);
    cp_async_commit();
    cp_async_wait_1();  // tile t has landed; tile t + 1 may still be in flight
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a[WM / 16];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> b[WN / 16];
#pragma unroll
      for (int i = 0; i < WM / 16; ++i)
        wmma::load_matrix_sync(a[i], &As[s][wm * WM + i * 16][kk], A_LD);
#pragma unroll
      for (int j = 0; j < WN / 16; ++j)
        wmma::load_matrix_sync(b[j], &Bs[s][kk][wn * WN + j * 16], B_LD);
#pragma unroll
      for (int i = 0; i < WM / 16; ++i)
#pragma unroll
        for (int j = 0; j < WN / 16; ++j) wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
    }
    __syncthreads();  // everyone is done with stage s before it is refilled
  }

  float* sc = scratch[warp];
#pragma unroll
  for (int i = 0; i < WM / 16; ++i) {
#pragma unroll
    for (int j = 0; j < WN / 16; ++j) {
      wmma::store_matrix_sync(sc, acc[i][j], 16, wmma::mem_row_major);
      __syncwarp();
      for (int e = lane; e < 256; e += 32) {
        const int m = m0 + wm * WM + i * 16 + e / 16;
        const int n = n0 + wn * WN + j * 16 + e % 16;
        if (m < M && n < N) finish(sc[e], x, idx, val, bias, y, m, n, K, N, k);
      }
      __syncwarp();
    }
  }
}

// ---------------------------------------------------------- float32, FMA

template <typename TV>
__global__ void __launch_bounds__(kThreadsF)
    fused_linear_f32_kernel(const float* __restrict__ x, const float* __restrict__ w,
                            const int32_t* __restrict__ idx, const TV* __restrict__ val,
                            const float* __restrict__ bias, float* __restrict__ y, int M, int N,
                            int K, int k) {
  __shared__ float As[FK][FM + 4];  // As[c][m]: x tile, transposed
  __shared__ float Bs[FK][FN];
  const int m0 = blockIdx.y * FM, n0 = blockIdx.x * FN;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  float acc[4][4] = {};
  for (int k0 = 0; k0 < K; k0 += FK) {
    for (int e = tid; e < FM * FK; e += kThreadsF) {
      const int r = e / FK, c = e % FK;
      const int gm = m0 + r, gk = k0 + c;
      As[c][r] = (gm < M && gk < K) ? x[static_cast<size_t>(gm) * K + gk] : 0.f;
    }
    for (int e = tid; e < FK * FN; e += kThreadsF) {
      const int r = e / FN, c = e % FN;
      const int gk = k0 + r, gn = n0 + c;
      Bs[r][c] = (gk < K && gn < N) ? w[static_cast<size_t>(gk) * N + gn] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int c = 0; c < FK; ++c) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[c][ty * 4 + i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = Bs[c][tx * 4 + j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int m = m0 + ty * 4 + i, n = n0 + tx * 4 + j;
      if (m < M && n < N) finish(acc[i][j], x, idx, val, bias, y, m, n, K, N, k);
    }
  }
}

// ----------------------------------------------------------------- launch

template <typename TV>
cudaError_t launch_bf16(const void* x, const void* w, const void* idx, const void* val,
                        const void* bias, void* y, int M, int N, int K, int k,
                        cudaStream_t stream) {
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  const bool vec = K % 8 == 0 && N % 8 == 0 && (reinterpret_cast<uintptr_t>(x) & 15) == 0 &&
                   (reinterpret_cast<uintptr_t>(w) & 15) == 0;
  auto xb = static_cast<const __nv_bfloat16*>(x);
  auto wb = static_cast<const __nv_bfloat16*>(w);
  auto bb = static_cast<const __nv_bfloat16*>(bias);
  auto yb = static_cast<__nv_bfloat16*>(y);
  auto ib = static_cast<const int32_t*>(idx);
  auto vb = static_cast<const TV*>(val);
  if (vec)
    fused_linear_bf16_kernel<TV, true><<<grid, kThreadsTC, 0, stream>>>(xb, wb, ib, vb, bb, yb,
                                                                         M, N, K, k);
  else
    fused_linear_bf16_kernel<TV, false><<<grid, kThreadsTC, 0, stream>>>(xb, wb, ib, vb, bb, yb,
                                                                          M, N, K, k);
  return cudaGetLastError();
}

template <typename TV>
cudaError_t launch_f32(const void* x, const void* w, const void* idx, const void* val,
                       const void* bias, void* y, int M, int N, int K, int k,
                       cudaStream_t stream) {
  dim3 grid((N + FN - 1) / FN, (M + FM - 1) / FM);
  fused_linear_f32_kernel<TV><<<grid, kThreadsF, 0, stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(w),
      static_cast<const int32_t*>(idx), static_cast<const TV*>(val),
      static_cast<const float*>(bias), static_cast<float*>(y), M, N, K, k);
  return cudaGetLastError();
}

// ------------------------------------------------- bf16, TMA + wgmma

// The weight operand of the Hopper mainloop: W's (64, 128) bf16 tile as two
// 64-column TMA boxes with the 128-byte swizzle, each one consumer
// warpgroup's MN-major A operand as it lands.
struct DenseW {
  static constexpr bool kDequant = false;
  static constexpr int kStageBytes = 2 * kTmaBox;
  static constexpr int kScaleBytes = 0;
  __device__ static float code(int) { return 0.f; }
  __device__ static void load(uint8_t* dst, const CUtensorMap* map, uint64_t* bar, int n0,
                              int t) {
    tma_load_2d(dst, map, bar, n0, t * kTmaBK);
    tma_load_2d(dst + kTmaBox, map, bar, n0 + 64, t * kTmaBK);
  }
};

}  // namespace

// bias may be null. x, w, bias and y share x_dtype; val has v_dtype.
extern "C" int rt_fused_linear(const void* x, const void* w, const void* idx, const void* val,
                               const void* bias, void* y, int M, int N, int K, int k,
                               int x_dtype, int v_dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (x_dtype == RT_BF16 && v_dtype == RT_BF16)
    err = launch_bf16<__nv_bfloat16>(x, w, idx, val, bias, y, M, N, K, k, s);
  else if (x_dtype == RT_BF16 && v_dtype == RT_F32)
    err = launch_bf16<float>(x, w, idx, val, bias, y, M, N, K, k, s);
  else if (x_dtype == RT_F32 && v_dtype == RT_BF16)
    err = launch_f32<__nv_bfloat16>(x, w, idx, val, bias, y, M, N, K, k, s);
  else if (x_dtype == RT_F32 && v_dtype == RT_F32)
    err = launch_f32<float>(x, w, idx, val, bias, y, M, N, K, k, s);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}

// The Hopper route: x, w, bias and y bf16; K and N multiples of 8, x and w
// 16-byte aligned; tile_rows one of linear.cuh's tma_rows_ok.
extern "C" int rt_fused_linear_wgmma(const void* x, const void* w, const void* idx,
                                     const void* val, const void* bias, void* y, int M, int N,
                                     int K, int k, int tile_rows, int v_dtype, void* stream) {
  if (M < 1 || N < 1 || K < 1 || k < 0 || K % 8 || N % 8 || !tma_rows_ok(tile_rows) ||
      (reinterpret_cast<uintptr_t>(x) & 15) || (reinterpret_cast<uintptr_t>(w) & 15) ||
      (v_dtype != RT_F32 && v_dtype != RT_BF16))
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap xm, wm;
  cudaError_t err = encode_x(&xm, x, M, K, tile_rows);
  if (err == cudaSuccess)
    err = encode_2d(&wm, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, w, K, N, 2, kTmaBK, 64, true);
  if (err != cudaSuccess) return static_cast<int>(err);
  const WgmmaArgs a{static_cast<const __nv_bfloat16*>(x), nullptr,
                    static_cast<const int32_t*>(idx), val,
                    static_cast<const __nv_bfloat16*>(bias), static_cast<__nv_bfloat16*>(y),
                    M, N, K, k, 0, v_dtype == RT_F32, 0};
  return static_cast<int>(
      launch_wgmma<DenseW>(tile_rows, xm, wm, wm, a, static_cast<cudaStream_t>(stream)));
}

// Host time of the tensor-map encodes of one rt_fused_linear_wgmma call (x
// and W), repeated `iters` times: total nanoseconds (iters of at most a few
// thousand), or -1 on a failed encode.
extern "C" int rt_linear_encode_ns(const void* x, const void* w, int M, int N, int K,
                                         int tile_rows, int iters) {
  CUtensorMap xm, wm;
  if (encode_tiled() == nullptr) return -1;  // the entry point is looked up once, untimed
  const auto t0 = std::chrono::steady_clock::now();
  for (int i = 0; i < iters; ++i) {
    if (encode_x(&xm, x, M, K, tile_rows) != cudaSuccess ||
        encode_2d(&wm, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, w, K, N, 2, kTmaBK, 64, true) !=
            cudaSuccess)
      return -1;
  }
  const auto t1 = std::chrono::steady_clock::now();
  return static_cast<int>(std::chrono::duration_cast<std::chrono::nanoseconds>(t1 - t0).count());
}
