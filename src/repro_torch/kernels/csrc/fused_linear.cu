// Fused frozen-base linear + NeuroAda bypass, the training forward of every
// adapted projection:
//   y[m, n] = sum_c x[m, c] * W[c, n] + sum_j val[j, n] * x[m, idx[j, n]] (+ b[n])
// with float32 accumulation and one cast to x's dtype at the end.
//
// Replaces the TPU kernel src/repro/kernels/fused_linear.py
// fused_linear_pallas (body _fused_kernel). That kernel walks K in tiles of
// 512 and adds, per K tile, the bypass entries whose index falls inside it
// (a masked lane gather), so it needs K to divide by 512 — qwen2-1.5b's
// wdown (K = d_ff = 8960) does not. Here the base product runs over K in
// 32-wide tiles with a masked tail, any M, N and K, and the whole bypass is
// added once in the epilogue, reading x's rows from L2: the same function.
//
// Bound: operations. At the training shapes (M = 2048 rows, K and N of
// 256..8960) the product does 2*M*K*N flops on M*K + K*N + M*N elements,
// far above the card's ~295 bf16 flops per byte of HBM; the k*N bypass
// terms per row are negligible. Design, a simple first version:
// - bf16: one 128x128 output tile per block of 8 warps; each warp owns a
//   64x32 sub-tile as 4x2 WMMA 16x16x16 bf16 fragments with float32
//   accumulators. x and W tiles (128x32 and 32x128) are double-buffered in
//   shared memory with cp.async when rows are 16-byte aligned (K and N
//   multiples of 8), with plain loads otherwise; out-of-range elements
//   load as zeros. No wgmma or TMA yet.
// - float32: a plain FMA kernel (64x64 tile, 4x4 outputs per thread), so
//   the result is a true float32 product (no TF32).
// - epilogue: each warp stages one 16x16 accumulator fragment at a time in
//   shared memory; each lane then adds its elements' k bypass terms and the
//   bias, casts once and stores.
#include <mma.h>

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
