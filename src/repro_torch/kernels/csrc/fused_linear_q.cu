// Fused dequant x matmul + NeuroAda bypass on a packed (int8 or NF4) frozen
// base: the forward of every adapted projection when training on a
// quantized base, and every base matmul of a serving step on one (k = 0):
//   y[m, n] = sum_c x[m, c] * deq(c, n) + sum_j val[j, n] * x[m, idx[j, n]] (+ b[n])
//   deq(c, n) = code(c, n) * scales[c / block, n]   (float32, cast to x's dtype)
// with float32 accumulation and one cast to x's dtype at the end.
//
// Replaces the TPU kernel src/repro/kernels/quant_linear.py
// fused_linear_q_pallas (body _fused_q_kernel, dequant _dequant_tile). That
// kernel dequantizes each 512-deep K tile in VMEM and needs K to divide by
// 512 and the tile by the scale block; qwen2-1.5b's wdown (K = 8960) does
// not. Here K runs in 32-deep tiles with a masked tail, any M, N and K,
// any even block >= 2 (a tile may cross scale blocks: each row reads the
// scale row of its own global k), and the bypass is added once in the
// epilogue from x's rows, as in fused_linear.cu.
//
// Bound: operations at the training rows (M = 2048: as fused_linear), bytes
// at the decode rows (M = 8: the packed codes dominate; int8 reads half the
// bytes of bf16, NF4 a quarter, plus 4 bytes of scale per block column).
// Design, a simple first version built on fused_linear.cu:
// - the dense weight never exists in device memory: each K tile's packed
//   codes (int8 (32, 128) or NF4 uint8 (16, 128)) land in shared memory by
//   cp.async (plain loads when rows are not 16-byte aligned), 2 stages deep;
//   each thread loads its row's scales into registers before waiting on
//   the tile, then dequantizes its codes in shared memory to the compute
//   dtype (code * scale in float32, one rounding to bf16 — the plain
//   version's arithmetic);
// - a K tile starts at an even row, so NF4 nibble pairs never straddle
//   tiles, and rows 2i and 2i + 1 share a scale block (block is even);
// - rows at or past K dequantize to 0 (NF4 code 0 is -1, not 0);
// - the NF4 codebook sits in shared memory (16 floats, copied from
//   __constant__ at block start: per-thread indices would serialize reads
//   of constant memory);
// - bf16: WMMA 16x16x16 fragments with float32 accumulators (128x128 block
//   tile, 8 warps of 64x32), as fused_linear; float32: plain FMA (64x64
//   tile, 4x4 per thread), a true float32 product (no TF32);
// - k = 0 (no bypass: the serving base matmul) skips the bypass loop; idx
//   and val may then be null.
// Split-K for the skinny decode rows, wgmma and TMA are later work.
#include <mma.h>

#include "linear.cuh"

enum { RT_Q_INT8 = 0, RT_Q_NF4 = 1 };

namespace {

using namespace nvcuda;
using namespace rt;

__constant__ float kNF4[16] = {
    -1.0f, -0.6961928009986877f, -0.5250730514526367f, -0.39491748809814453f,
    -0.28444138169288635f, -0.18477343022823334f, -0.09105003625154495f, 0.0f,
    0.07958029955625534f, 0.16093020141124725f, 0.24611230194568634f,
    0.33791524171829224f, 0.44070982933044434f, 0.5626170039176941f,
    0.7229568362236023f, 1.0f};

// Packed rows of a K tile of `rows` logical rows.
template <int QT>
__host__ __device__ constexpr int packed_rows(int rows) {
  return QT == RT_Q_NF4 ? rows / 2 : rows;
}

// ------------------------------------------------------------- bf16, WMMA

// dequant work per thread: int8 one row x 16 columns; NF4 one packed row
// (two logical rows) x 8 columns
constexpr int kColsI8 = 16, kColsNF4 = 8;

// The packed codes of K tile k0: packed rows k0/p .. of `prows` in all.
template <int QT, bool VEC>
__device__ __forceinline__ void load_codes(uint8_t (*Bq)[BN], const uint8_t* __restrict__ data,
                                           int n0, int k0, int N, int K) {
  const int tid = threadIdx.x;
  constexpr int kRows = packed_rows<QT>(BK);
  const int p0 = QT == RT_Q_NF4 ? k0 / 2 : k0;
  const int prows = QT == RT_Q_NF4 ? K / 2 : K;
  if (VEC) {
    if (tid < kRows * (BN / 16)) {  // rows x 8 chunks of 16 bytes
      const int r = tid / (BN / 16), nc = (tid % (BN / 16)) * 16;
      const int gp = p0 + r, gn = n0 + nc;
      const bool ok = gp < prows && gn < N;
      cp_async16(&Bq[r][nc], ok ? data + static_cast<size_t>(gp) * N + gn : data, ok);
    }
  } else {
    for (int e = tid; e < kRows * BN; e += kThreadsTC) {
      const int r = e / BN, nc = e % BN;
      const int gp = p0 + r, gn = n0 + nc;
      Bq[r][nc] = (gp < prows && gn < N) ? data[static_cast<size_t>(gp) * N + gn] : 0;
    }
  }
}

// This thread's slice of tile k0: its (first) logical row and columns.
template <int QT>
__device__ __forceinline__ void dequant_slot(int& r, int& c) {
  const int tid = threadIdx.x;
  if (QT == RT_Q_NF4) {
    r = 2 * (tid / (BN / kColsNF4));
    c = (tid % (BN / kColsNF4)) * kColsNF4;
  } else {
    r = tid / (BN / kColsI8);
    c = (tid % (BN / kColsI8)) * kColsI8;
  }
}

// Scales of this thread's row(s) in tile k0, into registers (0 past K or N).
template <int QT>
__device__ __forceinline__ void load_scales(float* s, const float* __restrict__ scales,
                                            int n0, int k0, int N, int K, int block) {
  constexpr int kCols = QT == RT_Q_NF4 ? kColsNF4 : kColsI8;
  int r, c;
  dequant_slot<QT>(r, c);
  const int gk = k0 + r;  // NF4: rows gk and gk + 1 share a block (both even-aligned)
  const float* srow = scales + static_cast<size_t>(gk / block) * N;
#pragma unroll
  for (int i = 0; i < kCols; ++i) {
    const int gn = n0 + c + i;
    s[i] = (gk < K && gn < N) ? __ldg(srow + gn) : 0.f;
  }
}

// Packed codes x register scales -> bf16 tile Bs (rows past K are 0: their
// scales were loaded as 0 and codes x 0 = 0, NF4's -1 included).
template <int QT>
__device__ __forceinline__ void dequant_tile(__nv_bfloat16 (*Bs)[B_LD], const uint8_t (*Bq)[BN],
                                             const float* s, const float* nf4) {
  int r, c;
  dequant_slot<QT>(r, c);
  if (QT == RT_Q_NF4) {
#pragma unroll
    for (int i = 0; i < kColsNF4; ++i) {
      const uint8_t b = Bq[r / 2][c + i];
      Bs[r][c + i] = __float2bfloat16(nf4[b & 0xF] * s[i]);
      Bs[r + 1][c + i] = __float2bfloat16(nf4[b >> 4] * s[i]);
    }
  } else {
#pragma unroll
    for (int i = 0; i < kColsI8; ++i) {
      const float q = static_cast<float>(static_cast<int8_t>(Bq[r][c + i]));
      Bs[r][c + i] = __float2bfloat16(q * s[i]);
    }
  }
}

template <int QT, typename TV, bool VEC>
__global__ void __launch_bounds__(kThreadsTC)
    fused_linear_q_bf16_kernel(const __nv_bfloat16* __restrict__ x,
                               const uint8_t* __restrict__ data,
                               const float* __restrict__ scales,
                               const int32_t* __restrict__ idx, const TV* __restrict__ val,
                               const __nv_bfloat16* __restrict__ bias,
                               __nv_bfloat16* __restrict__ y, int M, int N, int K, int k,
                               int block) {
  // the epilogue's per-warp staging reuses As once the main loop is done
  __shared__ __align__(128) __nv_bfloat16 As[2][BM][A_LD];
  __shared__ __align__(128) __nv_bfloat16 Bs[BK][B_LD];
  __shared__ __align__(16) uint8_t Bq[2][packed_rows<QT>(BK)][BN];
  __shared__ float nf4[16];
  static_assert(sizeof(As) >= kThreadsTC / 32 * 256 * sizeof(float), "epilogue staging");

  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = warp / (BN / WN), wn = warp % (BN / WN);
  if (threadIdx.x < 16) nf4[threadIdx.x] = kNF4[threadIdx.x];

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[WM / 16][WN / 16];
#pragma unroll
  for (int i = 0; i < WM / 16; ++i)
#pragma unroll
    for (int j = 0; j < WN / 16; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  float s[QT == RT_Q_NF4 ? kColsNF4 : kColsI8];
  const int n_tiles = (K + BK - 1) / BK;
  load_x_tile<VEC>(As[0], x, m0, 0, M, K);
  load_codes<QT, VEC>(Bq[0], data, n0, 0, N, K);
  cp_async_commit();
  for (int t = 0; t < n_tiles; ++t) {
    const int st = t & 1;
    load_scales<QT>(s, scales, n0, t * BK, N, K, block);
    if (t + 1 < n_tiles) {
      load_x_tile<VEC>(As[st ^ 1], x, m0, (t + 1) * BK, M, K);
      load_codes<QT, VEC>(Bq[st ^ 1], data, n0, (t + 1) * BK, N, K);
    }
    cp_async_commit();
    cp_async_wait_1();  // tile t has landed; tile t + 1 may still be in flight
    __syncthreads();
    dequant_tile<QT>(Bs, Bq[st], s, nf4);
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a[WM / 16];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> b[WN / 16];
#pragma unroll
      for (int i = 0; i < WM / 16; ++i)
        wmma::load_matrix_sync(a[i], &As[st][wm * WM + i * 16][kk], A_LD);
#pragma unroll
      for (int j = 0; j < WN / 16; ++j)
        wmma::load_matrix_sync(b[j], &Bs[kk][wn * WN + j * 16], B_LD);
#pragma unroll
      for (int i = 0; i < WM / 16; ++i)
#pragma unroll
        for (int j = 0; j < WN / 16; ++j) wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
    }
    __syncthreads();  // stage st and Bs are free before they are refilled
  }

  float* sc = reinterpret_cast<float*>(&As[0][0][0]) + warp * 256;
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

template <int QT, typename TV>
__global__ void __launch_bounds__(kThreadsF)
    fused_linear_q_f32_kernel(const float* __restrict__ x, const uint8_t* __restrict__ data,
                              const float* __restrict__ scales,
                              const int32_t* __restrict__ idx, const TV* __restrict__ val,
                              const float* __restrict__ bias, float* __restrict__ y, int M,
                              int N, int K, int k, int block) {
  __shared__ float As[FK][FM + 4];  // As[c][m]: x tile, transposed
  __shared__ float Bs[FK][FN];      // dequantized weight tile
  __shared__ float nf4[16];
  const int m0 = blockIdx.y * FM, n0 = blockIdx.x * FN;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  if (tid < 16) nf4[tid] = kNF4[tid];
  float acc[4][4] = {};
  for (int k0 = 0; k0 < K; k0 += FK) {
    for (int e = tid; e < FM * FK; e += kThreadsF) {
      const int r = e / FK, c = e % FK;
      const int gm = m0 + r, gk = k0 + c;
      As[c][r] = (gm < M && gk < K) ? x[static_cast<size_t>(gm) * K + gk] : 0.f;
    }
    __syncthreads();  // nf4 is visible before its first read
    for (int e = tid; e < FK * FN; e += kThreadsF) {
      const int r = e / FN, c = e % FN;
      const int gk = k0 + r, gn = n0 + c;
      float w = 0.f;
      if (gk < K && gn < N) {
        const float sc = __ldg(scales + static_cast<size_t>(gk / block) * N + gn);
        if (QT == RT_Q_NF4) {
          const uint8_t b = data[static_cast<size_t>(gk / 2) * N + gn];
          w = nf4[(gk & 1) ? (b >> 4) : (b & 0xF)] * sc;
        } else {
          w = static_cast<float>(reinterpret_cast<const int8_t*>(data)[
                  static_cast<size_t>(gk) * N + gn]) * sc;
        }
      }
      Bs[r][c] = w;
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

template <int QT, typename TV>
cudaError_t launch_bf16(const void* x, const void* data, const void* scales, const void* idx,
                        const void* val, const void* bias, void* y, int M, int N, int K, int k,
                        int block, cudaStream_t stream) {
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  const bool vec = K % 8 == 0 && N % 16 == 0 && (reinterpret_cast<uintptr_t>(x) & 15) == 0 &&
                   (reinterpret_cast<uintptr_t>(data) & 15) == 0;
  auto xb = static_cast<const __nv_bfloat16*>(x);
  auto db = static_cast<const uint8_t*>(data);
  auto sb = static_cast<const float*>(scales);
  auto bb = static_cast<const __nv_bfloat16*>(bias);
  auto yb = static_cast<__nv_bfloat16*>(y);
  auto ib = static_cast<const int32_t*>(idx);
  auto vb = static_cast<const TV*>(val);
  if (vec)
    fused_linear_q_bf16_kernel<QT, TV, true>
        <<<grid, kThreadsTC, 0, stream>>>(xb, db, sb, ib, vb, bb, yb, M, N, K, k, block);
  else
    fused_linear_q_bf16_kernel<QT, TV, false>
        <<<grid, kThreadsTC, 0, stream>>>(xb, db, sb, ib, vb, bb, yb, M, N, K, k, block);
  return cudaGetLastError();
}

template <int QT, typename TV>
cudaError_t launch_f32(const void* x, const void* data, const void* scales, const void* idx,
                       const void* val, const void* bias, void* y, int M, int N, int K, int k,
                       int block, cudaStream_t stream) {
  dim3 grid((N + FN - 1) / FN, (M + FM - 1) / FM);
  fused_linear_q_f32_kernel<QT, TV><<<grid, kThreadsF, 0, stream>>>(
      static_cast<const float*>(x), static_cast<const uint8_t*>(data),
      static_cast<const float*>(scales), static_cast<const int32_t*>(idx),
      static_cast<const TV*>(val), static_cast<const float*>(bias), static_cast<float*>(y), M,
      N, K, k, block);
  return cudaGetLastError();
}

template <int QT>
cudaError_t dispatch(const void* x, const void* data, const void* scales, const void* idx,
                     const void* val, const void* bias, void* y, int M, int N, int K, int k,
                     int block, int x_dtype, int v_dtype, cudaStream_t s) {
  if (x_dtype == RT_BF16 && v_dtype == RT_BF16)
    return launch_bf16<QT, __nv_bfloat16>(x, data, scales, idx, val, bias, y, M, N, K, k,
                                          block, s);
  if (x_dtype == RT_BF16 && v_dtype == RT_F32)
    return launch_bf16<QT, float>(x, data, scales, idx, val, bias, y, M, N, K, k, block, s);
  if (x_dtype == RT_F32 && v_dtype == RT_BF16)
    return launch_f32<QT, __nv_bfloat16>(x, data, scales, idx, val, bias, y, M, N, K, k,
                                         block, s);
  if (x_dtype == RT_F32 && v_dtype == RT_F32)
    return launch_f32<QT, float>(x, data, scales, idx, val, bias, y, M, N, K, k, block, s);
  return cudaErrorInvalidValue;
}

}  // namespace

// data: int8 (K, N) or NF4 uint8 (K/2, N); scales float32 (ceil(K/block), N);
// idx/val (k, N), null when k = 0; bias may be null. x, bias and y share
// x_dtype; val has v_dtype (ignored when k = 0).
extern "C" int rt_fused_linear_q(const void* x, const void* data, const void* scales,
                                 const void* idx, const void* val, const void* bias, void* y,
                                 int M, int N, int K, int k, int block, int qdtype, int x_dtype,
                                 int v_dtype, void* stream) {
  if (block < 2 || block % 2 || K < 1 || k < 0 || (qdtype == RT_Q_NF4 && K % 2))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (qdtype == RT_Q_INT8)
    err = dispatch<RT_Q_INT8>(x, data, scales, idx, val, bias, y, M, N, K, k, block, x_dtype,
                              v_dtype, s);
  else if (qdtype == RT_Q_NF4)
    err = dispatch<RT_Q_NF4>(x, data, scales, idx, val, bias, y, M, N, K, k, block, x_dtype,
                             v_dtype, s);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}
