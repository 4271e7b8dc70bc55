// The pieces shared by the dense and the packed fused linear kernels
// (fused_linear.cu, fused_linear_q.cu): the block tiles, the bf16 x-tile
// loader and the epilogue that adds the NeuroAda bypass and the bias to an
// accumulated element. (The cp.async wrappers live in common.cuh.)
#pragma once

#include "common.cuh"

namespace rt {

// --------------------------------------------------------------- tiles

// bf16 (WMMA): a 128x128 output tile per block of 8 warps, each warp a
// 64x32 sub-tile (2 x 4 warps), 32-deep K tiles.
constexpr int BM = 128, BN = 128, BK = 32;
constexpr int WM = 64, WN = 32;
constexpr int A_LD = BK + 8;  // padded rows keep fragments 32-byte aligned
constexpr int B_LD = BN + 8;
constexpr int kThreadsTC = 256;
// float32 (FMA): a 64x64 output tile, 4x4 outputs per thread, 16-deep K tiles.
constexpr int FM = 64, FN = 64, FK = 16, kThreadsF = 256;

// The x tile (rows m0.., columns k0..) of a bf16 block: cp.async in 16-byte
// chunks when VEC (K a multiple of 8, x 16-byte aligned), plain loads
// otherwise; out-of-range elements load as zeros.
template <bool VEC>
__device__ __forceinline__ void load_x_tile(__nv_bfloat16 (*As)[A_LD],
                                            const __nv_bfloat16* __restrict__ x, int m0, int k0,
                                            int M, int K) {
  const int tid = threadIdx.x;
  if (VEC) {
#pragma unroll
    for (int t = 0; t < 2; ++t) {  // 128 rows x 4 chunks of 8
      const int c = tid + t * kThreadsTC;
      const int r = c >> 2, kc = (c & 3) * 8;
      const int gm = m0 + r, gk = k0 + kc;
      const bool ok = gm < M && gk < K;
      cp_async16(&As[r][kc], ok ? x + static_cast<size_t>(gm) * K + gk : x, ok);
    }
  } else {
    const __nv_bfloat16 zero = __float2bfloat16(0.f);
    for (int e = tid; e < BM * BK; e += kThreadsTC) {
      const int r = e / BK, kc = e % BK;
      const int gm = m0 + r, gk = k0 + kc;
      As[r][kc] = (gm < M && gk < K) ? x[static_cast<size_t>(gm) * K + gk] : zero;
    }
  }
}

// ------------------------------------------------------------ epilogue

// y[m, n] = acc + sum_j val[j, n] * x[m, idx[j, n]] (+ bias[n]), one cast.
template <typename TX, typename TV>
__device__ __forceinline__ void finish(float acc, const TX* __restrict__ x,
                                       const int32_t* __restrict__ idx,
                                       const TV* __restrict__ val, const TX* __restrict__ bias,
                                       TX* __restrict__ y, int m, int n, int K, int N, int k) {
  const TX* xr = x + static_cast<size_t>(m) * K;
  for (int j = 0; j < k; ++j) {
    const size_t e = static_cast<size_t>(j) * N + n;
    // indices come from selection; clamp so a bad one can never read
    // outside the row
    const int i = min(max(idx[e], 0), K - 1);
    acc += to_f(val[e]) * to_f(xr[i]);
  }
  if (bias != nullptr) acc += to_f(bias[n]);
  y[static_cast<size_t>(m) * N + n] = from_f<TX>(acc);
}

}  // namespace rt
