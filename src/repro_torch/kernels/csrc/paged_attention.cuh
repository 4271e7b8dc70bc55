// The page sweep shared by the paged decode and paged prefill attention
// kernels.
//
// A block serves one (slot, kv-head) and a set of query rows, one warp per
// row. For each logical page of its range it resolves the physical block
// through the slot's table row (clamped into the pool, so a sentinel entry
// can never be dereferenced — and callers stop at the frontier, before any
// page the engine left unallocated), stages the page's K and V for this
// kv-head in shared memory as float32, and every warp folds the page's
// columns below its own row frontier into an online softmax state (running
// max m, denominator l, unnormalised accumulator acc, in registers). A lane
// owns the head-dim elements lane, lane + 32, ...; a column's score is a
// warp-wide sum, taken for a group of columns at a time so the sums
// pipeline. Columns past a row's frontier are skipped, never read; a
// row with no visible column ends with l = 0 and writes zeros, as the
// reference's max(l, 1e-30) divide does.
#pragma once

#include "common.cuh"

namespace rt {

constexpr float kNeg = -1e30f;
constexpr int kGroup = 8;  // columns scored together before one rescale

// E = head-dim elements per lane (hd <= 32 * E).
template <int E>
struct SoftmaxState {
  float m = kNeg;
  float l = 0.f;
  float acc[E] = {};
};

template <typename T, int E>
__device__ __forceinline__ void load_row(const T* __restrict__ row, int hd, bool active,
                                         float (&out)[E]) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const int d = lane + 32 * e;
    out[e] = (active && d < hd) ? to_f(row[d]) : 0.f;
  }
}

// Fold logical pages [p_begin, p_end) into ``st``. Every thread of the block
// must call this with the same page range (it synchronises per page).
template <typename T, int E>
__device__ __forceinline__ void sweep_pages(
    const float (&qr)[E], const T* __restrict__ k_pool, const T* __restrict__ v_pool,
    const int32_t* __restrict__ table_row, int n_blocks, int page, int hkv, int hd, int h,
    int p_begin, int p_end, int row_end, bool active, float scale, float* ks, float* vs,
    SoftmaxState<E>& st) {
  const int lane = threadIdx.x & 31;
  const int tile = page * hd;
  const size_t tok_stride = static_cast<size_t>(hkv) * hd;
  for (int p = p_begin; p < p_end; ++p) {
    __syncthreads();  // the previous page's tiles are consumed
    const int blk = min(max(table_row[p], 0), n_blocks - 1);
    const size_t base = (static_cast<size_t>(blk) * page * hkv + h) * hd;
    for (int i = threadIdx.x; i < tile; i += blockDim.x) {
      const int t = i / hd;
      const int d = i - t * hd;
      const size_t off = base + t * tok_stride + d;
      ks[i] = to_f(k_pool[off]);
      vs[i] = to_f(v_pool[off]);
    }
    __syncthreads();
    if (!active) continue;
    const int t_end = min(page, row_end - p * page);
    // columns in groups of kGroup: the group's scores are independent warp
    // sums (they pipeline), then one rescale of the running state per group
    for (int t0 = 0; t0 < t_end; t0 += kGroup) {
      const int n = min(kGroup, t_end - t0);
      float sc[kGroup];
#pragma unroll
      for (int j = 0; j < kGroup; ++j) {
        const float* kt = ks + (t0 + j) * hd;
        float s = 0.f;
#pragma unroll
        for (int e = 0; e < E; ++e) {
          const int d = lane + 32 * e;
          if (j < n && d < hd) s += qr[e] * kt[d];
        }
        sc[j] = s;
      }
      float g_max = kNeg;
#pragma unroll
      for (int j = 0; j < kGroup; ++j) {
        sc[j] = warp_sum(sc[j]) * scale;
        if (j < n) g_max = fmaxf(g_max, sc[j]);
      }
      const float m_new = fmaxf(st.m, g_max);
      const float alpha = expf(st.m - m_new);
      st.l *= alpha;
#pragma unroll
      for (int e = 0; e < E; ++e) st.acc[e] *= alpha;
#pragma unroll
      for (int j = 0; j < kGroup; ++j) {
        if (j < n) {
          const float pr = expf(sc[j] - m_new);
          const float* vt = vs + (t0 + j) * hd;
          st.l += pr;
#pragma unroll
          for (int e = 0; e < E; ++e) {
            const int d = lane + 32 * e;
            if (d < hd) st.acc[e] += pr * vt[d];
          }
        }
      }
      st.m = m_new;
    }
  }
}

// Normalise and store one row (in T).
template <typename T, int E>
__device__ __forceinline__ void store_row(const SoftmaxState<E>& st, int hd,
                                          T* __restrict__ out_row) {
  const int lane = threadIdx.x & 31;
  const float denom = fmaxf(st.l, 1e-30f);
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const int d = lane + 32 * e;
    if (d < hd) out_row[d] = from_f<T>(st.acc[e] / denom);
  }
}

}  // namespace rt

// Instantiate a launcher template over dtype x lanes-per-head: the
// smallest E in {1, 2, 4, 8} with hd <= 32 * E.
#define RT_DISPATCH_ATTENTION(LAUNCH, dtype, hd, ...)                                \
  do {                                                                             \
    const int e_need = ((hd) + 31) / 32;                                           \
    if ((dtype) != RT_F32 && (dtype) != RT_BF16) return cudaErrorInvalidValue;     \
    if (e_need <= 1)                                                               \
      return (dtype) == RT_F32 ? LAUNCH<float, 1>(__VA_ARGS__)                     \
                               : LAUNCH<__nv_bfloat16, 1>(__VA_ARGS__);            \
    if (e_need <= 2)                                                               \
      return (dtype) == RT_F32 ? LAUNCH<float, 2>(__VA_ARGS__)                     \
                               : LAUNCH<__nv_bfloat16, 2>(__VA_ARGS__);            \
    if (e_need <= 4)                                                               \
      return (dtype) == RT_F32 ? LAUNCH<float, 4>(__VA_ARGS__)                     \
                               : LAUNCH<__nv_bfloat16, 4>(__VA_ARGS__);            \
    if (e_need <= 8)                                                               \
      return (dtype) == RT_F32 ? LAUNCH<float, 8>(__VA_ARGS__)                     \
                               : LAUNCH<__nv_bfloat16, 8>(__VA_ARGS__);            \
    return cudaErrorInvalidValue;                                                  \
  } while (0)
