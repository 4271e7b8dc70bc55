// The page sweep shared by the paged decode, paged prefill and dense decode
// attention kernels, and the split-range decode kernels built on it.
//
// A block serves one (slot, kv-head) and a set of query rows, one warp per
// row. For each logical page (a tile of ``page`` cache rows) of its range
// it resolves where the tile lives through a block policy — a slot's block
// table row for the paged pools (clamped into the pool, so a sentinel entry
// can never be dereferenced — and callers stop at the frontier, before any
// page the engine left unallocated), plain arithmetic for a dense slot
// cache — stages the tile's K and V for this kv-head in shared memory as
// float32, and every warp folds the tile's columns below its own row
// frontier into an online softmax state (running max m, denominator l,
// unnormalised accumulator acc, in registers). Only rows below the block's
// frontier are staged, so a sweep never reads past a slot's cache. A lane
// owns the head-dim elements lane, lane + 32, ...; a column's score is a
// warp-wide sum, taken for a group of columns at a time so the sums
// pipeline. Columns past a row's frontier are skipped, never read; a row
// with no visible column ends with l = 0 and writes zeros, as the
// reference's max(l, 1e-30) divide does.
//
// The pools hold the query's element type (float32, bf16) or int8 codes.
// An int8 tile carries one float32 scale per (block, kv-head) per pool,
// read through the same block that addresses the tile; staging writes
// float(code) * scale, so shared memory and the softmax are the same for
// every pool type.
#pragma once

#include <type_traits>

#include "common.cuh"

namespace rt {

constexpr float kNeg = -1e30f;
constexpr int kGroup = 8;  // columns scored together before one rescale

// The pools' element type: T itself, or int8 codes with per-tile scales.
template <typename T, bool Q>
using code_t = std::conditional_t<Q, int8_t, T>;

// Block policies: where logical tile p of one slot lives. ``block(p)``
// names the tile's block, which also indexes the (blocks, Hkv) scales;
// ``first_row(p, blk)`` is the tile's first row in the pool's flat
// (rows, Hkv, hd) layout.
struct TableBlocks {  // paged pool, through the slot's block-table row
  const int32_t* row;
  int n_blocks;
  int page;
  __device__ __forceinline__ int block(int p) const { return min(max(row[p], 0), n_blocks - 1); }
  __device__ __forceinline__ size_t first_row(int, int blk) const {
    return static_cast<size_t>(blk) * page;
  }
};

struct SlotTiles {  // dense slot cache: tile p of slot b is block b * tiles + p
  int slot;
  int smax;
  int tile;
  int tiles;
  __device__ __forceinline__ int block(int p) const { return slot * tiles + p; }
  __device__ __forceinline__ size_t first_row(int p, int) const {
    return static_cast<size_t>(slot) * smax + static_cast<size_t>(p) * tile;
  }
};

// Per-launch maps from a slot to its policy, and the rows a slot can hold.
struct TableMap {
  const int32_t* table;
  int n_pages;
  int n_blocks;
  int page;
  __device__ __forceinline__ TableBlocks slot(int b) const {
    return {table + static_cast<size_t>(b) * n_pages, n_blocks, page};
  }
  __device__ __forceinline__ int capacity() const { return n_pages * page; }
};

struct DenseMap {
  int smax;
  int tile;
  int tiles;
  __device__ __forceinline__ SlotTiles slot(int b) const { return {b, smax, tile, tiles}; }
  __device__ __forceinline__ int capacity() const { return smax; }
};

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
// must call this with the same page range and ``stage_end`` (the largest
// row frontier of the block; it synchronises per page); ``row_end`` is this
// warp's own frontier (<= stage_end). ``k_scale``/``v_scale`` are read only
// for int8 pools.
template <typename C, int E, class Blocks>
__device__ __forceinline__ void sweep_pages(
    const float (&qr)[E], const C* __restrict__ k_pool, const C* __restrict__ v_pool,
    const float* __restrict__ k_scale, const float* __restrict__ v_scale, const Blocks& blocks,
    int page, int hkv, int hd, int h, int p_begin, int p_end, int stage_end, int row_end,
    bool active, float scale, float* ks, float* vs, SoftmaxState<E>& st) {
  const int lane = threadIdx.x & 31;
  const size_t tok_stride = static_cast<size_t>(hkv) * hd;
  for (int p = p_begin; p < p_end; ++p) {
    __syncthreads();  // the previous page's tiles are consumed
    const int blk = blocks.block(p);
    const size_t base = (blocks.first_row(p, blk) * hkv + h) * hd;
    const int staged = min(page, stage_end - p * page) * hd;
    if constexpr (std::is_same_v<C, int8_t>) {
      const float sk = k_scale[static_cast<size_t>(blk) * hkv + h];
      const float sv = v_scale[static_cast<size_t>(blk) * hkv + h];
      for (int i = threadIdx.x; i < staged; i += blockDim.x) {
        const int t = i / hd;
        const size_t off = base + t * tok_stride + (i - t * hd);
        ks[i] = static_cast<float>(k_pool[off]) * sk;
        vs[i] = static_cast<float>(v_pool[off]) * sv;
      }
    } else {
      for (int i = threadIdx.x; i < staged; i += blockDim.x) {
        const int t = i / hd;
        const size_t off = base + t * tok_stride + (i - t * hd);
        ks[i] = to_f(k_pool[off]);
        vs[i] = to_f(v_pool[off]);
      }
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

// ---------------------------------------------------------------- decode
//
// One query token per slot. A decode step has only slots x kv-heads
// (slot, kv-head) pairs (16 for qwen2-1.5b on 8 slots), far fewer than the
// card's 132 SMs, and the longest frontier would be swept serially. So the
// slot's tiles split into ranges across a third grid axis (as many as it
// takes to put ~2 blocks on each SM). Each block runs one warp per query
// head of the GQA group over its range (the group shares each staged tile)
// and writes the unnormalised partial (acc, m, l) per head to float32
// scratch; a second, tiny kernel merges the ranges of each (slot, head) and
// normalises. Tiles are swept only up to the slot's frontier. (The kernels
// sit in an unnamed namespace: each source that includes this header gets
// its own copies.)

namespace {

template <typename T, typename C, int E, class Map>
__global__ void decode_split_kernel(const T* __restrict__ q, const C* __restrict__ k_pool,
                                    const C* __restrict__ v_pool,
                                    const float* __restrict__ k_scale,
                                    const float* __restrict__ v_scale, Map map,
                                    const int32_t* __restrict__ kv_valid_len,
                                    float* __restrict__ part, int page, int hkv, int hd, int g,
                                    int pages_per_split, float scale) {
  extern __shared__ float smem[];
  const int b = blockIdx.x;
  const int h = blockIdx.y;
  const int split = blockIdx.z;
  const int n_split = gridDim.z;
  const int head = h * g + threadIdx.x / 32;
  const int len = max(0, min(kv_valid_len[b], map.capacity()));
  const int used = (len + page - 1) / page;
  const int p_begin = split * pages_per_split;
  const int p_end = min(p_begin + pages_per_split, used);
  const size_t row = (static_cast<size_t>(b) * hkv * g + head) * hd;  // q (B, H, hd)
  float qr[E];
  load_row<T, E>(q + row, hd, true, qr);
  SoftmaxState<E> st;
  sweep_pages(qr, k_pool, v_pool, k_scale, v_scale, map.slot(b), page, hkv, hd, h, p_begin,
              p_end, len, len, true, scale, smem, smem + page * hd, st);
  // partial layout: (B, H, n_split, hd + 2) = acc[0:hd], m, l
  float* dst = part + ((static_cast<size_t>(b) * hkv * g + head) * n_split + split) * (hd + 2);
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const int d = lane + 32 * e;
    if (d < hd) dst[d] = st.acc[e];
  }
  if (lane == 0) {
    dst[hd] = st.m;
    dst[hd + 1] = st.l;
  }
}

// One block per (slot, head): out = sum_s acc_s e^(m_s - M) / sum_s l_s e^(m_s - M).
template <typename T>
__global__ void decode_combine_kernel(const float* __restrict__ part, T* __restrict__ out,
                                      int hd, int n_split) {
  const size_t bh = static_cast<size_t>(blockIdx.x) * gridDim.y + blockIdx.y;
  const float* src = part + bh * n_split * (hd + 2);
  float m_max = kNeg;
  for (int s = 0; s < n_split; ++s) m_max = fmaxf(m_max, src[s * (hd + 2) + hd]);
  float l = 0.f;
  for (int s = 0; s < n_split; ++s) {
    const float* ps = src + s * (hd + 2);
    l += ps[hd + 1] * expf(ps[hd] - m_max);
  }
  const float inv = 1.f / fmaxf(l, 1e-30f);
  for (int d = threadIdx.x; d < hd; d += blockDim.x) {
    float acc = 0.f;
    for (int s = 0; s < n_split; ++s) {
      const float* ps = src + s * (hd + 2);
      acc += ps[d] * expf(ps[hd] - m_max);
    }
    out[bh * hd + d] = from_f<T>(acc * inv);
  }
}

template <typename T, typename C, int E, class Map>
cudaError_t launch_decode(const void* q, const void* k_pool, const void* v_pool,
                          const void* k_scale, const void* v_scale, Map map, const void* vl,
                          void* out, void* part, int B, int page, int hkv, int hd, int g,
                          int n_pages, int pages_per_split, int n_split, cudaStream_t stream) {
  if (g < 1 || g > 32 || page < 1 || pages_per_split < 1 || n_split < 1 ||
      static_cast<long>(pages_per_split) * n_split < n_pages)
    return cudaErrorInvalidConfiguration;
  if (std::is_same_v<C, int8_t> && (k_scale == nullptr || v_scale == nullptr))
    return cudaErrorInvalidValue;
  const size_t smem = 2 * static_cast<size_t>(page) * hd * sizeof(float);
  auto kernel = decode_split_kernel<T, C, E, Map>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(B, hkv, n_split), 32 * g, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const C*>(k_pool), static_cast<const C*>(v_pool),
      static_cast<const float*>(k_scale), static_cast<const float*>(v_scale), map,
      static_cast<const int32_t*>(vl), static_cast<float*>(part), page, hkv, hd, g,
      pages_per_split, 1.0f / sqrtf(static_cast<float>(hd)));
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  decode_combine_kernel<T><<<dim3(B, hkv * g), 128, 0, stream>>>(
      static_cast<const float*>(part), static_cast<T*>(out), hd, n_split);
  return cudaGetLastError();
}

}  // namespace
}  // namespace rt

// Instantiate a launcher template LAUNCH<T, Q, E> over dtype x lanes-per-head
// (the smallest E in {1, 2, 4, 8} with hd <= 32 * E); Q (int8 pools) is a
// compile-time bool of the caller.
#define RT_DISPATCH_ATTENTION(LAUNCH, Q, dtype, hd, ...)                            \
  do {                                                                             \
    const int e_need = ((hd) + 31) / 32;                                           \
    if ((dtype) != RT_F32 && (dtype) != RT_BF16) return cudaErrorInvalidValue;     \
    if (e_need <= 1)                                                               \
      return (dtype) == RT_F32 ? LAUNCH<float, Q, 1>(__VA_ARGS__)                  \
                               : LAUNCH<__nv_bfloat16, Q, 1>(__VA_ARGS__);         \
    if (e_need <= 2)                                                               \
      return (dtype) == RT_F32 ? LAUNCH<float, Q, 2>(__VA_ARGS__)                  \
                               : LAUNCH<__nv_bfloat16, Q, 2>(__VA_ARGS__);         \
    if (e_need <= 4)                                                               \
      return (dtype) == RT_F32 ? LAUNCH<float, Q, 4>(__VA_ARGS__)                  \
                               : LAUNCH<__nv_bfloat16, Q, 4>(__VA_ARGS__);         \
    if (e_need <= 8)                                                               \
      return (dtype) == RT_F32 ? LAUNCH<float, Q, 8>(__VA_ARGS__)                  \
                               : LAUNCH<__nv_bfloat16, Q, 8>(__VA_ARGS__);         \
    return cudaErrorInvalidValue;                                                  \
  } while (0)
