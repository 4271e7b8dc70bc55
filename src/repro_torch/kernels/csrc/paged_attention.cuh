// What the paged decode, paged prefill and dense decode attention kernels
// share: the block policies that say where a slot's logical page (a tile of
// ``page`` cache rows) lives — a slot's block-table row for the paged pools
// (clamped into the pool, so a sentinel entry can never be dereferenced;
// callers stop at the frontier, before any page the engine left
// unallocated), plain arithmetic for a dense slot cache; the float32 page
// sweep of the prefill's CUDA-core kernel; and the decode kernel (below,
// with its own design note).
//
// The sweep (sweep_pages): a block serves one (slot, kv-head) and a set of
// query rows, one warp per row. For each page of its range it stages the
// tile's K and V for this kv-head in shared memory as float32, and every
// warp folds the tile's columns below its own row frontier into an online
// softmax state (running max m, denominator l, unnormalised accumulator
// acc, in registers). Only rows below the block's frontier are staged, so a
// sweep never reads past a slot's cache. A lane owns the head-dim elements
// lane, lane + 32, ...; a column's score is a warp-wide sum, taken for a
// group of columns at a time so the sums pipeline. Columns past a row's
// frontier are skipped, never read; a row with no visible column ends with
// l = 0 and writes zeros, as the reference's max(l, 1e-30) divide does.
//
// The pools hold the query's element type (float32, bf16) or int8 codes.
// An int8 tile carries one float32 scale per (block, kv-head) per pool,
// read through the same block that addresses the tile; the sweep stages
// float(code) * scale, so its shared memory and softmax are the same for
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
  __device__ __forceinline__ int pages() const { return n_pages; }
};

struct DenseMap {
  int smax;
  int tile;
  int tiles;
  __device__ __forceinline__ SlotTiles slot(int b) const { return {b, smax, tile, tiles}; }
  __device__ __forceinline__ int capacity() const { return smax; }
  __device__ __forceinline__ int pages() const { return tiles; }
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
// One query token per slot: softmax(q k^T / sqrt(hd)) v over a slot's cache
// rows below its frontier, for the g query heads of a GQA group. The work
// is 4 * hd flops a (column, head) against hd bytes a column of K and of V,
// so the bound is the bytes, and what sets the time is how many of them are
// in flight: a decode step has few (slot, kv-head) pairs, and a block that
// walks its pages one at a time waits a memory latency per page.
//
// Grid (slot x kv-head x head chunk, page range), sized by
// decode_attention.decode_plan. A block of 4 warps (fewer only where a page
// is too large for four) owns a range of `per` pages of one (slot,
// kv-head) and a.gh query heads of its group (1 on the path: a warp's work
// a page grows with its heads, so a group is served by g / a.gh blocks,
// each reading the pages again, from L2). Warp w owns pages p_begin + w,
// + 4, ... of the range and keeps its own ring of `stages` page stages in
// shared memory: it resolves each page's block through the policy (the
// slot's table row, fetched for all its pages at once and clamped, so a
// sentinel entry is never dereferenced; arithmetic for a dense cache) and
// copies the page's K and V rows for this kv-head with cp.async, 16 bytes
// a lane where the row allows, `stages` pages ahead, in the pool's own type
// (bf16, float32 or int8 codes, with the page's two scales). Rows at or
// past the frontier and the pad of a row to a multiple of 16 elements are
// zero-filled, never read. No block-wide barrier runs until the range ends.
//
// A warp scores cpw = 32 / lpc columns at once: lanes split as (column,
// hd slice of E elements), lpc lanes a column, so a score is log2(lpc)
// shuffles (4 at hd 128). Every column group keeps its own online softmax
// state (m, l, acc) for each of its heads — q's slices stay in registers
// (pre-scaled, by log2 e too where bf16 takes exp2) and each staged row
// serves all the block's heads — and rescales once per chunk of columns.
// An int8 code's scale multiplies the score (k) and p (v) instead of
// every element. At the range's end the column groups merge by shuffles,
// the warps in shared memory in warp order, and the block writes its (acc,
// m, l) per head to float32 scratch; the last block of a (slot, kv-head,
// head chunk) to finish — a ticket counter, reset by that block — merges
// the ranges in index order and normalises. A slot whose pages fit one
// range skips the scratch. The same inputs give the same bits: every sum
// has a fixed order, and the ticket only picks which block sums. Pages are
// swept only up to the frontier; a slot with kv_valid_len 0 writes zeros.
// (The kernels sit in an unnamed namespace: each source that includes this
// header gets its own copies.)

namespace {

struct DecodeArgs {
  const void* q;  // (B, H, hd) in T
  const void* k;  // the pool or cache, in C
  const void* v;
  const float* k_scale;  // int8 only: one scale per (block, kv-head)
  const float* v_scale;
  const int32_t* vl;  // (B,) frontiers
  void* out;          // (B, H, hd) in T
  float* part;        // (B, H, n_split, hd + 2): acc, m, l of each range
  int32_t* tickets;   // one per block of the grid's x axis, all 0 between launches
  int page, hkv, hd, g, gh, per, n_split, stages, rs, chunk, lpc;
  float scale;  // hd^-1/2, times log2 e where the kernel takes exp2
};

// bf16 q takes exp2 with log2 e folded into the scale (one instruction);
// float32 keeps expf, as the card-vs-CPU checks of the float32 runs expect
template <typename T>
__device__ __forceinline__ float softmax_exp(float x) {
  if constexpr (std::is_same_v<T, float>) return expf(x);
  else return exp2f(x);
}

// E elements of a staged row (C) as float32, zeros when !on.
template <typename C, int E>
__device__ __forceinline__ void load_slice(const C* p, bool on, float (&f)[E]) {
  if constexpr (std::is_same_v<C, float>) {
#pragma unroll
    for (int i = 0; i < E / 4; ++i) {
      const float4 v = on ? reinterpret_cast<const float4*>(p)[i] : make_float4(0.f, 0.f, 0.f, 0.f);
      f[4 * i] = v.x;
      f[4 * i + 1] = v.y;
      f[4 * i + 2] = v.z;
      f[4 * i + 3] = v.w;
    }
  } else if constexpr (std::is_same_v<C, __nv_bfloat16>) {
#pragma unroll
    for (int i = 0; i < E / 8; ++i) {
      const uint4 v = on ? reinterpret_cast<const uint4*>(p)[i] : make_uint4(0, 0, 0, 0);
      const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float2 x = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[j]));
        f[8 * i + 2 * j] = x.x;
        f[8 * i + 2 * j + 1] = x.y;
      }
    }
  } else {  // int8 codes
#pragma unroll
    for (int i = 0; i < E / 8; ++i) {
      const uint2 v = on ? reinterpret_cast<const uint2*>(p)[i] : make_uint2(0, 0);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const uint32_t w = j < 4 ? v.x : v.y;
        f[8 * i + j] = static_cast<float>(static_cast<int8_t>((w >> (8 * (j & 3))) & 0xffu));
      }
    }
  }
}

// `bytes` (16, 8, 4, else a plain copy of 1 or 2) from src to dst; zeros when !ok
__device__ __forceinline__ void copy_chunk(unsigned char* dst, const unsigned char* src, bool ok,
                                           int bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int n = ok ? bytes : 0;
  if (bytes == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src), "r"(n));
  } else if (bytes == 8) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(d), "l"(src), "r"(n));
  } else if (bytes == 4) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src), "r"(n));
  } else {
    for (int i = 0; i < bytes; ++i) dst[i] = ok ? src[i] : 0;
  }
}

// wait until at most n of this thread's cp.async groups are pending (n < 4)
__device__ __forceinline__ void cp_async_wait_n(int n) {
  if (n <= 0) cp_async_wait<0>();
  else if (n == 1) cp_async_wait<1>();
  else if (n == 2) cp_async_wait<2>();
  else cp_async_wait<3>();
}

template <typename T, typename C, int E, int GH, class Map>
__global__ void __launch_bounds__(128) decode_ring_kernel(const DecodeArgs a, const Map map) {
  constexpr int KS = GH >= 8 ? 1 : 8 / GH;  // column steps scored before a rescale
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int s_last;
  const int warps = blockDim.x / 32, warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int n_hc = (a.g + a.gh - 1) / a.gh;
  const int hc = blockIdx.x % n_hc, h = (blockIdx.x / n_hc) % a.hkv;
  const int b = blockIdx.x / (n_hc * a.hkv), split = blockIdx.y;
  const int head0 = h * a.g + hc * a.gh, gh = min(a.gh, a.g - hc * a.gh);
  const int H = a.hkv * a.g, P = a.page, hd = a.hd, rs = a.rs;
  const auto blocks = map.slot(b);
  const int p_begin = split * a.per;
  // this warp's pages of the range: p_begin + warp + i * warps; their blocks,
  // 32 at a time, one a lane (table entries of the range are in the table)
  const int p_nominal = min(p_begin + a.per, map.pages());
  auto fetch = [&](int i0) {
    const int p = p_begin + warp + (i0 + lane) * warps;
    return p < p_nominal ? blocks.block(p) : 0;
  };
  int blk_lane = fetch(0);

  const int len = max(0, min(a.vl[b], map.capacity()));
  const int used = (len + P - 1) / P;
  const int n_act = (used + a.per - 1) / a.per;  // ranges that hold a page
  if (split >= max(n_act, 1)) return;
  T* out = static_cast<T*>(a.out);
  if (used == 0) {  // nothing visible: zeros, as the reference's max(l, 1e-30) divide gives
    for (int i = threadIdx.x; i < gh * hd; i += blockDim.x)
      out[(static_cast<size_t>(b) * H + head0) * hd + i] = from_f<T>(0.f);
    return;
  }
  const int p_end = min(p_begin + a.per, used);
  const int n_w = p_end > p_begin + warp ? (p_end - p_begin - warp + warps - 1) / warps : 0;

  // q slices of this lane's column group, pre-scaled
  const int lpc = a.lpc, cpw = 32 / lpc, cg = lane / lpc, sl = lane % lpc;
  const bool slice_on = sl * E < rs;
  float qf[GH][E];
  const T* qb = static_cast<const T*>(a.q) + (static_cast<size_t>(b) * H + head0) * hd;
#pragma unroll
  for (int j = 0; j < GH; ++j)
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const int d = sl * E + e;
      qf[j][e] = (j < gh && d < hd) ? to_f(qb[static_cast<size_t>(j) * hd + d]) * a.scale : 0.f;
    }
  float m[GH], l[GH], acc[GH][E];
#pragma unroll
  for (int j = 0; j < GH; ++j) {
    m[j] = kNeg;
    l[j] = 0.f;
#pragma unroll
    for (int e = 0; e < E; ++e) acc[j][e] = 0.f;
  }

  // the ring: stage = K rows (P x rs codes), V rows, the page's two scales
  const int rb = rs * static_cast<int>(sizeof(C)), hb = hd * static_cast<int>(sizeof(C));
  const int stage_bytes = 2 * P * rb + 16;
  unsigned char* ring = smem + static_cast<size_t>(warp) * a.stages * stage_bytes;
  const unsigned char* kp = static_cast<const unsigned char*>(a.k);
  const unsigned char* vp = static_cast<const unsigned char*>(a.v);
  const size_t tok_bytes = static_cast<size_t>(a.hkv) * hb;
  const int chunks = rb / a.chunk;  // a staged row in copy chunks
  auto issue = [&](int i) {         // page i of this warp into stage i % stages
    if (i < n_w) {
      if (i % 32 == 0 && i > 0) blk_lane = fetch(i);
      const int p = p_begin + warp + i * warps;
      const int blk = __shfl_sync(0xffffffffu, blk_lane, i % 32);
      const int rows = min(P, len - p * P);
      const size_t base = blocks.first_row(p, blk) * tok_bytes + static_cast<size_t>(h) * hb;
      unsigned char* st = ring + (i % a.stages) * stage_bytes;
      for (int c = lane; c < P * chunks; c += 32) {
        const int t = c / chunks, off = (c - t * chunks) * a.chunk;
        const bool ok = t < rows && off < hb;
        const size_t src = ok ? base + t * tok_bytes + off : 0;
        copy_chunk(st + t * rb + off, kp + src, ok, a.chunk);
        copy_chunk(st + P * rb + t * rb + off, vp + src, ok, a.chunk);
      }
      if constexpr (std::is_same_v<C, int8_t>) {
        const size_t si = static_cast<size_t>(blk) * a.hkv + h;
        if (lane < 2)
          copy_chunk(st + 2 * P * rb + 4 * lane,
                     reinterpret_cast<const unsigned char*>(lane ? a.v_scale + si : a.k_scale + si),
                     true, 4);
      }
    }
    cp_async_commit();  // an empty group past the last page keeps the count uniform
  };

  for (int i = 0; i < a.stages; ++i) issue(i);
  for (int i = 0; i < n_w; ++i) {
    cp_async_wait_n(a.stages - 1);  // page i has landed (this lane's copies)
    __syncwarp();                   // ... and every lane's
    const int p = p_begin + warp + i * warps;
    const unsigned char* st = ring + (i % a.stages) * stage_bytes;
    const C* ks = reinterpret_cast<const C*>(st);
    const C* vs = reinterpret_cast<const C*>(st + P * rb);
    float sk = 1.f, sv = 1.f;
    if constexpr (std::is_same_v<C, int8_t>) {
      sk = reinterpret_cast<const float*>(st + 2 * P * rb)[0];
      sv = reinterpret_cast<const float*>(st + 2 * P * rb)[1];
    }
    const int t_end = min(P, len - p * P);
    for (int c0 = 0; c0 < t_end; c0 += KS * cpw) {
      float sc[KS][GH];
#pragma unroll
      for (int s = 0; s < KS; ++s) {
        const int t = c0 + s * cpw + cg;
        float kf[E];
        load_slice<C, E>(ks + t * rs + sl * E, t < P && slice_on, kf);
#pragma unroll
        for (int j = 0; j < GH; ++j) {
          float dot = 0.f;
#pragma unroll
          for (int e = 0; e < E; ++e) dot = fmaf(qf[j][e], kf[e], dot);
          sc[s][j] = dot;
        }
      }
      for (int off = 1; off < lpc; off <<= 1)
#pragma unroll
        for (int s = 0; s < KS; ++s)
#pragma unroll
          for (int j = 0; j < GH; ++j) sc[s][j] += __shfl_xor_sync(0xffffffffu, sc[s][j], off);
#pragma unroll
      for (int j = 0; j < GH; ++j) {
        float mx = m[j];
#pragma unroll
        for (int s = 0; s < KS; ++s) {
          const bool ok = c0 + s * cpw + cg < t_end;
          sc[s][j] = ok ? sc[s][j] * sk : kNeg;
          mx = fmaxf(mx, sc[s][j]);
        }
        const float alpha = softmax_exp<T>(m[j] - mx);
        m[j] = mx;
        l[j] *= alpha;
#pragma unroll
        for (int e = 0; e < E; ++e) acc[j][e] *= alpha;
      }
#pragma unroll
      for (int s = 0; s < KS; ++s) {
        const int t = c0 + s * cpw + cg;
        const bool ok = t < t_end;
        float vf[E];
        load_slice<C, E>(vs + t * rs + sl * E, t < P && slice_on, vf);
#pragma unroll
        for (int j = 0; j < GH; ++j) {
          const float pr = ok ? softmax_exp<T>(sc[s][j] - m[j]) : 0.f;
          l[j] += pr;
          const float pv = pr * sv;
#pragma unroll
          for (int e = 0; e < E; ++e) acc[j][e] = fmaf(pv, vf[e], acc[j][e]);
        }
      }
    }
    __syncwarp();  // every lane is done with the stage before it is refilled
    issue(i + a.stages);
  }

  // column groups -> one state a warp (lanes cg == 0 hold it)
  for (int off = lpc; off < 32; off <<= 1) {
#pragma unroll
    for (int j = 0; j < GH; ++j) {
      const float mo = __shfl_xor_sync(0xffffffffu, m[j], off);
      const float lo = __shfl_xor_sync(0xffffffffu, l[j], off);
      const float mx = fmaxf(m[j], mo), a1 = softmax_exp<T>(m[j] - mx);
      const float a2 = softmax_exp<T>(mo - mx);
      l[j] = l[j] * a1 + lo * a2;
#pragma unroll
      for (int e = 0; e < E; ++e) {
        const float ao = __shfl_xor_sync(0xffffffffu, acc[j][e], off);
        acc[j][e] = acc[j][e] * a1 + ao * a2;
      }
      m[j] = mx;
    }
  }
  // warps -> the block's state, in shared memory over the ring (every copy done)
  cp_async_wait<0>();
  __syncthreads();
  float* ws_acc = reinterpret_cast<float*>(smem);  // (warps, GH, rs)
  float* ws_m = ws_acc + warps * GH * rs;          // (warps, GH)
  float* ws_l = ws_m + warps * GH;
  if (cg == 0) {
#pragma unroll
    for (int j = 0; j < GH; ++j) {
      if (slice_on)
#pragma unroll
        for (int e = 0; e < E; ++e) ws_acc[(warp * GH + j) * rs + sl * E + e] = acc[j][e];
      if (sl == 0) {
        ws_m[warp * GH + j] = m[j];
        ws_l[warp * GH + j] = l[j];
      }
    }
  }
  __syncthreads();
  const int row = hd + 2;
  for (int i = threadIdx.x; i < gh * hd; i += blockDim.x) {
    const int j = i / hd, d = i - j * hd;
    float mx = kNeg;
    for (int w = 0; w < warps; ++w) mx = fmaxf(mx, ws_m[w * GH + j]);
    float ls = 0.f, as = 0.f;
    for (int w = 0; w < warps; ++w) {
      const float f = softmax_exp<T>(ws_m[w * GH + j] - mx);
      ls += ws_l[w * GH + j] * f;
      as += ws_acc[(w * GH + j) * rs + d] * f;
    }
    const size_t bh = static_cast<size_t>(b) * H + head0 + j;
    if (n_act == 1) {
      out[bh * hd + d] = from_f<T>(as / fmaxf(ls, 1e-30f));
    } else {
      float* dst = a.part + (bh * a.n_split + split) * row;
      dst[d] = as;
      if (d == 0) {
        dst[hd] = mx;
        dst[hd + 1] = ls;
      }
    }
  }
  if (n_act == 1) return;
  __threadfence();  // this block's partials are visible before its ticket
  __syncthreads();
  if (threadIdx.x == 0) s_last = atomicAdd(a.tickets + blockIdx.x, 1) == n_act - 1;
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  for (int i = threadIdx.x; i < gh * hd; i += blockDim.x) {
    const int j = i / hd, d = i - j * hd;
    const size_t bh = static_cast<size_t>(b) * H + head0 + j;
    const float* src = a.part + bh * a.n_split * row;
    float mx = kNeg;
    for (int r = 0; r < n_act; ++r) mx = fmaxf(mx, __ldcg(src + r * row + hd));
    float ls = 0.f, as = 0.f;
    for (int r = 0; r < n_act; ++r) {
      const float f = softmax_exp<T>(__ldcg(src + r * row + hd) - mx);
      ls += __ldcg(src + r * row + hd + 1) * f;
      as += __ldcg(src + r * row + d) * f;
    }
    out[bh * hd + d] = from_f<T>(as / fmaxf(ls, 1e-30f));
  }
  if (threadIdx.x == 0) a.tickets[blockIdx.x] = 0;  // ready for the next launch
}

// shared memory a decode block needs: its warps' rings, or the warp merge
inline int decode_smem_bytes(int warps, int stages, int page, int rs, int code_bytes, int gh) {
  const int stage = 2 * page * rs * code_bytes + 16;
  return max(warps * stages * stage, warps * gh * (rs + 2) * 4);
}

template <typename T, typename C, int E, int GH, class Map>
cudaError_t launch_decode_k(const DecodeArgs& a, const Map& map, int B, int warps, int smem,
                            cudaStream_t stream) {
  if (smem < decode_smem_bytes(warps, a.stages, a.page, a.rs, sizeof(C), GH) || smem > kSmemMax)
    return cudaErrorInvalidValue;
  auto kernel = decode_ring_kernel<T, C, E, GH, Map>;
  static int allowed = 48 * 1024;  // the shared-memory opt-in, raised as calls need it
  if (smem > allowed) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    allowed = smem;
  }
  const int pairs = B * a.hkv * ((a.g + a.gh - 1) / a.gh);
  kernel<<<dim3(pairs, a.n_split), 32 * warps, smem, stream>>>(a, map);
  return cudaGetLastError();
}

// The decode launch for any pool type: checks the plan against the shape
// and picks E (the hd slice of a lane) as decode_attention.decode_plan
// does; the plan names the heads a block serves (a.gh).
template <typename T, bool Q, class Map>
cudaError_t launch_decode(DecodeArgs a, const Map& map, int B, int n_pages, int warps, int smem,
                          cudaStream_t stream) {
  using C = code_t<T, Q>;
  if (a.g < 1 || a.g > 32 || a.page < 1 || a.hd < 1 || a.hd > 256 || a.per < 1 ||
      a.n_split < 1 || static_cast<long>(a.per) * a.n_split < n_pages ||
      static_cast<long>(a.per) * (a.n_split - 1) >= n_pages || a.stages < 1 || a.stages > 4 ||
      (warps != 1 && warps != 2 && warps != 4) || B < 1 || a.n_split > 65535)
    return cudaErrorInvalidConfiguration;
  if (Q && (a.k_scale == nullptr || a.v_scale == nullptr)) return cudaErrorInvalidValue;
  const int E = a.hd <= 128 ? 8 : 16;
  a.rs = (a.hd + 15) / 16 * 16;
  a.lpc = 1;
  while (a.lpc * E < a.rs) a.lpc *= 2;
  // the largest copy chunk (16, 8, 4 bytes) that divides a row and the pointers
  const int hb = a.hd * static_cast<int>(sizeof(C));
  const uintptr_t al = reinterpret_cast<uintptr_t>(a.k) | reinterpret_cast<uintptr_t>(a.v);
  a.chunk = 16;
  while (a.chunk > 1 && (hb % a.chunk || al % a.chunk)) a.chunk /= 2;
  a.scale = (std::is_same_v<T, float> ? 1.0f : 1.4426950408889634f) /
            sqrtf(static_cast<float>(a.hd));
  // GH, the heads a block's registers hold, is a.gh rounded up to 1, 2, 4 or 8
  if (a.gh < 1 || a.gh > (E == 8 ? 8 : 4) || a.gh > a.g) return cudaErrorInvalidConfiguration;
  if (E == 8) {
    if (a.gh == 1) return launch_decode_k<T, C, 8, 1>(a, map, B, warps, smem, stream);
    if (a.gh == 2) return launch_decode_k<T, C, 8, 2>(a, map, B, warps, smem, stream);
    if (a.gh <= 4) return launch_decode_k<T, C, 8, 4>(a, map, B, warps, smem, stream);
    return launch_decode_k<T, C, 8, 8>(a, map, B, warps, smem, stream);
  }
  if (a.gh == 1) return launch_decode_k<T, C, 16, 1>(a, map, B, warps, smem, stream);
  if (a.gh == 2) return launch_decode_k<T, C, 16, 2>(a, map, B, warps, smem, stream);
  return launch_decode_k<T, C, 16, 4>(a, map, B, warps, smem, stream);
}

}  // namespace
}  // namespace rt

// Launch LAUNCH<T, Q>(...) for the dtype code (float32 or bf16 q and out).
#define RT_DISPATCH_DECODE(LAUNCH, Q, dtype, ...)                                       \
  do {                                                                                 \
    if ((dtype) == RT_F32) return LAUNCH<float, Q>(__VA_ARGS__);                       \
    if ((dtype) == RT_BF16) return LAUNCH<__nv_bfloat16, Q>(__VA_ARGS__);              \
    return cudaErrorInvalidValue;                                                      \
  } while (0)

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
