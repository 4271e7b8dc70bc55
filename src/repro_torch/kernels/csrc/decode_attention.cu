// Paged decode attention: one query token per slot against a block pool
// (N, P, Hkv, hd) through a (B, n_pages) block table, with a per-slot
// frontier kv_valid_len and a float32 online softmax. The pools hold q's
// element type (rt_paged_decode_attention) or int8 codes with one float32
// scale per (block, kv-head) per pool (rt_paged_decode_attention_q).
//
// Replaces the TPU kernel src/repro/kernels/decode_attention.py
// paged_decode_attention_pallas, both of its bodies: _paged_decode_attn_kernel
// (fp pools) and _paged_decode_attn_q_kernel (int8 pools, the page tile
// dequantized against the scale of the block the table names). The Pallas
// grid sweeps all n_pages pages of every slot and masks the ones past the
// frontier; here a block stops at ceil(kv_valid_len / P), which gives the
// same result, reads less and never touches a sentinel page.
//
// Bound: memory — the K and V bytes up to each slot's frontier (one byte a
// code plus the scales for int8), read once per (slot, kv-head); the 4*hd
// flops per column per query head are far below the card's rate. Design:
// the split-range sweep of rt::launch_decode (paged_attention.cuh) with the
// block table as its block policy; an int8 tile is staged as code * scale,
// so everything after staging is the fp kernel's.
#include "paged_attention.cuh"

namespace {

template <typename T, bool Q, int E>
cudaError_t launch(const void* q, const void* k_pool, const void* v_pool, const void* k_scale,
                   const void* v_scale, const void* table, const void* vl, void* out, void* part,
                   int B, int n_blocks, int page, int hkv, int hd, int g, int n_pages,
                   int pages_per_split, int n_split, cudaStream_t stream) {
  const rt::TableMap map{static_cast<const int32_t*>(table), n_pages, n_blocks, page};
  return rt::launch_decode<T, rt::code_t<T, Q>, E>(q, k_pool, v_pool, k_scale, v_scale, map,
                                                   vl, out, part, B, page, hkv, hd, g, n_pages,
                                                   pages_per_split, n_split, stream);
}

template <bool Q>
cudaError_t dispatch(const void* q, const void* k_pool, const void* v_pool, const void* k_scale,
                     const void* v_scale, const void* table, const void* vl, void* out,
                     void* part, int B, int n_blocks, int page, int hkv, int hd, int g,
                     int n_pages, int pages_per_split, int n_split, int dtype,
                     cudaStream_t stream) {
  RT_DISPATCH_ATTENTION(launch, Q, dtype, hd, q, k_pool, v_pool, k_scale, v_scale, table, vl,
                        out, part, B, n_blocks, page, hkv, hd, g, n_pages, pages_per_split,
                        n_split, stream);
}

}  // namespace

extern "C" int rt_paged_decode_attention(const void* q, const void* k_pool,
                                         const void* v_pool, const void* table,
                                         const void* kv_valid_len, void* out, void* part,
                                         int B, int n_blocks, int page, int hkv, int hd, int g,
                                         int n_pages, int pages_per_split, int n_split,
                                         int dtype, void* stream) {
  return static_cast<int>(dispatch<false>(q, k_pool, v_pool, nullptr, nullptr, table,
                                          kv_valid_len, out, part, B, n_blocks, page, hkv, hd,
                                          g, n_pages, pages_per_split, n_split, dtype,
                                          static_cast<cudaStream_t>(stream)));
}

extern "C" int rt_paged_decode_attention_q(const void* q, const void* k_pool,
                                           const void* v_pool, const void* k_scale,
                                           const void* v_scale, const void* table,
                                           const void* kv_valid_len, void* out, void* part,
                                           int B, int n_blocks, int page, int hkv, int hd,
                                           int g, int n_pages, int pages_per_split,
                                           int n_split, int dtype, void* stream) {
  return static_cast<int>(dispatch<true>(q, k_pool, v_pool, k_scale, v_scale, table,
                                         kv_valid_len, out, part, B, n_blocks, page, hkv, hd,
                                         g, n_pages, pages_per_split, n_split, dtype,
                                         static_cast<cudaStream_t>(stream)));
}
