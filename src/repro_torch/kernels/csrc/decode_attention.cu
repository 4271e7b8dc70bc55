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
// flops per column per query head are far below the card's rate, so what
// sets the time is the bytes in flight. Design (rt::launch_decode in
// paged_attention.cuh, with the block table as its block policy): blocks
// of 4 warps whatever the GQA group, each warp its own pages of the block's
// range, copied by cp.async 16 bytes a lane into a ring of up to 4 page
// stages in the pool's own type; lanes split as (column, hd slice), so a
// score is 4 shuffles at hd 128 and each staged row serves all the block's
// heads; the ranges merge in index order in the block that finishes last.
// An int8 page's scales multiply the scores and p, never each code.
#include "paged_attention.cuh"

namespace {

template <typename T, bool Q>
cudaError_t launch(rt::DecodeArgs a, const void* table, int B, int n_blocks, int n_pages,
                   int warps, int smem, cudaStream_t stream) {
  const rt::TableMap map{static_cast<const int32_t*>(table), n_pages, n_blocks, a.page};
  return rt::launch_decode<T, Q>(a, map, B, n_pages, warps, smem, stream);
}

template <bool Q>
int dispatch(const void* q, const void* k_pool, const void* v_pool, const void* k_scale,
             const void* v_scale, const void* table, const void* vl, void* out, void* part,
             void* tickets, int B, int n_blocks, int page, int hkv, int hd, int g, int heads,
             int n_pages, int per, int n_split, int stages, int warps, int smem, int dtype,
             void* stream) {
  rt::DecodeArgs a{q, k_pool, v_pool, static_cast<const float*>(k_scale),
                   static_cast<const float*>(v_scale), static_cast<const int32_t*>(vl), out,
                   static_cast<float*>(part), static_cast<int32_t*>(tickets), page, hkv, hd, g,
                   heads, per, n_split, stages, 0, 0, 0, 0.f};
  if (n_blocks < 1) return static_cast<int>(cudaErrorInvalidValue);
  auto run = [&]() -> cudaError_t {
    RT_DISPATCH_DECODE(launch, Q, dtype, a, table, B, n_blocks, n_pages, warps, smem,
                       static_cast<cudaStream_t>(stream));
  };
  return static_cast<int>(run());
}

}  // namespace

extern "C" int rt_paged_decode_attention(const void* q, const void* k_pool,
                                         const void* v_pool, const void* table,
                                         const void* kv_valid_len, void* out, void* part,
                                         void* tickets, int B, int n_blocks, int page, int hkv,
                                         int hd, int g, int heads, int n_pages, int per,
                                         int n_split, int stages, int warps, int smem, int dtype,
                                         void* stream) {
  return dispatch<false>(q, k_pool, v_pool, nullptr, nullptr, table, kv_valid_len, out, part,
                         tickets, B, n_blocks, page, hkv, hd, g, heads, n_pages, per, n_split,
                         stages, warps, smem, dtype, stream);
}

extern "C" int rt_paged_decode_attention_q(const void* q, const void* k_pool,
                                           const void* v_pool, const void* k_scale,
                                           const void* v_scale, const void* table,
                                           const void* kv_valid_len, void* out, void* part,
                                           void* tickets, int B, int n_blocks, int page,
                                           int hkv, int hd, int g, int heads, int n_pages,
                                           int per, int n_split, int stages, int warps, int smem,
                                           int dtype, void* stream) {
  return dispatch<true>(q, k_pool, v_pool, k_scale, v_scale, table, kv_valid_len, out, part,
                        tickets, B, n_blocks, page, hkv, hd, g, heads, n_pages, per, n_split,
                        stages, warps, smem, dtype, stream);
}
