// Dense decode attention: one query token per slot against a dense slot
// cache (B, Smax, Hkv, hd), with a per-slot frontier kv_valid_len and a
// float32 online softmax. The cache holds q's element type
// (rt_decode_attention) or int8 codes with one float32 scale per (slot,
// 16-row group, kv-head) per cache (rt_decode_attention_q).
//
// Replaces the TPU kernel src/repro/kernels/decode_attention.py
// decode_attention_pallas, both of its bodies: _decode_attn_kernel (fp
// cache) and _decode_attn_q_kernel (int8 cache, each KV tile dequantized
// against its groups' scales). The Pallas wrapper pads Smax up to its KV
// block and masks the pad; here nothing is padded: only rows below the
// slot's frontier (<= Smax) are ever copied, so an Smax that is not a
// multiple of the tile never reads past the tensor.
//
// Bound: memory — the K and V bytes up to each slot's frontier (one byte a
// code plus the scales for int8), read once per (slot, kv-head). Design:
// the paged decode's kernel (rt::launch_decode: warps with their own
// cp.async rings of row tiles, ranges merged in the last block) with the
// block resolved by arithmetic instead of a table — row tile t of slot b
// is block b * ceil(Smax / tile) + t (rt::DenseMap). For int8 the tile is
// the scale group, so the cache is a (B * Smax / 16, 16, Hkv, hd) pool with
// (B * Smax / 16, Hkv) scales, exactly the paged int8 layout.
#include "paged_attention.cuh"

namespace {

template <typename T, bool Q>
cudaError_t launch(rt::DecodeArgs a, int B, int smax, int warps, int smem,
                   cudaStream_t stream) {
  const int tile = a.page;
  if (tile < 1 || smax < 1 || (Q && smax % tile)) return cudaErrorInvalidValue;
  const int tiles = (smax + tile - 1) / tile;
  const rt::DenseMap map{smax, tile, tiles};
  return rt::launch_decode<T, Q>(a, map, B, tiles, warps, smem, stream);
}

template <bool Q>
int dispatch(const void* q, const void* k, const void* v, const void* k_scale,
             const void* v_scale, const void* vl, void* out, void* part, void* tickets, int B,
             int smax, int tile, int hkv, int hd, int g, int heads, int per, int n_split,
             int stages, int warps, int smem, int dtype, void* stream) {
  rt::DecodeArgs a{q, k, v, static_cast<const float*>(k_scale),
                   static_cast<const float*>(v_scale), static_cast<const int32_t*>(vl), out,
                   static_cast<float*>(part), static_cast<int32_t*>(tickets), tile, hkv, hd, g,
                   heads, per, n_split, stages, 0, 0, 0, 0.f};
  auto run = [&]() -> cudaError_t {
    RT_DISPATCH_DECODE(launch, Q, dtype, a, B, smax, warps, smem,
                       static_cast<cudaStream_t>(stream));
  };
  return static_cast<int>(run());
}

}  // namespace

extern "C" int rt_decode_attention(const void* q, const void* k, const void* v,
                                   const void* kv_valid_len, void* out, void* part,
                                   void* tickets, int B, int smax, int tile, int hkv, int hd,
                                   int g, int heads, int per, int n_split, int stages, int warps,
                                   int smem, int dtype, void* stream) {
  return dispatch<false>(q, k, v, nullptr, nullptr, kv_valid_len, out, part, tickets, B, smax,
                         tile, hkv, hd, g, heads, per, n_split, stages, warps, smem, dtype,
                         stream);
}

extern "C" int rt_decode_attention_q(const void* q, const void* k, const void* v,
                                     const void* k_scale, const void* v_scale,
                                     const void* kv_valid_len, void* out, void* part,
                                     void* tickets, int B, int smax, int tile, int hkv, int hd,
                                     int g, int heads, int per, int n_split, int stages,
                                     int warps, int smem, int dtype, void* stream) {
  return dispatch<true>(q, k, v, k_scale, v_scale, kv_valid_len, out, part, tickets, B, smax,
                        tile, hkv, hd, g, heads, per, n_split, stages, warps, smem, dtype,
                        stream);
}
