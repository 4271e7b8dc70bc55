// Paged chunked-prefill attention: a chunk of C queries per slot against a
// block pool (N, P, Hkv, hd) through a (B, n_pages) block table. Query i of
// slot b sits at logical position q_offset[b] + i and sees column c iff
//   c <= q_offset[b] + i  and  c < kv_valid_len[b]
// (intra-chunk causality and the slot's post-write frontier). Rows with no
// visible column (idle slots) return zeros. The pools hold q's element type
// (rt_paged_prefill_attention) or int8 codes with one float32 scale per
// (block, kv-head) per pool (rt_paged_prefill_attention_q).
//
// Replaces the TPU kernel src/repro/kernels/prefill_attention.py
// paged_prefill_attention_pallas, both of its bodies:
// _paged_prefill_attn_kernel (fp pools) and _paged_prefill_attn_q_kernel
// (int8 pools, each page dequantized against its block's scale). That
// kernel holds all C*G rows of a (slot, kv-head) in one VMEM tile (1536
// rows at C = 256, G = 6), far more than one Hopper block's registers, and
// sweeps every page of the table. Here the rows split across blocks —
// grid (slot, kv-head, row tile), one warp per row — and each block sweeps
// the pages only up to its own rows' causal frontier; an int8 page is
// staged as code * scale (rt::sweep_pages), the rest is the fp kernel.
//
// Bound: at the serving shapes, memory on paper (the K/V bytes up to each
// slot's frontier, plus q and the output); the warp-per-row design re-reads
// each staged page once per row tile, from L2, and does its dot products
// on the CUDA cores, so this first version runs well above that bound.
#include "paged_attention.cuh"

namespace {

constexpr int kWarps = 8;  // query rows per block

template <typename T, typename C, int E>
__global__ void paged_prefill_kernel(const T* __restrict__ q, const C* __restrict__ k_pool,
                                     const C* __restrict__ v_pool,
                                     const float* __restrict__ k_scale,
                                     const float* __restrict__ v_scale,
                                     const int32_t* __restrict__ table,
                                     const int32_t* __restrict__ q_offset,
                                     const int32_t* __restrict__ kv_valid_len,
                                     T* __restrict__ out, int n_blocks, int page, int hkv,
                                     int hd, int g, int c, int n_pages, float scale) {
  extern __shared__ float smem[];
  const int b = blockIdx.x;
  const int h = blockIdx.y;
  const int warps = blockDim.x / 32;
  const int rows = c * g;  // rows fold (query i, group member gi): r = i * g + gi
  const int r0 = blockIdx.z * warps;
  const int r = r0 + threadIdx.x / 32;
  const bool active = r < rows;
  const int cap = max(0, min(kv_valid_len[b], n_pages * page));
  const int q0 = q_offset[b];
  // frontiers grow with the row index, so the block's last row bounds them all
  const int r_last = min(r0 + warps, rows) - 1;
  const int block_end = max(0, min(q0 + r_last / g + 1, cap));
  const int used = (block_end + page - 1) / page;
  const int i = r / g;
  const int row_end = active ? max(0, min(q0 + i + 1, cap)) : 0;
  const int head = h * g + (r - i * g);
  const size_t off = active ? ((static_cast<size_t>(b) * c + i) * hkv * g + head) * hd : 0;
  float qr[E];
  rt::load_row<T, E>(q + off, hd, active, qr);
  rt::SoftmaxState<E> st;
  const rt::TableBlocks blocks{table + static_cast<size_t>(b) * n_pages, n_blocks, page};
  rt::sweep_pages(qr, k_pool, v_pool, k_scale, v_scale, blocks, page, hkv, hd, h, 0, used,
                  block_end, row_end, active, scale, smem, smem + page * hd, st);
  if (active) rt::store_row<T, E>(st, hd, out + off);
}

template <typename T, bool Q, int E>
cudaError_t launch(const void* q, const void* k_pool, const void* v_pool, const void* k_scale,
                   const void* v_scale, const void* table, const void* qoff, const void* vl,
                   void* out, int B, int C, int n_blocks, int page, int hkv, int hd, int g,
                   int n_pages, cudaStream_t stream) {
  using Code = rt::code_t<T, Q>;
  if (Q && (k_scale == nullptr || v_scale == nullptr)) return cudaErrorInvalidValue;
  const size_t smem = 2 * static_cast<size_t>(page) * hd * sizeof(float);
  auto kernel = paged_prefill_kernel<T, Code, E>;
  cudaError_t err = rt::allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const int rows = C * g;
  dim3 grid(B, hkv, (rows + kWarps - 1) / kWarps);
  kernel<<<grid, 32 * kWarps, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const Code*>(k_pool),
      static_cast<const Code*>(v_pool), static_cast<const float*>(k_scale),
      static_cast<const float*>(v_scale), static_cast<const int32_t*>(table),
      static_cast<const int32_t*>(qoff), static_cast<const int32_t*>(vl), static_cast<T*>(out),
      n_blocks, page, hkv, hd, g, C, n_pages, 1.0f / sqrtf(static_cast<float>(hd)));
  return cudaGetLastError();
}

template <bool Q>
cudaError_t dispatch(const void* q, const void* k_pool, const void* v_pool, const void* k_scale,
                     const void* v_scale, const void* table, const void* qoff, const void* vl,
                     void* out, int B, int C, int n_blocks, int page, int hkv, int hd, int g,
                     int n_pages, int dtype, cudaStream_t stream) {
  RT_DISPATCH_ATTENTION(launch, Q, dtype, hd, q, k_pool, v_pool, k_scale, v_scale, table, qoff,
                        vl, out, B, C, n_blocks, page, hkv, hd, g, n_pages, stream);
}

}  // namespace

extern "C" int rt_paged_prefill_attention(const void* q, const void* k_pool,
                                          const void* v_pool, const void* table,
                                          const void* q_offset, const void* kv_valid_len,
                                          void* out, int B, int C, int n_blocks, int page,
                                          int hkv, int hd, int g, int n_pages, int dtype,
                                          void* stream) {
  return static_cast<int>(dispatch<false>(q, k_pool, v_pool, nullptr, nullptr, table,
                                          q_offset, kv_valid_len, out, B, C, n_blocks, page,
                                          hkv, hd, g, n_pages, dtype,
                                          static_cast<cudaStream_t>(stream)));
}

extern "C" int rt_paged_prefill_attention_q(const void* q, const void* k_pool,
                                            const void* v_pool, const void* k_scale,
                                            const void* v_scale, const void* table,
                                            const void* q_offset, const void* kv_valid_len,
                                            void* out, int B, int C, int n_blocks, int page,
                                            int hkv, int hd, int g, int n_pages, int dtype,
                                            void* stream) {
  return static_cast<int>(dispatch<true>(q, k_pool, v_pool, k_scale, v_scale, table, q_offset,
                                         kv_valid_len, out, B, C, n_blocks, page, hkv, hd, g,
                                         n_pages, dtype, static_cast<cudaStream_t>(stream)));
}
