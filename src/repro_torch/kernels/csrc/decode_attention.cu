// Paged decode attention: one query token per slot against a block pool
// (N, P, Hkv, hd) through a (B, n_pages) block table, with a per-slot
// frontier kv_valid_len and a float32 online softmax.
//
// Replaces the TPU kernel src/repro/kernels/decode_attention.py
// paged_decode_attention_pallas (body _paged_decode_attn_kernel). The
// Pallas grid sweeps all n_pages pages of every slot and masks the ones
// past the frontier; here a block stops at ceil(kv_valid_len / P), which
// gives the same result, reads less and never touches a sentinel page.
//
// Bound: memory — the K and V bytes up to each slot's frontier, read once
// per (slot, kv-head); the 4*hd flops per column per query head are far
// below the card's rate. Design: a decode step has only slots x kv-heads
// (slot, kv-head) pairs (16 for qwen2-1.5b on 8 slots), far fewer than the
// card's 132 SMs, and the longest frontier would be swept serially. So the
// table's pages split into ranges across a third grid axis (as many as it
// takes to put ~2 blocks on each SM). Each block runs one warp per query
// head of the GQA group over its page range (the group shares each staged
// page of K and V in shared memory, rt::sweep_pages) and writes the
// unnormalised partial (acc, m, l) per head to float32 scratch; a second,
// tiny kernel merges the ranges of each (slot, head) and normalises.
#include "paged_attention.cuh"

namespace {

template <typename T, int E>
__global__ void paged_decode_split_kernel(const T* __restrict__ q, const T* __restrict__ k_pool,
                                          const T* __restrict__ v_pool,
                                          const int32_t* __restrict__ table,
                                          const int32_t* __restrict__ kv_valid_len,
                                          float* __restrict__ part, int n_blocks, int page,
                                          int hkv, int hd, int g, int n_pages,
                                          int pages_per_split, float scale) {
  extern __shared__ float smem[];
  const int b = blockIdx.x;
  const int h = blockIdx.y;
  const int split = blockIdx.z;
  const int n_split = gridDim.z;
  const int head = h * g + threadIdx.x / 32;
  const int len = max(0, min(kv_valid_len[b], n_pages * page));
  const int used = (len + page - 1) / page;
  const int p_begin = split * pages_per_split;
  const int p_end = min(p_begin + pages_per_split, used);
  const size_t row = (static_cast<size_t>(b) * hkv * g + head) * hd;  // q (B, H, hd)
  float qr[E];
  rt::load_row<T, E>(q + row, hd, true, qr);
  rt::SoftmaxState<E> st;
  rt::sweep_pages<T, E>(qr, k_pool, v_pool, table + static_cast<size_t>(b) * n_pages,
                        n_blocks, page, hkv, hd, h, p_begin, p_end, len, true, scale, smem,
                        smem + page * hd, st);
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
__global__ void paged_decode_combine_kernel(const float* __restrict__ part,
                                            T* __restrict__ out, int hd, int n_split) {
  const size_t bh = static_cast<size_t>(blockIdx.x) * gridDim.y + blockIdx.y;
  const float* src = part + bh * n_split * (hd + 2);
  float m_max = rt::kNeg;
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
    out[bh * hd + d] = rt::from_f<T>(acc * inv);
  }
}

template <typename T, int E>
cudaError_t launch(const void* q, const void* k_pool, const void* v_pool, const void* table,
                   const void* vl, void* out, void* part, int B, int n_blocks, int page,
                   int hkv, int hd, int g, int n_pages, int pages_per_split, int n_split,
                   cudaStream_t stream) {
  if (g < 1 || g > 32 || pages_per_split < 1 || n_split < 1 ||
      static_cast<long>(pages_per_split) * n_split < n_pages)
    return cudaErrorInvalidConfiguration;
  const size_t smem = 2 * static_cast<size_t>(page) * hd * sizeof(float);
  auto kernel = paged_decode_split_kernel<T, E>;
  cudaError_t err = rt::allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(B, hkv, n_split), 32 * g, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_pool), static_cast<const T*>(v_pool),
      static_cast<const int32_t*>(table), static_cast<const int32_t*>(vl),
      static_cast<float*>(part), n_blocks, page, hkv, hd, g, n_pages, pages_per_split,
      1.0f / sqrtf(static_cast<float>(hd)));
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  paged_decode_combine_kernel<T><<<dim3(B, hkv * g), 128, 0, stream>>>(
      static_cast<const float*>(part), static_cast<T*>(out), hd, n_split);
  return cudaGetLastError();
}

cudaError_t dispatch(const void* q, const void* k_pool, const void* v_pool, const void* table,
                     const void* vl, void* out, void* part, int B, int n_blocks, int page,
                     int hkv, int hd, int g, int n_pages, int pages_per_split, int n_split,
                     int dtype, cudaStream_t stream) {
  RT_DISPATCH_ATTENTION(launch, dtype, hd, q, k_pool, v_pool, table, vl, out, part, B,
                        n_blocks, page, hkv, hd, g, n_pages, pages_per_split, n_split, stream);
}

}  // namespace

extern "C" int rt_paged_decode_attention(const void* q, const void* k_pool,
                                         const void* v_pool, const void* table,
                                         const void* kv_valid_len, void* out, void* part,
                                         int B, int n_blocks, int page, int hkv, int hd, int g,
                                         int n_pages, int pages_per_split, int n_split,
                                         int dtype, void* stream) {
  return static_cast<int>(dispatch(q, k_pool, v_pool, table, kv_valid_len, out, part, B,
                                   n_blocks, page, hkv, hd, g, n_pages, pages_per_split,
                                   n_split, dtype, static_cast<cudaStream_t>(stream)));
}
