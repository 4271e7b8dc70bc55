// NeuroAda phase 1 (Alg. 1): per output column of each matrix of a stack,
// the k input rows of largest |w|,
//   idx[b, j, o] = the row of the j-th largest |w[b, :, o]|,
// in descending |w| with ties to the lower row: the order of a stable
// descending sort, and of lax.top_k in the reference. The smallest-first
// mode (the reference's "reverse" strategy, lax.top_k(-|w|)) takes the k
// rows of smallest |w|, ascending, ties again to the lower row: the order of
// a stable ascending sort.
//
// Replaces the TPU kernel src/repro/kernels/topk_select.py
// topk_select_pallas (body _topk_kernel). That kernel streams (1024, 128)
// tiles down d_in; per tile it takes k candidates by max-and-mask, and a
// candidate replaces the running minimum only when strictly larger, so
// ties keep the lower row. It needs d_in % min(1024, d_in) == 0 (no
// full-width qwen2-1.5b matrix tiles), takes one matrix a call and leaves
// the order within a column unspecified. Here one launch covers a whole
// (B, d_in, d_out) stack, w is read in its own dtype (|.| taken in the
// kernel: no float32 copy of the stack), any d_in, d_out and 1 <= k <= d_in,
// and the output is sorted.
//
// The order: each element becomes one 64-bit key, (float32 bits of |w|)
// << 32 | ~row. |w| >= 0, so its bits order as the values do; among equal
// values the lower row has the larger key. Keys are distinct, a column's
// top-k are its k largest keys, and sorting them descending is the
// stable sort's order. (The strictly-greater rule of the Pallas kernel is
// the same tie rule.) Smallest-first flips the value half of the key,
// (bits(|w|) ^ 0x7fffffff) << 32 | ~row: fabsf clears the sign bit, so the
// bits lie in [0, 0x7fffffff] and the xor reverses their order inside that
// range, while the row half keeps ties to the lower row. The xor (not a
// full ~bits) keeps the top bit of every key clear, so the pass limit's
// start, ~0ull, stays above every real key (|w| = 0 at row 0 would
// otherwise make the key ~0ull itself and never pass "key < limit"); and
// the row half, ~row with row < 2^31, keeps every key above the lists'
// start, 0ull, in both modes. Lanes past d_out never enter a list (the
// live[] guards), whatever their zero-filled value would key to.
//
// Bound: memory. Selection reads each weight once (qwen2-1.5b's seven
// stacks: 2.62 GB of bf16, 0.78 ms at 3.35 TB/s). Design, a simple first
// version: a block owns 32 lanes x V adjacent columns of one matrix (V = 2
// for bf16: a warp reads 128 contiguous bytes of a row) and splits d_in
// over its 8 warps, row r to warp r % 8, four rows in flight a warp. Each
// lane keeps, per column, the KT largest keys it has seen in registers
// (KT = 1, 2, 4 or 8: a compare-exchange chain, no branches); the 8
// warps' lists then merge per column in shared memory and the column's
// thread writes them out. k above 8 runs ceil(k / 8) such passes, each
// taking the 8 largest keys below the last one written (the column stays
// in L2 between passes at the stacks' sizes): slower, never a sort.
#include "common.cuh"

namespace {

using rt::to_f;
constexpr int kWarps = 8;  // row splits a block

// flip: 0 for largest-first, 0x7fffffff for smallest-first (see above)
__device__ __forceinline__ unsigned long long make_key(float a, int row, unsigned flip) {
  return (static_cast<unsigned long long>(__float_as_uint(a) ^ flip) << 32) |
         static_cast<unsigned>(~row);
}

// keep ``top`` sorted descending: the key sinks to its place, the smallest drops out
template <int KT>
__device__ __forceinline__ void insert(unsigned long long (&top)[KT], unsigned long long key) {
#pragma unroll
  for (int i = 0; i < KT; ++i) {
    const unsigned long long hi = key > top[i] ? key : top[i];
    key = key > top[i] ? top[i] : key;
    top[i] = hi;
  }
}

template <typename T, int KT>
__global__ void __launch_bounds__(kWarps * 32)
    topk_kernel(const T* __restrict__ w, int32_t* __restrict__ idx, int d_in, int d_out, int k,
                unsigned flip) {
  constexpr int V = sizeof(T) == 2 ? 2 : 1;  // adjacent columns a lane
  constexpr int CB = 32 * V;                 // columns a block
  __shared__ unsigned long long lists[kWarps][KT][CB];
  __shared__ unsigned long long limit[CB];  // keys below this are still to select
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int c0 = blockIdx.x * CB;
  const T* wb = w + static_cast<size_t>(blockIdx.y) * d_in * d_out;
  int32_t* ib = idx + static_cast<size_t>(blockIdx.y) * k * d_out;
  bool live[V];
#pragma unroll
  for (int u = 0; u < V; ++u) live[u] = c0 + lane * V + u < d_out;
  if (threadIdx.x < CB) limit[threadIdx.x] = ~0ull;

  for (int done = 0; done < k; done += KT) {
    __syncthreads();  // limits written; the previous pass's lists merged
    unsigned long long top[V][KT], lim[V];
#pragma unroll
    for (int u = 0; u < V; ++u) {
      lim[u] = limit[lane * V + u];
#pragma unroll
      for (int i = 0; i < KT; ++i) top[u][i] = 0ull;  // below every real key
    }
    int r = warp;
    for (; r + 3 * kWarps < d_in; r += 4 * kWarps) {
      float a[4][V];
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        const T* row = wb + static_cast<size_t>(r + s * kWarps) * d_out + c0 + lane * V;
#pragma unroll
        for (int u = 0; u < V; ++u) a[s][u] = live[u] ? fabsf(to_f(row[u])) : 0.f;
      }
#pragma unroll
      for (int s = 0; s < 4; ++s) {
#pragma unroll
        for (int u = 0; u < V; ++u) {
          const unsigned long long key = make_key(a[s][u], r + s * kWarps, flip);
          if (live[u] && key < lim[u]) insert<KT>(top[u], key);
        }
      }
    }
    for (; r < d_in; r += kWarps) {
      const T* row = wb + static_cast<size_t>(r) * d_out + c0 + lane * V;
#pragma unroll
      for (int u = 0; u < V; ++u) {
        if (!live[u]) continue;
        const unsigned long long key = make_key(fabsf(to_f(row[u])), r, flip);
        if (key < lim[u]) insert<KT>(top[u], key);
      }
    }
#pragma unroll
    for (int u = 0; u < V; ++u)
#pragma unroll
      for (int i = 0; i < KT; ++i) lists[warp][i][lane * V + u] = top[u][i];
    __syncthreads();
    if (threadIdx.x < CB) {  // merge the 8 sorted lists of column c
      const int c = threadIdx.x, col = c0 + c;
      int head[kWarps] = {};
      unsigned long long last = 0ull;
      const int n = min(KT, k - done);
      for (int j = 0; j < n; ++j) {
        int best = 0;
        unsigned long long bk = 0ull;
        for (int s = 0; s < kWarps; ++s) {
          const unsigned long long cand = head[s] < KT ? lists[s][head[s]][c] : 0ull;
          if (cand > bk) {
            bk = cand;
            best = s;
          }
        }
        ++head[best];
        last = bk;
        if (col < d_out)
          ib[static_cast<size_t>(done + j) * d_out + col] =
              static_cast<int32_t>(~static_cast<unsigned>(bk));
      }
      limit[c] = last;
    }
  }
}

template <typename T>
cudaError_t launch(const void* w, int32_t* idx, int batch, int d_in, int d_out, int k,
                   unsigned flip, cudaStream_t stream) {
  constexpr int CB = 32 * (sizeof(T) == 2 ? 2 : 1);
  dim3 grid((d_out + CB - 1) / CB, batch);
  const T* wt = static_cast<const T*>(w);
  if (k == 1)
    topk_kernel<T, 1><<<grid, kWarps * 32, 0, stream>>>(wt, idx, d_in, d_out, k, flip);
  else if (k == 2)
    topk_kernel<T, 2><<<grid, kWarps * 32, 0, stream>>>(wt, idx, d_in, d_out, k, flip);
  else if (k <= 4)
    topk_kernel<T, 4><<<grid, kWarps * 32, 0, stream>>>(wt, idx, d_in, d_out, k, flip);
  else
    topk_kernel<T, 8><<<grid, kWarps * 32, 0, stream>>>(wt, idx, d_in, d_out, k, flip);
  return cudaGetLastError();
}

}  // namespace

// w (batch, d_in, d_out) contiguous, float32 or bf16 -> idx (batch, k, d_out)
// int32, 1 <= k <= d_in, batch <= 65535; smallest != 0 selects the k
// smallest |w| (ascending) instead of the k largest (descending).
extern "C" int rt_topk_select(const void* w, void* idx, int batch, int d_in, int d_out, int k,
                              int dtype, int smallest, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int32_t* out = static_cast<int32_t*>(idx);
  const unsigned flip = smallest ? 0x7fffffffu : 0u;
  cudaError_t err;
  if (dtype == RT_BF16)
    err = launch<__nv_bfloat16>(w, out, batch, d_in, d_out, k, flip, s);
  else if (dtype == RT_F32)
    err = launch<float>(w, out, batch, d_in, d_out, k, flip, s);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}
