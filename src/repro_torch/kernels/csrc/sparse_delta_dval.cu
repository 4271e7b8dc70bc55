// Gradient of the NeuroAda bypass values, the only gradient that trains:
//   dval[b, j, o] = sum_m dy[b, m, o] * x[b, m, idx[b, j, o]]
// float32 products and sums, float32 output (B, k, d_out). B is the leading
// batch axis of an expert stack (one launch for all experts), 1 for a
// single matrix.
//
// Replaces the TPU kernel src/repro/kernels/sparse_delta.py
// sparse_delta_dval_pallas (body _dval_kernel). On the TPU the grid's
// inner M axis runs in order and accumulates into the output block. Here
// blocks run in parallel, and a grid of output columns alone would give
// only k*d_out / 128 blocks (2 for wk/wv of qwen2-1.5b) for 132 SMs. So M
// splits across blocks too: block (column tile, row range, batch) writes
// float32 partials, and a second small kernel sums the ranges in a fixed
// order. No atomics, so the result is bitwise the same from run to run;
// with B = 1 the grid, the partials and the order of the sums are those of
// the kernel without a batch axis.
//
// Bound: memory. The call reads dy (M x d_out) and the x columns that idx
// names once; its 2*M*k*d_out flops are far below the card's rate. Design:
// one thread per output column, 128 columns a block, so the dy rows a warp
// reads are contiguous; the thread keeps up to kJ of its column's indices
// in registers and walks its row range, gathering x[m, idx[j, o]] — a
// block's gathers of one row fall in that row of x, which stays in L1.
#include "common.cuh"

namespace {

constexpr int kCols = 128;
constexpr int kJ = 8;  // indices held in registers per pass over the rows

template <typename T>
__global__ void __launch_bounds__(kCols)
    dval_partial_kernel(const T* __restrict__ x, const int32_t* __restrict__ idx,
                        const T* __restrict__ dy, float* __restrict__ part, int M, int d_in,
                        int d_out, int k, int rows_per_split, int n_split) {
  const int o = blockIdx.x * kCols + threadIdx.x;
  const int split = blockIdx.y;
  if (o >= d_out) return;
  // x and dy are read as (B*M)-row stacks, idx as a (B*k)-row one: the
  // batch enters only as a row offset and the pointers stay parameters.
  // (Offsetting the pointers instead took 109 registers against 64 on
  // sm_90a, and a second wave of blocks at d_out = 8960.)
  const int b = blockIdx.z;
  const int m0 = b * M + split * rows_per_split;
  const int m1 = b * M + min(M, split * rows_per_split + rows_per_split);
  const int jb = b * k;  // the batch's first index row
  const int pb = (b * n_split + split) * k;  // its first partial row
  for (int j0 = 0; j0 < k; j0 += kJ) {
    const int nj = min(kJ, k - j0);
    int col[kJ];
    float acc[kJ];
#pragma unroll
    for (int t = 0; t < kJ; ++t) {
      // indices come from selection; clamp so a bad one never reads
      // outside the row
      col[t] = t < nj ? min(max(idx[static_cast<size_t>(jb + j0 + t) * d_out + o], 0), d_in - 1)
                      : 0;
      acc[t] = 0.f;
    }
#pragma unroll 4
    for (int m = m0; m < m1; ++m) {
      const float g = rt::to_f(dy[static_cast<size_t>(m) * d_out + o]);
      const T* xr = x + static_cast<size_t>(m) * d_in;
#pragma unroll
      for (int t = 0; t < kJ; ++t)
        if (t < nj) acc[t] = fmaf(rt::to_f(xr[col[t]]), g, acc[t]);
    }
    // partial layout: (B, n_split, k, d_out)
    for (int t = 0; t < nj; ++t)
      part[(static_cast<size_t>(pb) + j0 + t) * d_out + o] = acc[t];
  }
}

// n = k * d_out entries per batch, B * n in all
__global__ void dval_reduce_kernel(const float* __restrict__ part, float* __restrict__ dval,
                                   int n, int total, int n_split) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= total) return;
  const int b = e / n, w = e - b * n;
  const float* pb = part + static_cast<size_t>(b) * n_split * n + w;
  float s = 0.f;
  for (int r = 0; r < n_split; ++r) s += pb[static_cast<size_t>(r) * n];
  dval[e] = s;
}

template <typename T>
cudaError_t launch(const void* x, const void* idx, const void* dy, void* part, void* dval,
                   int B, int M, int d_in, int d_out, int k, int rows_per_split, int n_split,
                   cudaStream_t stream) {
  dim3 grid((d_out + kCols - 1) / kCols, n_split, B);
  dval_partial_kernel<T><<<grid, kCols, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const int32_t*>(idx), static_cast<const T*>(dy),
      static_cast<float*>(part), M, d_in, d_out, k, rows_per_split, n_split);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int n = k * d_out, total = B * n;
  dval_reduce_kernel<<<(total + 255) / 256, 256, 0, stream>>>(
      static_cast<const float*>(part), static_cast<float*>(dval), n, total, n_split);
  return cudaGetLastError();
}

}  // namespace

// x (B, M, d_in), idx (B, k, d_out), dy (B, M, d_out) -> dval (B, k, d_out).
// Split of the rows, chosen by the caller (it sizes the partials (B,
// n_split, k, d_out)): n_split blocks of rows_per_split rows each along M.
extern "C" int rt_sparse_delta_dval(const void* x, const void* idx, const void* dy, void* part,
                                    void* dval, int B, int M, int d_in, int d_out, int k,
                                    int rows_per_split, int n_split, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == RT_BF16)
    err = launch<__nv_bfloat16>(x, idx, dy, part, dval, B, M, d_in, d_out, k, rows_per_split,
                                n_split, s);
  else if (dtype == RT_F32)
    err = launch<float>(x, idx, dy, part, dval, B, M, d_in, d_out, k, rows_per_split, n_split,
                        s);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}
