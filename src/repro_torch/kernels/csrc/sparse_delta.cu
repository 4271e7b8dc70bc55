// Multi-tenant NeuroAda bypass apply:
//   y[m, o] = sum_j val[aid[m], j, o] * x[m, idx[aid[m], j, o]]
// with float32 accumulation and the output in x's dtype.
//
// Replaces the TPU kernel src/repro/kernels/sparse_delta.py
// sparse_delta_batched_pallas (body _delta_batched_kernel). That kernel
// loops over all N adapters with a per-row select, a workaround for
// Mosaic's poor per-sublane gathers; here each row reads aid[m] and
// gathers only its own adapter's k entries.
//
// Bound: memory. Each call reads x once, the touched idx/val once and
// writes y once; the k*d_out multiply-adds per row are negligible.
// Design: a block owns a tile of rows and a span of output columns. It
// stages its rows of x in shared memory with 16-byte loads (a bf16 row of
// d_in = 8960 is 17.5 KB; the tile holds as many rows as fit in 96 KB, at
// most 8), so the random gathers x[m, idx] hit shared memory, not device
// memory. The columns split over just enough blocks to fill the card
// (many row tiles in a prefill chunk: each block sweeps all columns and
// x is read once; few rows in a decode step: the columns spread out), one
// thread per column at a time, looping over the tile's rows and k.
// Neighbouring threads read neighbouring idx/val entries, and rows of one
// slot share an adapter, so those reads coalesce and stay in L1.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxRows = 8;
constexpr size_t kStageBytes = 96 * 1024;

template <typename TX, typename TV>
__global__ void sparse_delta_batched_kernel(const TX* __restrict__ x,
                                            const int32_t* __restrict__ idx,
                                            const TV* __restrict__ val,
                                            const int32_t* __restrict__ aid,
                                            TX* __restrict__ y, int M, int d_in,
                                            int d_out, int n_ad, int k, int rows_per_block,
                                            int cols_per_block) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  TX* xs = reinterpret_cast<TX*>(smem_raw);
  const int m0 = blockIdx.x * rows_per_block;
  const int rows = min(rows_per_block, M - m0);
  const TX* xrow = x + static_cast<size_t>(m0) * d_in;
  const size_t n_bytes = static_cast<size_t>(rows) * d_in * sizeof(TX);
  if ((reinterpret_cast<uintptr_t>(xrow) & 15) == 0 && (n_bytes & 15) == 0) {
    const uint4* src = reinterpret_cast<const uint4*>(xrow);
    uint4* dst = reinterpret_cast<uint4*>(smem_raw);
    for (size_t i = threadIdx.x; i < n_bytes / 16; i += blockDim.x) dst[i] = src[i];
  } else {
    for (size_t i = threadIdx.x; i < static_cast<size_t>(rows) * d_in; i += blockDim.x)
      xs[i] = xrow[i];
  }
  __syncthreads();

  const size_t ad_stride = static_cast<size_t>(k) * d_out;
  const int o0 = static_cast<int>(blockIdx.y) * cols_per_block;
  const int o_end = min(d_out, o0 + cols_per_block);
  for (int o = o0 + static_cast<int>(threadIdx.x); o < o_end; o += blockDim.x) {
    for (int r = 0; r < rows; ++r) {
      // ids come from the engine's host plan; clamp so a bad id can never
      // read outside the stacks
      const int a = min(max(aid[m0 + r], 0), n_ad - 1);
      const int32_t* ia = idx + a * ad_stride + o;
      const TV* va = val + a * ad_stride + o;
      const TX* xr = xs + static_cast<size_t>(r) * d_in;
      float acc = 0.f;
      for (int j = 0; j < k; ++j) {
        const int i = min(max(ia[static_cast<size_t>(j) * d_out], 0), d_in - 1);
        acc += rt::to_f(xr[i]) * rt::to_f(va[static_cast<size_t>(j) * d_out]);
      }
      y[static_cast<size_t>(m0 + r) * d_out + o] = rt::from_f<TX>(acc);
    }
  }
}

template <typename TX, typename TV>
cudaError_t launch(const void* x, const void* idx, const void* val, const void* aid, void* y,
                   int M, int d_in, int d_out, int n_ad, int k, cudaStream_t stream) {
  const size_t row_bytes = static_cast<size_t>(d_in) * sizeof(TX);
  size_t fit = kStageBytes / row_bytes;
  const int rpb = static_cast<int>(fit < 1 ? 1 : (fit > kMaxRows ? kMaxRows : fit));
  const size_t smem = rpb * row_bytes;
  if (smem > 227 * 1024) return cudaErrorInvalidValue;
  auto kernel = sparse_delta_batched_kernel<TX, TV>;
  cudaError_t err = rt::allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  int device = 0, sms = 0;
  err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  // split the columns only as far as it takes to put ~2 blocks on each SM
  const int row_tiles = (M + rpb - 1) / rpb;
  const int max_splits = (d_out + kThreads - 1) / kThreads;
  int splits = (2 * sms + row_tiles - 1) / row_tiles;
  splits = splits < 1 ? 1 : (splits > max_splits ? max_splits : splits);
  const int cols = (d_out + splits - 1) / splits;
  dim3 grid(row_tiles, splits);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const TX*>(x), static_cast<const int32_t*>(idx), static_cast<const TV*>(val),
      static_cast<const int32_t*>(aid), static_cast<TX*>(y), M, d_in, d_out, n_ad, k, rpb,
      cols);
  return cudaGetLastError();
}

}  // namespace

extern "C" int rt_sparse_delta_batched(const void* x, const void* idx, const void* val,
                                       const void* aid, void* y, int M, int d_in, int d_out,
                                       int n_ad, int k, int x_dtype, int v_dtype,
                                       void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (x_dtype == RT_BF16 && v_dtype == RT_BF16)
    err = launch<__nv_bfloat16, __nv_bfloat16>(x, idx, val, aid, y, M, d_in, d_out, n_ad, k, s);
  else if (x_dtype == RT_BF16 && v_dtype == RT_F32)
    err = launch<__nv_bfloat16, float>(x, idx, val, aid, y, M, d_in, d_out, n_ad, k, s);
  else if (x_dtype == RT_F32 && v_dtype == RT_BF16)
    err = launch<float, __nv_bfloat16>(x, idx, val, aid, y, M, d_in, d_out, n_ad, k, s);
  else if (x_dtype == RT_F32 && v_dtype == RT_F32)
    err = launch<float, float>(x, idx, val, aid, y, M, d_in, d_out, n_ad, k, s);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}
