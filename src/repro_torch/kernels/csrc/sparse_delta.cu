// NeuroAda bypass apply, in two forms that share one source:
//   multi-tenant:   y[m, o] = sum_j val[a, j, o] * x[m, idx[a, j, o]],  a = aid[m / R]
//   single-tenant, over a leading batch axis (experts, or B = 1 for a head):
//                   y[b, m, o] = sum_j val[b, j, o] * x[b, m, idx[b, j, o]]
// with float32 accumulation and the result in x's dtype. R, the rows one
// tenant id covers, is 1 for per-row ids and S for the per-sequence ids of
// (B, S) rows, so the engine's (B,) ids need no (M,) copy. With `accumulate`
// (the serving epilogue) the result is added into the base product y in
// place, then the bias:
//   y = round(round(y + round(delta)) + bias)
// the order and the roundings of PyTorch's `y + delta` then `+ bias`, so
// one launch gives the bits of the three it replaces.
//
// Replaces two TPU kernels of src/repro/kernels/sparse_delta.py:
// sparse_delta_batched_pallas (body _delta_batched_kernel), which loops over
// all N adapters with a per-row select, a workaround for Mosaic's poor
// per-sublane gathers; and sparse_delta_pallas (body _delta_kernel), the
// single-tenant apply, which the reference vmaps over (groups, experts) for
// the MoE expert stacks (models/moe.py _expert_linear_g), one grid axis
// more per vmap. Here a row finds its adapter by a policy (IdsFromArray
// reads aid[m / R]; IdsFromRow takes m / M, the row's batch index) and
// gathers only that adapter's k entries, so a whole (E, M, d_in) expert
// stack is one launch over E * M rows.
//
// Bound and design (Hopper). The bytes are x's named columns, the touched
// idx/val and y written once (read and written with the epilogue); the
// 2k flops an output are far below the card's rate. kernels/sparse_delta.py
// delta_plan picks one of two routes by rows:
// - rows (decode steps, M <= 64, or rows too wide to stage): a launch is a
//   latency chain, not a byte stream (8 rows of qwen2-1.5b's widest
//   projection move 0.6 MB). A thread owns one row and 8 consecutive
//   columns: it reads the row's id once, its columns' idx and val as 16-byte
//   vectors, gathers x straight from L1/L2 and stores 16 bytes. The grid
//   spreads M * d_out / 8 threads over the card, so the chain is id ->
//   idx/val -> gathers -> store, about three round trips, with no staging
//   and no loop over rows.
// - tiles (prefill chunks, mixed steps, expert stacks, the head): a grid
//   of (column span, row range) blocks, about two an SM. A block stages
//   its range of x's rows, tile by tile, by 1-D bulk copies on mbarriers
//   into two buffers, so the next tile's copy flies while this tile's
//   gathers run (a run off 16-byte alignment moves its ends by plain
//   loads: hopper.cuh stage_run). A thread owns 8 consecutive columns of
//   the span (and one of `lanes` row lanes where d_out is narrow), keeps
//   their idx/val in registers while consecutive rows share an adapter (a
//   slot's chunk rows, an expert's rows), keeps the y of its next three
//   rows in flight while it gathers this row's x from shared memory, and
//   stores 16 bytes. x is read from device memory once and from L2 once
//   per further span. What binds at k = 2 is the gathers where an output
//   row is much wider than an input row: a warp-wide gather of 32 random
//   columns meets ~3.5 bank conflicts, so qwen2-1.5b's wgate at M = 2048
//   (36.7 M gathers) needs ~17 us of shared-memory wavefronts over 132 SMs
//   against 13 us for its bytes, and a whole layer ~45 us against 40 (on
//   an H100 80GB HBM3 at 700 W it takes ~2.7x its bytes on wgate/wup,
//   PERF.md). A transposed tile with a warp's lanes on rows would gather
//   conflict-free; with the epilogue's read of y the bytes come closer.
#include "hopper.cuh"

namespace {

constexpr int kCols = 8;          // output columns a thread owns
constexpr int kRowThreads = 128;  // block of the rows route, at most
constexpr int kMaxThreads = 256;  // block of the tiles route, at most

// Where a row's adapter comes from.
struct IdsFromArray {  // the engine's tenant ids, one per R rows
  const int32_t* aid;
  int n_ad, rows_per_id;
  // ids come from the engine's host plan; clamp so a bad id can never read
  // outside the stacks
  __device__ __forceinline__ int operator()(int m) const {
    return min(max(__ldg(aid + m / rows_per_id), 0), n_ad - 1);
  }
};
struct IdsFromRow {  // a leading batch axis: rows [b*M, (b+1)*M) use adapter b
  int rows_per_adapter;
  __device__ __forceinline__ int operator()(int m) const { return m / rows_per_adapter; }
};

// ---------------------------------------------------- 8-column loads/stores
// `vec`: 16-byte vectors (d_out a multiple of 8, aligned pointers); else
// element by element, the n < 8 valid columns of a ragged edge.

__device__ __forceinline__ void unpack(float (&o)[kCols], uint4 u) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    o[2 * i] = f.x;
    o[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void load_idx(int (&o)[kCols], const int32_t* p, bool vec, int n) {
  if (vec) {
    const int4 a = __ldg(reinterpret_cast<const int4*>(p));
    const int4 b = __ldg(reinterpret_cast<const int4*>(p) + 1);
    o[0] = a.x; o[1] = a.y; o[2] = a.z; o[3] = a.w;
    o[4] = b.x; o[5] = b.y; o[6] = b.z; o[7] = b.w;
  } else {
#pragma unroll
    for (int c = 0; c < kCols; ++c) o[c] = c < n ? __ldg(p + c) : 0;
  }
}

// read-only data (x's stacks, idx/val, the bias) through the non-coherent path
template <typename T>
__device__ __forceinline__ void load_ro(float (&o)[kCols], const T* p, bool vec, int n) {
  if (vec) {
    if constexpr (sizeof(T) == 2) {
      unpack(o, __ldg(reinterpret_cast<const uint4*>(p)));
    } else {
      const float4 a = __ldg(reinterpret_cast<const float4*>(p));
      const float4 b = __ldg(reinterpret_cast<const float4*>(p) + 1);
      o[0] = a.x; o[1] = a.y; o[2] = a.z; o[3] = a.w;
      o[4] = b.x; o[5] = b.y; o[6] = b.z; o[7] = b.w;
    }
  } else {
#pragma unroll
    for (int c = 0; c < kCols; ++c) o[c] = c < n ? rt::to_f(__ldg(p + c)) : 0.f;
  }
}

// y, which this kernel also writes: plain loads
template <typename T>
__device__ __forceinline__ void load_rw(float (&o)[kCols], const T* p, bool vec, int n) {
  if (vec) {
    if constexpr (sizeof(T) == 2) {
      unpack(o, *reinterpret_cast<const uint4*>(p));
    } else {
      const float4 a = reinterpret_cast<const float4*>(p)[0];
      const float4 b = reinterpret_cast<const float4*>(p)[1];
      o[0] = a.x; o[1] = a.y; o[2] = a.z; o[3] = a.w;
      o[4] = b.x; o[5] = b.y; o[6] = b.z; o[7] = b.w;
    }
  } else {
#pragma unroll
    for (int c = 0; c < kCols; ++c) o[c] = c < n ? rt::to_f(p[c]) : 0.f;
  }
}

// v holds values already rounded to T: the conversions here are exact
template <typename T>
__device__ __forceinline__ void store(T* p, const float (&v)[kCols], bool vec, int n) {
  if (vec) {
    if constexpr (sizeof(T) == 2) {
      uint4 u;
      __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
      for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
      *reinterpret_cast<uint4*>(p) = u;
    } else {
      reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
      reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
    }
  } else {
#pragma unroll
    for (int c = 0; c < kCols; ++c)
      if (c < n) p[c] = rt::from_f<T>(v[c]);
  }
}

// KJ bypass entries of a thread's 8 columns, held in registers
template <typename TV, int KJ>
struct Entries {
  int col[KJ][kCols];
  float v[KJ][kCols];
  int nj;

  // entries j0 .. j0 + nj - 1; `off` indexes (adapter, j0, o0) in idx/val
  __device__ __forceinline__ void load(const int32_t* idx, const TV* val, size_t off, int d_out,
                                       int nj_, int d_in, bool vec, int n) {
    nj = nj_;
#pragma unroll
    for (int t = 0; t < KJ; ++t) {
      if (t < nj) {
        load_idx(col[t], idx + off + static_cast<size_t>(t) * d_out, vec, n);
        load_ro(v[t], val + off + static_cast<size_t>(t) * d_out, vec, n);
        // indices come from selection; clamp so a bad one never reads
        // outside the row
#pragma unroll
        for (int c = 0; c < kCols; ++c) col[t][c] = min(max(col[t][c], 0), d_in - 1);
      }
    }
  }

  // acc[c] += sum_t v[t][c] * x[col[t][c]], the entries in order; every
  // gather is issued before the first product uses one
  template <typename F>
  __device__ __forceinline__ void gather(float (&acc)[kCols], F x_at) const {
    float xv[KJ][kCols];
#pragma unroll
    for (int t = 0; t < KJ; ++t)
#pragma unroll
      for (int c = 0; c < kCols; ++c) xv[t][c] = t < nj ? rt::to_f(x_at(col[t][c])) : 0.f;
#pragma unroll
    for (int t = 0; t < KJ; ++t)
      if (t < nj)
#pragma unroll
        for (int c = 0; c < kCols; ++c) acc[c] = fmaf(xv[t][c], v[t][c], acc[c]);
  }
};

template <typename TX, typename TV>
struct Args {
  const TX* x;
  const int32_t* idx;
  const TV* val;
  const TX* bias;  // (d_out,) or null; read only with accumulate
  TX* y;
  int M, d_in, d_out, k;
  int accumulate;   // 1: y += delta (then + bias) in place
  int vec;          // 16-byte column vectors (the kernels' VEC)
  int tile_rows, gb, lanes, spans, stages;  // tiles route
  size_t stage;     // bytes of one staging buffer
};

// 8 values of T as loaded, packed (16 bytes of bf16, 32 of float32): the
// base product y of a row's 8 columns, loaded rows ahead of its use; plain
// loads, since this kernel writes y too
template <typename T>
struct Packed {
  uint4 u[sizeof(T) / 2];
  template <bool VEC>
  __device__ __forceinline__ void load(const T* p, int n) {
    if (VEC) {
#pragma unroll
      for (int i = 0; i < static_cast<int>(sizeof(T)) / 2; ++i)
        u[i] = reinterpret_cast<const uint4*>(p)[i];
    } else {
      T* e = reinterpret_cast<T*>(u);
#pragma unroll
      for (int c = 0; c < kCols; ++c) e[c] = c < n ? p[c] : rt::from_f<T>(0.f);
    }
  }
  __device__ __forceinline__ float operator[](int c) const {
    return rt::to_f(reinterpret_cast<const T*>(u)[c]);
  }
};

// the epilogue's operand of row m's 8 columns (nothing without the epilogue)
template <typename TX, typename TV, bool VEC>
__device__ __forceinline__ void load_base(const Args<TX, TV>& a, Packed<TX>& y, int m, int o0,
                                          int n) {
  if (a.accumulate) y.template load<VEC>(a.y + static_cast<size_t>(m) * a.d_out + o0, n);
}

// the span's bias (zeros without one)
template <typename TX, typename TV, bool VEC>
__device__ __forceinline__ void load_bias(const Args<TX, TV>& a, float (&b)[kCols], int o0,
                                          int n) {
  if (a.accumulate && a.bias != nullptr) {
    load_ro(b, a.bias + o0, VEC, n);
  } else {
#pragma unroll
    for (int c = 0; c < kCols; ++c) b[c] = 0.f;
  }
}

// the delta, rounded to x's dtype; with the epilogue, y + delta then + bias
template <typename TX, typename TV, bool VEC>
__device__ __forceinline__ void finish(const Args<TX, TV>& a, const float (&acc)[kCols],
                                       const Packed<TX>& base, const float (&bias)[kCols],
                                       int m, int o0, int n) {
  float out[kCols];
#pragma unroll
  for (int c = 0; c < kCols; ++c) out[c] = rt::to_f(rt::from_f<TX>(acc[c]));
  if (a.accumulate) {
#pragma unroll
    for (int c = 0; c < kCols; ++c) out[c] = rt::to_f(rt::from_f<TX>(base[c] + out[c]));
    if (a.bias != nullptr) {
#pragma unroll
      for (int c = 0; c < kCols; ++c) out[c] = rt::to_f(rt::from_f<TX>(out[c] + bias[c]));
    }
  }
  store(a.y + static_cast<size_t>(m) * a.d_out + o0, out, VEC, n);
}

// one thread a (row, 8 columns); M * ceil(d_out / 8) threads in all. The
// epilogue's loads go first: they do not wait for the row's id.
template <typename TX, typename TV, typename Ids, int KJ, bool VEC>
__global__ void __launch_bounds__(kRowThreads)
    delta_rows_kernel(const Args<TX, TV> a, const Ids adapter_of) {
  const int groups = (a.d_out + kCols - 1) / kCols;
  const long long item = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (item >= static_cast<long long>(a.M) * groups) return;
  const int m = static_cast<int>(item / groups);
  const int o0 = static_cast<int>(item - static_cast<long long>(m) * groups) * kCols;
  const int n = min(kCols, a.d_out - o0);
  Packed<TX> base;
  float bias[kCols];
  load_base<TX, TV, VEC>(a, base, m, o0, n);
  load_bias<TX, TV, VEC>(a, bias, o0, n);
  const int ad = adapter_of(m);
  const TX* xr = a.x + static_cast<size_t>(m) * a.d_in;
  const size_t off = static_cast<size_t>(ad) * a.k * a.d_out + o0;
  float acc[kCols] = {};
  Entries<TV, KJ> e;
  for (int j0 = 0; j0 < a.k; j0 += KJ) {
    e.load(a.idx, a.val, off + static_cast<size_t>(j0) * a.d_out, a.d_out, min(KJ, a.k - j0),
           a.d_in, VEC, n);
    e.gather(acc, [&](int i) { return __ldg(xr + i); });
  }
  finish<TX, TV, VEC>(a, acc, base, bias, m, o0, n);
}

// Grid (spans, ranges): a block owns one column span and one range of
// consecutive rows (so that they mostly share an adapter: its entries are
// loaded once), staged tile by tile through two buffers. A thread keeps
// the y of its next three rows in flight while it gathers this row's x.
template <typename TX, typename TV, typename Ids, int KJ, bool VEC>
__global__ void __launch_bounds__(kMaxThreads, 2)
    delta_tiles_kernel(const Args<TX, TV> a, const Ids adapter_of) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ __align__(8) uint64_t bar[2];
  const int per_range = (a.M + gridDim.y - 1) / gridDim.y;
  const int r_begin = blockIdx.y * per_range, r_end = min(a.M, r_begin + per_range);
  const int n_tiles = r_end > r_begin ? (r_end - r_begin + a.tile_rows - 1) / a.tile_rows : 0;
  if (threadIdx.x == 0) {
    rt::mbar_init(&bar[0], 1);
    rt::mbar_init(&bar[1], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  auto first_row = [&](int t) { return r_begin + t * a.tile_rows; };
  auto stage = [&](int t, int s) {
    const int rows = min(a.tile_rows, r_end - first_row(t));
    rt::stage_run<sizeof(TX)>(smem + s * a.stage,
                              a.x + static_cast<size_t>(first_row(t)) * a.d_in,
                              static_cast<size_t>(rows) * a.d_in * sizeof(TX), &bar[s]);
  };
  if (n_tiles > 0) stage(0, 0);
  const int lane = threadIdx.x / a.gb, grp = threadIdx.x - lane * a.gb;
  const int o0 = (blockIdx.x * a.gb + grp) * kCols;
  const bool mine = lane < a.lanes && o0 < a.d_out;  // this thread has columns
  const int n = min(kCols, a.d_out - o0);
  float bias[kCols];
  if (mine) load_bias<TX, TV, VEC>(a, bias, o0, n);
  Entries<TV, KJ> e;
  int held = -1;  // the adapter whose entries e holds (k <= KJ)
  for (int t = 0; t < n_tiles; ++t) {
    const int s = t % a.stages;
    if (a.stages == 2 && t + 1 < n_tiles) stage(t + 1, s ^ 1);  // flies while t is used
    rt::mbar_wait(&bar[s], (t / a.stages) & 1);
    __syncthreads();  // the plain stores of the run's ends are in
    const int m0 = first_row(t), rows = min(a.tile_rows, r_end - m0);
    const TX* x0 = a.x + static_cast<size_t>(m0) * a.d_in;
    const TX* xs = reinterpret_cast<const TX*>(smem + s * a.stage +
                                               (reinterpret_cast<uintptr_t>(x0) & 15));
    if (mine) {
      // the y rows of the next kAhead rows in flight
      constexpr int kAhead = 3;
      Packed<TX> ahead[kAhead];
#pragma unroll
      for (int i = 0; i < kAhead; ++i)
        if (lane + i * a.lanes < rows)
          load_base<TX, TV, VEC>(a, ahead[i], m0 + lane + i * a.lanes, o0, n);
      for (int r = lane; r < rows; r += a.lanes) {
        const int m = m0 + r;
        const Packed<TX> base = ahead[0];
#pragma unroll
        for (int i = 0; i + 1 < kAhead; ++i) ahead[i] = ahead[i + 1];
        if (r + kAhead * a.lanes < rows)
          load_base<TX, TV, VEC>(a, ahead[kAhead - 1], m + kAhead * a.lanes, o0, n);
        const int ad = adapter_of(m);
        const TX* xr = xs + static_cast<size_t>(r) * a.d_in;
        float acc[kCols] = {};
        for (int j0 = 0; j0 < a.k; j0 += KJ) {
          if (ad != held)
            e.load(a.idx, a.val, (static_cast<size_t>(ad) * a.k + j0) * a.d_out + o0, a.d_out,
                   min(KJ, a.k - j0), a.d_in, VEC, n);
          e.gather(acc, [&](int i) { return xr[i]; });
        }
        held = a.k <= KJ ? ad : -1;
        finish<TX, TV, VEC>(a, acc, base, bias, m, o0, n);
      }
    }
    __syncthreads();  // every thread is done with buffer s before it is refilled
    if (a.stages == 1 && t + 1 < n_tiles) stage(t + 1, 0);
  }
}

struct Plan {
  int route;  // 0 rows, 1 tiles
  int threads, blocks, tile_rows, gb, lanes, spans, stages;  // tiles: blocks = spans x ranges
};

template <typename TX, typename TV, typename Ids, int KJ, bool VEC>
cudaError_t launch_kj(const Plan& p, Args<TX, TV> a, Ids ids, cudaStream_t stream) {
  if (p.route == 0) {
    if (p.threads > kRowThreads || p.threads % 32 != 0 || p.blocks < 1)
      return cudaErrorInvalidValue;
    delta_rows_kernel<TX, TV, Ids, KJ, VEC><<<p.blocks, p.threads, 0, stream>>>(a, ids);
    return cudaGetLastError();
  }
  if (p.threads > kMaxThreads || p.lanes * p.gb > p.threads || p.tile_rows < 1 ||
      p.blocks < 1 || p.stages < 1 || p.stages > 2)
    return cudaErrorInvalidValue;
  a.stage = (static_cast<size_t>(p.tile_rows) * a.d_in * sizeof(TX) + 15) / 16 * 16 + 16;
  const size_t smem = p.stages * a.stage;
  if (smem > static_cast<size_t>(rt::kSmemMax) - 1024) return cudaErrorInvalidValue;
  if (p.blocks % p.spans != 0 || p.blocks / p.spans > 65535) return cudaErrorInvalidValue;
  auto kernel = delta_tiles_kernel<TX, TV, Ids, KJ, VEC>;
  cudaError_t err = rt::allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(p.spans, p.blocks / p.spans), p.threads, smem, stream>>>(a, ids);
  return cudaGetLastError();
}

template <typename TX, typename TV, typename Ids>
cudaError_t launch(const Plan& p, const void* x, const void* idx, const void* val,
                   const void* bias, void* y, int M, int d_in, int d_out, int k, int accumulate,
                   Ids ids, cudaStream_t stream) {
  Args<TX, TV> a{static_cast<const TX*>(x), static_cast<const int32_t*>(idx),
                 static_cast<const TV*>(val), static_cast<const TX*>(bias), static_cast<TX*>(y),
                 M, d_in, d_out, k, accumulate, 0, p.tile_rows, p.gb, p.lanes, p.spans,
                 p.stages, 0};
  auto aligned = [](const void* q) { return (reinterpret_cast<uintptr_t>(q) & 15) == 0; };
  a.vec = d_out % kCols == 0 && aligned(idx) && aligned(val) && aligned(y) &&
          (bias == nullptr || aligned(bias));
  if (a.vec) {
    if (k <= 1) return launch_kj<TX, TV, Ids, 1, true>(p, a, ids, stream);
    if (k == 2) return launch_kj<TX, TV, Ids, 2, true>(p, a, ids, stream);
    return launch_kj<TX, TV, Ids, 4, true>(p, a, ids, stream);
  }
  if (k <= 1) return launch_kj<TX, TV, Ids, 1, false>(p, a, ids, stream);
  if (k == 2) return launch_kj<TX, TV, Ids, 2, false>(p, a, ids, stream);
  return launch_kj<TX, TV, Ids, 4, false>(p, a, ids, stream);
}

template <typename Ids>
cudaError_t dispatch(int x_dtype, int v_dtype, const Plan& p, const void* x, const void* idx,
                     const void* val, const void* bias, void* y, int M, int d_in, int d_out,
                     int k, int accumulate, Ids ids, cudaStream_t s) {
  using bf = __nv_bfloat16;
  if (x_dtype == RT_BF16 && v_dtype == RT_BF16)
    return launch<bf, bf>(p, x, idx, val, bias, y, M, d_in, d_out, k, accumulate, ids, s);
  if (x_dtype == RT_BF16 && v_dtype == RT_F32)
    return launch<bf, float>(p, x, idx, val, bias, y, M, d_in, d_out, k, accumulate, ids, s);
  if (x_dtype == RT_F32 && v_dtype == RT_BF16)
    return launch<float, bf>(p, x, idx, val, bias, y, M, d_in, d_out, k, accumulate, ids, s);
  if (x_dtype == RT_F32 && v_dtype == RT_F32)
    return launch<float, float>(p, x, idx, val, bias, y, M, d_in, d_out, k, accumulate, ids, s);
  return cudaErrorInvalidValue;
}

}  // namespace

// x (M, d_in), idx/val (N, k, d_out), aid (M / rows_per_id,) -> y (M, d_out).
// accumulate = 1 adds the delta into y in place, then bias (may be null).
// The plan (route 0 rows, 1 tiles; threads, blocks; tile rows, 8-column
// groups a span, row lanes, spans, stages 1 or 2) comes from
// kernels/sparse_delta.py delta_plan.
extern "C" int rt_sparse_delta_batched(const void* x, const void* idx, const void* val,
                                       const void* aid, const void* bias, void* y, int M,
                                       int d_in, int d_out, int n_ad, int k, int rows_per_id,
                                       int accumulate, int x_dtype, int v_dtype, int route,
                                       int threads, int blocks, int tile_rows, int gb,
                                       int lanes, int spans, int stages, void* stream) {
  if (rows_per_id < 1 || (accumulate == 0 && bias != nullptr)) return cudaErrorInvalidValue;
  IdsFromArray ids{static_cast<const int32_t*>(aid), n_ad, rows_per_id};
  Plan p{route, threads, blocks, tile_rows, gb, lanes, spans, stages};
  return static_cast<int>(dispatch(x_dtype, v_dtype, p, x, idx, val, bias, y, M, d_in, d_out, k,
                                   accumulate, ids, static_cast<cudaStream_t>(stream)));
}

// x (B, M, d_in), idx/val (B, k, d_out) -> y (B, M, d_out); M >= 1; the
// plan as above, over the B * M rows.
extern "C" int rt_sparse_delta(const void* x, const void* idx, const void* val, void* y, int B,
                               int M, int d_in, int d_out, int k, int x_dtype, int v_dtype,
                               int route, int threads, int blocks, int tile_rows, int gb,
                               int lanes, int spans, int stages, void* stream) {
  IdsFromRow ids{M};
  Plan p{route, threads, blocks, tile_rows, gb, lanes, spans, stages};
  return static_cast<int>(dispatch(x_dtype, v_dtype, p, x, idx, val, nullptr, y, B * M, d_in,
                                   d_out, k, 0, ids, static_cast<cudaStream_t>(stream)));
}
