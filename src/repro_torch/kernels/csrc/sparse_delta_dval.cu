// Gradient of the NeuroAda bypass values, the only gradient that trains:
//   dval[b, j, o] = sum_m dy[b, m, o] * x[b, m, idx[b, j, o]]
// float32 products and sums, one rounding to the output's dtype (float32,
// or the values' dtype: the `.to(val.dtype)` of the backward, done here).
// B is the leading batch axis of an expert stack (one launch for all
// experts), 1 for a single matrix.
//
// Replaces the TPU kernel src/repro/kernels/sparse_delta.py
// sparse_delta_dval_pallas (body _dval_kernel). On the TPU the grid's
// inner M axis runs in order and accumulates into the output block. Here
// blocks run in parallel, so M splits into row ranges across blocks, and
// the ranges' float32 partials are summed in a fixed order, so the result
// repeats bit for bit; with B = 1 the plan and the sums are those of the
// call without a batch axis.
//
// Bound and design (Hopper). The bytes are dy (M x d_out) read once, the x
// columns idx names and dval written once; the 2 M k d_out flops are far
// below the card's rate. A block owns a row range of one batch entry and
// a wide column span (all of d_out up to 4096 columns, else the fewest
// spans of at most 512 threads x 8 columns: kernels/sparse_delta.py
// dval_plan), so x crosses device memory once per row range and span, not
// once per 128-column tile: its rows are staged in shared memory by 1-D
// bulk copies on mbarriers, two buffers so the next tile of rows flies
// while this one is used (hopper.cuh stage_run). A thread owns 8
// consecutive columns (and one of `lanes` row lanes where d_out is
// narrow): it holds their idx in registers, streams dy as 16-byte loads,
// the next four rows' loads in flight while four rows' products run, and
// keeps KJ x 8 float32 accumulators; x comes from shared memory. The
// lanes sum in shared memory in lane order. The ranges merge in the same
// launch, in index order, by two levels of tickets (the ring decode's
// scheme, paged_attention.cuh): each block writes its float32 partials;
// the last block of every 16 ranges sums them, the last of those sums the
// groups and writes dval in the output's dtype; each resets its ticket.
// A call whose rows fit one range writes dval directly. One launch a
// call: no reduce kernel, no cast kernel. What binds: a fixed chain of
// about 8 us a call (the first copy, a row group's loads, the partials,
// two ticket merges; H100 80GB HBM3 at 700 W, PERF.md), most of a narrow
// projection's time, and x staged whole where the bound counts only the
// named columns (qwen2-1.5b's wdown: 36.7 MB staged, 6.3 MB named).
#include "hopper.cuh"

namespace {

constexpr int kCols = 8;
constexpr int kMaxThreads = 512;
constexpr int kGroup = 16;  // ranges one merge ticket covers, their loads in flight together

__device__ __forceinline__ void unpack(float (&o)[kCols], uint4 u) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    o[2 * i] = f.x;
    o[2 * i + 1] = f.y;
  }
}

// 8 consecutive values of dy as loaded: one 16-byte vector of bf16 (or two
// of float32) held packed until use, which keeps rows in flight in few
// registers; with `vec` false, the n < 8 valid columns of a ragged
// edge, zeros after
template <typename T>
struct Dy {
  uint4 u[sizeof(T) / 2];
  __device__ __forceinline__ void load(const T* p, bool vec, int n) {
    if (vec) {
#pragma unroll
      for (int i = 0; i < static_cast<int>(sizeof(T)) / 2; ++i)
        u[i] = __ldg(reinterpret_cast<const uint4*>(p) + i);
    } else {
      T* e = reinterpret_cast<T*>(u);
#pragma unroll
      for (int c = 0; c < kCols; ++c) e[c] = c < n ? __ldg(p + c) : rt::from_f<T>(0.f);
    }
  }
  __device__ __forceinline__ float operator[](int c) const {
    return rt::to_f(reinterpret_cast<const T*>(u)[c]);
  }
};

// After this block's partials are written: takes a ticket of `counter`
// (one of `n` blocks) and tells whether it was the last, with the others'
// partials then visible.
__device__ __forceinline__ bool last_of(int32_t* counter, int n, int* s_last) {
  __threadfence();  // this block's partials are visible before its ticket
  __syncthreads();
  if (threadIdx.x == 0) *s_last = atomicAdd(counter, 1) == n - 1;
  __syncthreads();
  if (!*s_last) return false;
  __threadfence();
  return true;
}

template <typename T, typename TO>
struct Args {
  const T* x;
  const int32_t* idx;
  const T* dy;
  float* part;       // (B, ranges, k, d_out) float32 partials (ranges > 1)
  float* gpart;      // (B, groups, k, d_out) float32 group sums (groups > 1)
  TO* dval;          // (B, k, d_out)
  int32_t* tickets;  // B * spans * (groups + 1) counters, 0 between launches
  int B, M, d_in, d_out, k;
  int rows_per_range, ranges, tile_rows, gb, lanes, spans, stages;
  int vec;
  size_t stage;  // bytes of one staging buffer
};

// grid (spans, ranges, B)
template <typename T, typename TO, int KJ, bool VEC>
__global__ void __launch_bounds__(kMaxThreads) dval_kernel(const Args<T, TO> a) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ __align__(8) uint64_t bar[2];
  __shared__ int s_last;
  const int sp = blockIdx.x, range = blockIdx.y, b = blockIdx.z;
  const int m_begin = range * a.rows_per_range;
  const int m_end = min(a.M, m_begin + a.rows_per_range);
  const int n_tiles = (m_end - m_begin + a.tile_rows - 1) / a.tile_rows;
  const int n_chunks = (a.k + KJ - 1) / KJ;
  const int steps = n_chunks * n_tiles;
  const int lane = threadIdx.x / a.gb, grp = threadIdx.x - lane * a.gb;
  const int span_cols = a.gb * kCols;
  const int o0 = sp * span_cols + grp * kCols;
  const bool mine = lane < a.lanes && o0 < a.d_out;  // this thread has columns
  const int n = min(kCols, a.d_out - o0);
  const T* xb = a.x + static_cast<size_t>(b) * a.M * a.d_in;
  const T* dyb = a.dy + static_cast<size_t>(b) * a.M * a.d_out;
  float* red = reinterpret_cast<float*>(smem + a.stages * a.stage);  // lanes x span_cols

  if (threadIdx.x == 0) {
    rt::mbar_init(&bar[0], 1);
    rt::mbar_init(&bar[1], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  auto first_x = [&](int q) {
    return xb + static_cast<size_t>(m_begin + (q % n_tiles) * a.tile_rows) * a.d_in;
  };
  auto stage = [&](int q, int s) {
    const int m0 = m_begin + (q % n_tiles) * a.tile_rows;
    const int rows = min(a.tile_rows, m_end - m0);
    rt::stage_run<sizeof(T)>(smem + s * a.stage, first_x(q),
                             static_cast<size_t>(rows) * a.d_in * sizeof(T), &bar[s]);
  };
  // a value of (j, o) this block settled: dval itself when one range
  // covers all rows, else its partial
  auto put = [&](int j, int o, float v) {
    if (a.ranges == 1)
      a.dval[(static_cast<size_t>(b) * a.k + j) * a.d_out + o] = rt::from_f<TO>(v);
    else
      a.part[((static_cast<size_t>(b) * a.ranges + range) * a.k + j) * a.d_out + o] = v;
  };

  if (steps > 0) stage(0, 0);
  int col[KJ][kCols];
  float acc[KJ][kCols];
  for (int q = 0; q < steps; ++q) {
    const int s = q % a.stages, chunk = q / n_tiles, tile = q - chunk * n_tiles;
    const int j0 = chunk * KJ, nj = min(KJ, a.k - j0);
    if (tile == 0) {  // a new chunk of entries: their columns, zero sums
#pragma unroll
      for (int t = 0; t < KJ; ++t) {
        const int32_t* ip = a.idx + (static_cast<size_t>(b) * a.k + j0 + t) * a.d_out + o0;
        if (mine && t < nj) {
          if (VEC) {
            const int4 u = __ldg(reinterpret_cast<const int4*>(ip));
            const int4 w = __ldg(reinterpret_cast<const int4*>(ip) + 1);
            col[t][0] = u.x; col[t][1] = u.y; col[t][2] = u.z; col[t][3] = u.w;
            col[t][4] = w.x; col[t][5] = w.y; col[t][6] = w.z; col[t][7] = w.w;
          } else {
#pragma unroll
            for (int c = 0; c < kCols; ++c) col[t][c] = c < n ? __ldg(ip + c) : 0;
          }
        }
#pragma unroll
        for (int c = 0; c < kCols; ++c) {
          // indices come from selection; clamp so a bad one never reads
          // outside the row
          col[t][c] = mine && t < nj ? min(max(col[t][c], 0), a.d_in - 1) : 0;
          acc[t][c] = 0.f;
        }
      }
    }
    if (a.stages == 2 && q + 1 < steps) stage(q + 1, s ^ 1);  // flies while q is used
    rt::mbar_wait(&bar[s], (q / a.stages) & 1);
    __syncthreads();  // the plain stores of the run's ends are in
    const int m0 = m_begin + tile * a.tile_rows, rows = min(a.tile_rows, m_end - m0);
    const T* xs = reinterpret_cast<const T*>(
        smem + s * a.stage + (reinterpret_cast<uintptr_t>(first_x(q)) & 15));
    if (mine) {
      const T* dyp = dyb + static_cast<size_t>(m0) * a.d_out + o0;
      int r = lane;
      // dy of kRows rows a group, the next group's loads in flight while
      // this group's products run (in row order)
      constexpr int kRows = sizeof(T) == 2 ? 4 : 2;
      const int step = kRows * a.lanes;
      auto load_group = [&](Dy<T> (&d)[kRows], int r0) {
#pragma unroll
        for (int u = 0; u < kRows; ++u)
          d[u].load(dyp + static_cast<size_t>(r0 + u * a.lanes) * a.d_out, VEC, n);
      };
      Dy<T> g[kRows];
      bool have = r + (kRows - 1) * a.lanes < rows;
      if (have) load_group(g, r);
      for (; have; r += step) {
        Dy<T> h[kRows];
        const bool next = r + step + (kRows - 1) * a.lanes < rows;
        if (next) load_group(h, r + step);
#pragma unroll
        for (int u = 0; u < kRows; ++u) {
          const T* xr = xs + static_cast<size_t>(r + u * a.lanes) * a.d_in;
#pragma unroll
          for (int t = 0; t < KJ; ++t)
#pragma unroll
            for (int c = 0; c < kCols; ++c)
              acc[t][c] = fmaf(g[u][c], rt::to_f(xr[col[t][c]]), acc[t][c]);
        }
        if (next) {
#pragma unroll
          for (int u = 0; u < kRows; ++u) g[u] = h[u];
        }
        have = next;
      }
      for (; r < rows; r += a.lanes) {
        Dy<T> g;
        g.load(dyp + static_cast<size_t>(r) * a.d_out, VEC, n);
        const T* xr = xs + static_cast<size_t>(r) * a.d_in;
#pragma unroll
        for (int t = 0; t < KJ; ++t)
#pragma unroll
          for (int c = 0; c < kCols; ++c)
            acc[t][c] = fmaf(g[c], rt::to_f(xr[col[t][c]]), acc[t][c]);
      }
    }
    __syncthreads();  // every thread is done with buffer s before it is refilled
    if (a.stages == 1 && q + 1 < steps) stage(q + 1, 0);
    if (tile != n_tiles - 1) continue;
    // the chunk's last tile: settle entries j0 .. j0 + nj - 1 of the span
    if (a.lanes == 1) {
      if (mine)
#pragma unroll
        for (int t = 0; t < KJ; ++t)
          if (t < nj)
#pragma unroll
            for (int c = 0; c < kCols; ++c)
              if (c < n) put(j0 + t, o0 + c, acc[t][c]);
    } else {
#pragma unroll
      for (int t = 0; t < KJ; ++t) {
        if (t >= nj) break;  // nj is the block's: the barriers below stay uniform
        if (lane < a.lanes)
#pragma unroll
          for (int c = 0; c < kCols; ++c) red[lane * span_cols + grp * kCols + c] = acc[t][c];
        __syncthreads();
        for (int e = threadIdx.x; e < span_cols; e += blockDim.x) {
          const int o = sp * span_cols + e;
          if (o >= a.d_out) continue;
          float v = 0.f;
          for (int l = 0; l < a.lanes; ++l) v += red[l * span_cols + e];
          put(j0 + t, o, v);
        }
        __syncthreads();
      }
    }
  }
  if (a.ranges == 1) return;
  // Merge the ranges in index order, in two levels of tickets: the last
  // block of each group of kGroup ranges to finish sums the group's
  // partials (into dval itself when one group covers all ranges), then the
  // last group to finish sums the groups. Each level's sums are spread
  // over its block's threads, 16 bytes a load where d_out allows.
  const int n_groups = (a.ranges + kGroup - 1) / kGroup, grp_id = range / kGroup;
  const int g_first = grp_id * kGroup, g_size = min(kGroup, a.ranges - g_first);
  const int cols = min(span_cols, a.d_out - sp * span_cols);
  int32_t* t1 = a.tickets + (static_cast<size_t>(b) * a.spans + sp) * n_groups + grp_id;
  if (!last_of(t1, g_size, &s_last)) return;
  const size_t plane = static_cast<size_t>(a.k) * a.d_out;  // one range's (k, d_out)
  const size_t col0 = static_cast<size_t>(b) * a.k * a.d_out + sp * span_cols;
  // sum `n` planes from `src` (index order) into `dst`, the span's k x cols
  // entries; `round` rounds to TO (the last level)
  // (up to kGroup planes' loads in flight, then their sum in index order)
  auto merge = [&](const float* src, int n_planes, auto&& write) {
    const int per = VEC ? 4 : 1, units = cols / per;
    for (int e = threadIdx.x; e < a.k * units; e += blockDim.x) {
      const int j = e / units;
      const size_t o = static_cast<size_t>(j) * a.d_out + (e - j * units) * per;
      if (VEC) {
        float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
        for (int r0 = 0; r0 < n_planes; r0 += kGroup) {
          float4 u[kGroup];
#pragma unroll
          for (int r = 0; r < kGroup; ++r)
            if (r0 + r < n_planes)
              u[r] = __ldcg(reinterpret_cast<const float4*>(src + (r0 + r) * plane + o));
#pragma unroll
          for (int r = 0; r < kGroup; ++r)
            if (r0 + r < n_planes) {
              v.x += u[r].x; v.y += u[r].y; v.z += u[r].z; v.w += u[r].w;
            }
        }
        write(o, v.x); write(o + 1, v.y); write(o + 2, v.z); write(o + 3, v.w);
      } else {
        float v = 0.f;
        for (int r0 = 0; r0 < n_planes; r0 += kGroup) {
          float u[kGroup];
#pragma unroll
          for (int r = 0; r < kGroup; ++r)
            if (r0 + r < n_planes) u[r] = __ldcg(src + (r0 + r) * plane + o);
#pragma unroll
          for (int r = 0; r < kGroup; ++r)
            if (r0 + r < n_planes) v += u[r];
        }
        write(o, v);
      }
    }
  };
  auto to_dval = [&](size_t o, float v) { a.dval[col0 + o] = rt::from_f<TO>(v); };
  const float* parts = a.part + (static_cast<size_t>(b) * a.ranges + g_first) * plane + sp * span_cols;
  if (n_groups == 1) {
    merge(parts, g_size, to_dval);
    if (threadIdx.x == 0) *t1 = 0;
    return;
  }
  float* gsum = a.gpart + (static_cast<size_t>(b) * n_groups + grp_id) * plane + sp * span_cols;
  merge(parts, g_size, [&](size_t o, float v) { gsum[o] = v; });
  if (threadIdx.x == 0) *t1 = 0;
  int32_t* t2 = a.tickets + static_cast<size_t>(a.B) * a.spans * n_groups + b * a.spans + sp;
  if (!last_of(t2, n_groups, &s_last)) return;
  merge(a.gpart + static_cast<size_t>(b) * n_groups * plane + sp * span_cols, n_groups, to_dval);
  if (threadIdx.x == 0) *t2 = 0;
}

template <typename T, typename TO, int KJ, bool VEC>
cudaError_t launch_kj(const Args<T, TO>& a, int threads, cudaStream_t stream) {
  const size_t red = a.lanes > 1 ? static_cast<size_t>(a.lanes) * a.gb * kCols * 4 : 0;
  const size_t smem = a.stages * a.stage + red;
  if (smem > static_cast<size_t>(rt::kSmemMax) - 1024) return cudaErrorInvalidValue;
  auto kernel = dval_kernel<T, TO, KJ, VEC>;
  cudaError_t err = rt::allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  dim3 grid(a.spans, a.ranges, a.B);
  kernel<<<grid, threads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename T, typename TO, bool VEC>
cudaError_t launch_vec(const Args<T, TO>& a, int threads, cudaStream_t stream) {
  if (a.k <= 1) return launch_kj<T, TO, 1, VEC>(a, threads, stream);
  if (a.k == 2) return launch_kj<T, TO, 2, VEC>(a, threads, stream);
  return launch_kj<T, TO, 4, VEC>(a, threads, stream);
}

template <typename T, typename TO>
cudaError_t launch(const void* x, const void* idx, const void* dy, void* part, void* gpart,
                   void* dval, void* tickets, int B, int M, int d_in, int d_out, int k,
                   const int (&plan)[8], cudaStream_t stream) {
  const int threads = plan[0], rows_per_range = plan[1], ranges = plan[2], tile_rows = plan[3],
            gb = plan[4], lanes = plan[5], spans = plan[6], stages = plan[7];
  if (threads > kMaxThreads || lanes * gb > threads || tile_rows < 1 || ranges < 1 ||
      ranges > 65535 || spans < 1 || stages < 1 || stages > 2 ||
      static_cast<long long>(ranges) * rows_per_range < M ||
      static_cast<long long>(ranges - 1) * rows_per_range >= M)
    return cudaErrorInvalidValue;  // every range must hold rows
  auto aligned = [](const void* q) { return (reinterpret_cast<uintptr_t>(q) & 15) == 0; };
  Args<T, TO> a{static_cast<const T*>(x), static_cast<const int32_t*>(idx),
                static_cast<const T*>(dy), static_cast<float*>(part), static_cast<float*>(gpart),
                static_cast<TO*>(dval), static_cast<int32_t*>(tickets), B, M, d_in, d_out, k,
                rows_per_range, ranges, tile_rows, gb, lanes, spans, stages,
                d_out % kCols == 0 && aligned(idx) && aligned(dy),
                (static_cast<size_t>(tile_rows) * d_in * sizeof(T) + 15) / 16 * 16 + 16};
  return a.vec ? launch_vec<T, TO, true>(a, threads, stream)
               : launch_vec<T, TO, false>(a, threads, stream);
}

}  // namespace

// x (B, M, d_in), idx (B, k, d_out), dy (B, M, d_out) -> dval (B, k, d_out)
// in float32 (out_dtype RT_F32) or bf16. The plan comes from
// kernels/sparse_delta.py dval_plan: threads, rows a range, ranges, rows a
// staged tile, 8-column groups a span, row lanes, spans, stages (1 or 2).
// The caller sizes the float32 scratch — partials (B, ranges, k, d_out) and
// group sums (B, ceil(ranges / 16), k, d_out), unused with one range or one
// group — and passes B * spans * (groups + 1) ticket counters, all 0.
extern "C" int rt_sparse_delta_dval(const void* x, const void* idx, const void* dy, void* part,
                                    void* gpart, void* dval, void* tickets, int B, int M,
                                    int d_in, int d_out, int k, int dtype, int out_dtype,
                                    int threads, int rows_per_range, int ranges, int tile_rows,
                                    int gb, int lanes, int spans, int stages, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int plan[8] = {threads, rows_per_range, ranges, tile_rows, gb, lanes, spans, stages};
  using bf = __nv_bfloat16;
  if (dtype == RT_BF16 && out_dtype == RT_F32)
    return launch<bf, float>(x, idx, dy, part, gpart, dval, tickets, B, M, d_in, d_out, k, plan, s);
  if (dtype == RT_BF16 && out_dtype == RT_BF16)
    return launch<bf, bf>(x, idx, dy, part, gpart, dval, tickets, B, M, d_in, d_out, k, plan, s);
  if (dtype == RT_F32 && out_dtype == RT_F32)
    return launch<float, float>(x, idx, dy, part, gpart, dval, tickets, B, M, d_in, d_out, k,
                                plan, s);
  if (dtype == RT_F32 && out_dtype == RT_BF16)
    return launch<float, bf>(x, idx, dy, part, gpart, dval, tickets, B, M, d_in, d_out, k,
                             plan, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
