// The pieces shared by the dense and the packed fused linear kernels
// (fused_linear.cu, fused_linear_q.cu): the WMMA / FMA block tiles, the bf16
// x-tile loader and the epilogue that adds the NeuroAda bypass and the bias
// to an accumulated element (the cp.async wrappers live in common.cuh); and
// the Hopper mainloop both kernels launch for bf16 on shapes TMA can
// describe (below the epilogue): TMA loads into a ring of shared-memory
// stages, one producer warp, two consumer warpgroups on wgmma (the
// mbarrier, TMA and wgmma helpers live in hopper.cuh).
#pragma once

#include "hopper.cuh"

namespace rt {

// --------------------------------------------------------------- tiles

// bf16 (WMMA): a 128x128 output tile per block of 8 warps, each warp a
// 64x32 sub-tile (2 x 4 warps), 32-deep K tiles.
constexpr int BM = 128, BN = 128, BK = 32;
constexpr int WM = 64, WN = 32;
constexpr int A_LD = BK + 8;  // padded rows keep fragments 32-byte aligned
constexpr int B_LD = BN + 8;
constexpr int kThreadsTC = 256;
// float32 (FMA): a 64x64 output tile, 4x4 outputs per thread, 16-deep K tiles.
constexpr int FM = 64, FN = 64, FK = 16, kThreadsF = 256;

// The x tile (rows m0.., columns k0..) of a bf16 block: cp.async in 16-byte
// chunks when VEC (K a multiple of 8, x 16-byte aligned), plain loads
// otherwise; out-of-range elements load as zeros.
template <bool VEC>
__device__ __forceinline__ void load_x_tile(__nv_bfloat16 (*As)[A_LD],
                                            const __nv_bfloat16* __restrict__ x, int m0, int k0,
                                            int M, int K) {
  const int tid = threadIdx.x;
  if (VEC) {
#pragma unroll
    for (int t = 0; t < 2; ++t) {  // 128 rows x 4 chunks of 8
      const int c = tid + t * kThreadsTC;
      const int r = c >> 2, kc = (c & 3) * 8;
      const int gm = m0 + r, gk = k0 + kc;
      const bool ok = gm < M && gk < K;
      cp_async16(&As[r][kc], ok ? x + static_cast<size_t>(gm) * K + gk : x, ok);
    }
  } else {
    const __nv_bfloat16 zero = __float2bfloat16(0.f);
    for (int e = tid; e < BM * BK; e += kThreadsTC) {
      const int r = e / BK, kc = e % BK;
      const int gm = m0 + r, gk = k0 + kc;
      As[r][kc] = (gm < M && gk < K) ? x[static_cast<size_t>(gm) * K + gk] : zero;
    }
  }
}

// ------------------------------------------------------------ epilogue

// y[m, n] = acc + sum_j val[j, n] * x[m, idx[j, n]] (+ bias[n]), one cast.
template <typename TX, typename TV>
__device__ __forceinline__ void finish(float acc, const TX* __restrict__ x,
                                       const int32_t* __restrict__ idx,
                                       const TV* __restrict__ val, const TX* __restrict__ bias,
                                       TX* __restrict__ y, int m, int n, int K, int N, int k) {
  const TX* xr = x + static_cast<size_t>(m) * K;
  for (int j = 0; j < k; ++j) {
    const size_t e = static_cast<size_t>(j) * N + n;
    // indices come from selection; clamp so a bad one can never read
    // outside the row
    const int i = min(max(idx[e], 0), K - 1);
    acc += to_f(val[e]) * to_f(xr[i]);
  }
  if (bias != nullptr) acc += to_f(bias[n]);
  y[static_cast<size_t>(m) * N + n] = from_f<TX>(acc);
}


// ======================================== Hopper: TMA + mbarrier + wgmma
//
// y = x W (+ bypass, + bias) as y^T = W^T x^T: a block owns kTmaCols = 128
// weight columns (two consumer warpgroups of 64, the wgmma M side) and R
// rows of x (the wgmma N side; R one of tma_rows_ok's, chosen per call by
// fused_linear.linear_plan). Each stage of the ring holds one 64-deep K
// tile: x's (R, 64) rows by TMA, K-major with the 128-byte swizzle (the
// wgmma B operand as it lies in x), and the weight tile, whose form the
// weight policy W chooses:
// - DenseW (fused_linear.cu): W's (64, 128) bf16 tile as two TMA boxes of
//   64 columns, 128-byte swizzle; each warpgroup's box is its A operand,
//   MN-major (transposed), read straight from the stage;
// - PackedW (fused_linear_q.cu): the (64, 128) int8 or (32, 128) NF4 codes
//   by TMA with the 128-byte swizzle (and a scale row when one serves the
//   tile); each consumer thread dequantizes its two columns straight into
//   wgmma A fragments in registers, tile t's while tile t - 1's products
//   run, so no dequantized tile is written to or read from shared memory.
// Warpgroup 0 gives up registers (setmaxnreg 40) to the consumers (232).
// Its first thread is the producer: it waits for a stage to be released
// (the empty barrier: one arrival from each consumer warp, and from each
// gather warp when they run), arms the stage's full barrier with its bytes
// and issues its TMA loads. Consumers wait on the full barrier, issue 4
// wgmma (k16 each) into float32 accumulators, commit, and wait until at
// most this tile's group is in flight, so the previous tile's stage is
// released one tile late and the tensor cores always have the next group
// queued. No block-wide barrier runs in the loop, however long K is.
//
// The bypass is taken in the mainloop, as the Pallas kernel does: the other
// three warps of warpgroup 0 (gather warps) wait on each stage too, and copy
// x's column idx[j, n] - k0 of the staged tile, all R rows, for every entry
// (j, n) of the block whose index falls inside this K tile, into a bf16
// gather buffer xg[j][m][n]; they release the stage like the consumers.
// Every index lies in exactly one tile, so each entry is copied once, from
// shared memory, with no global gather. The buffer holds kCap entries a
// column (what shared memory leaves beside the ring: 1 at R = 192, 15 at
// R = 32); entries past it, if any, are read from x in global memory in
// the epilogue. Epilogue: the accumulators go through shared memory (over
// the ring, idle by then), which turns them back to (M, N) rows; then the
// bypass (sum_j val[j, n] * x[m, idx[j, n]], j in order) and the bias are
// added in float32, and y is cast once and stored, 4 bytes a thread, a
// warp's stores one contiguous 128-byte run.
//
// -Xptxas=-v (CUDA 12.8): every instantiation 168 registers at entry (the
// launch bound of 384 threads, one block an SM), no spills; dynamic shared
// memory is WgmmaSmem::kBytes: 211 KB dense and 181 / 215 KB int8 / NF4 at
// R = 192, 218-227 KB at R = 32.

constexpr int kTmaCols = 128;     // weight columns of a block: two warpgroups x 64
constexpr int kTmaBK = 64;        // K rows a stage: one 128-byte swizzle row of bf16 x
constexpr int kTmaThreads = 384;  // warpgroup 0: producer + 3 gather warps; 1 and 2: consumers
constexpr int kTmaConsumerWarps = 8, kTmaGatherWarps = 3;
constexpr int kTmaBox = 64 * 128;  // bytes of one 64 x 64 bf16 box (one warpgroup's A)
constexpr int kTmaStageRow = kTmaCols + 4;  // float32 epilogue staging row (bank offset)
constexpr int kXgRow = kTmaCols + 2;  // bf16 row of the bypass gather (bank offset)

// x (M, K) bf16 in boxes of (R rows, 64 columns), 128-byte swizzle
inline cudaError_t encode_x(CUtensorMap* map, const void* x, int M, int K, int R) {
  return encode_2d(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, x, M, K, 2, R, kTmaBK, true);
}

// ---------------------------------------------------------------- kernel

struct WgmmaArgs {
  const __nv_bfloat16* x;
  const float* scales;  // packed weights only
  const int32_t* idx;   // (k, N), null when k = 0
  const void* val;      // (k, N) float32 or bf16 (v_f32)
  const __nv_bfloat16* bias;
  __nv_bfloat16* y;
  int M, N, K, k, block, v_f32, uniform;
};

// Shared memory of one block, in order: the ring of kStages stages (x tile +
// weight tile), a ring of scale rows (packed weights), the bypass gather
// (kCap entries a column: x values, indices, values), full + empty
// barriers, and 1024 bytes of alignment slack. Four stages where one gather
// entry still fits beside them, else three where the epilogue's staging
// still fits the ring (the bypass may then go to the epilogue).
template <class W, int R>
constexpr int wgmma_fixed_bytes(int stages) {
  return stages * (R * 128 + W::kStageBytes + W::kScaleBytes) + 2 * 4 * 8 + 1024;
}
template <class W, int R>
struct WgmmaSmem {
  static constexpr int kX = R * 128;  // a stage's x tile
  static constexpr int kStage = kX + W::kStageBytes;
  static constexpr int kXg = R * kXgRow * 2 + kTmaCols * 8;  // one gather entry
  static constexpr int kStaging = R * kTmaStageRow * 4;  // the epilogue's, over the ring
  static constexpr int kStages = wgmma_fixed_bytes<W, R>(4) + kXg <= kSmemMax ? 4
                                 : kStaging <= 3 * kStage                    ? 3
                                                                             : 4;
  static constexpr int kCap = (kSmemMax - wgmma_fixed_bytes<W, R>(kStages)) / kXg;
  static constexpr int kBytes = wgmma_fixed_bytes<W, R>(kStages) + kCap * kXg;
  static_assert(kStage % 1024 == 0, "swizzled tiles need 1024-byte alignment");
  static_assert(kCap >= 0, "the ring fits");
  static_assert(kStaging <= kStages * kStage, "epilogue staging fits the ring");
};

template <class W, int R>
__global__ void __launch_bounds__(kTmaThreads, 1)
    linear_wgmma_kernel(__grid_constant__ const CUtensorMap x_map,
                        __grid_constant__ const CUtensorMap w_map,
                        __grid_constant__ const CUtensorMap s_map, const WgmmaArgs a) {
  using L = WgmmaSmem<W, R>;
  constexpr int kX = L::kX, kStage = L::kStage, S = L::kStages;
  extern __shared__ uint8_t smem_raw[];
  __shared__ float nf4[16];
  uint8_t* ring = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  float* srows = reinterpret_cast<float*>(ring + S * kStage);  // (S, kTmaCols) packed only
  __nv_bfloat16* xg = reinterpret_cast<__nv_bfloat16*>(
      ring + S * (kStage + W::kScaleBytes));  // (kCap, R, kXgRow)
  int* xg_idx = reinterpret_cast<int*>(xg + L::kCap * R * kXgRow);  // (kCap, kTmaCols)
  float* xg_val = reinterpret_cast<float*>(xg_idx + L::kCap * kTmaCols);  // (kCap, kTmaCols)
  uint64_t* full = reinterpret_cast<uint64_t*>(xg_val + L::kCap * kTmaCols);
  uint64_t* empty = full + S;

  const int wg = threadIdx.x / 128, warp = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32;
  const int n0 = blockIdx.x * kTmaCols, m0 = blockIdx.y * R;
  const int M = a.M, N = a.N, K = a.K;
  const int T = (K + kTmaBK - 1) / kTmaBK;
  const int kg = min(a.k, L::kCap);  // bypass entries gathered in the mainloop
  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kTmaConsumerWarps + (kg > 0 ? kTmaGatherWarps : 0));
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  if (threadIdx.x < 16) nf4[threadIdx.x] = W::code(threadIdx.x);
  __syncthreads();
  // consumers, plus the gather warps when they run, meet before the epilogue
  const int epi_threads = 256 + (kg > 0 ? 32 * kTmaGatherWarps : 0);

  if (wg == 0) {
    setmaxnreg_dec<40>();
    if (warp == 0) {  // ------------------------------------------ producer
      if (lane == 0) {
        const int tx = kStage + (a.uniform ? W::kScaleBytes : 0);
        for (int t = 0; t < T; ++t) {
          const int s = t % S;
          if (t >= S) mbar_wait(&empty[s], (t / S - 1) & 1);
          uint8_t* st = ring + s * kStage;
          mbar_expect_tx(&full[s], tx);
          tma_load_2d(st, &x_map, &full[s], t * kTmaBK, m0);
          W::load(st + kX, &w_map, &full[s], n0, t);
          // one scale row serves the tile: it lands with the codes
          if (a.uniform) tma_load_2d(srows + s * kTmaCols, &s_map, &full[s], n0, t * kTmaBK / a.block);
        }
      }
    } else if (kg > 0) {  // ---------------------------------- gather warps
      const int gw = warp - 1, entries = kg * kTmaCols;  // entry p = j * 128 + column
      // the block's indices (clamped: they come from selection, and a bad one
      // must never read outside the row; -1 past N) and values, once
      for (int p = threadIdx.x - 32; p < entries; p += 32 * kTmaGatherWarps) {
        const int n = n0 + p % kTmaCols;
        const size_t e = static_cast<size_t>(p / kTmaCols) * N + n;
        xg_idx[p] = n < N ? min(max(a.idx[e], 0), K - 1) : -1;
        xg_val[p] = n >= N ? 0.f
                    : a.v_f32 ? static_cast<const float*>(a.val)[e]
                              : to_f(static_cast<const __nv_bfloat16*>(a.val)[e]);
      }
      asm volatile("bar.sync 5, %0;\n" ::"r"(32 * kTmaGatherWarps) : "memory");
      for (int t = 0; t < T; ++t) {
        const int s = t % S, k0 = t * kTmaBK;
        mbar_wait(&full[s], (t / S) & 1);
        const uint8_t* xs = ring + s * kStage;
        for (int p0 = 32 * gw; p0 < entries; p0 += 32 * kTmaGatherWarps) {
          const int p = p0 + lane;
          // this lane's entry's column within the tile, if it falls here
          const int i = p < entries ? xg_idx[p] : -1;
          const int kk = i >= k0 && i < k0 + kTmaBK ? i - k0 : -1;
          for (unsigned hits = __ballot_sync(0xffffffffu, kk >= 0); hits; hits &= hits - 1) {
            const int src = __ffs(hits) - 1, hk = __shfl_sync(0xffffffffu, kk, src);
            const int hp = p0 + src;
            __nv_bfloat16* dst = xg + (hp / kTmaCols) * R * kXgRow + hp % kTmaCols;
            // x tile row m, column hk: 16-byte chunk hk / 8 XOR the row within
            // its 8-row atom; all R / 32 loads of a lane in flight together
            __nv_bfloat16 v[R / 32];
#pragma unroll
            for (int q = 0; q < R / 32; ++q) {
              const int m = lane + 32 * q;
              v[q] = *reinterpret_cast<const __nv_bfloat16*>(
                  xs + m * 128 + (((hk >> 3) ^ (m & 7)) << 4) + (hk & 7) * 2);
            }
#pragma unroll
            for (int q = 0; q < R / 32; ++q) dst[(lane + 32 * q) * kXgRow] = v[q];
          }
        }
        __syncwarp();
        if (lane == 0) mbar_arrive(&empty[s]);
      }
      __threadfence_block();
      asm volatile("bar.arrive 3, %0;\n" ::"r"(epi_threads) : "memory");
    }
    return;
  }

  // ------------------------------------------------------------- consumers
  setmaxnreg_inc<232>();
  const int cw = wg - 1;  // this warpgroup's 64 columns: n0 + 64 cw ..
  float acc[R / 2];
#pragma unroll
  for (int i = 0; i < R / 2; ++i) acc[i] = 0.f;
  const uint32_t ring_a = smem_addr(ring);
  if constexpr (W::kDequant) {
    // A fragments of two tiles: tile t's are built while tile t - 1's
    // products (reading the other set) are still in flight
    uint32_t fa[2][kTmaBK / 16][4];
    const int col = cw * 64 + warp * 16 + 2 * (lane / 4);  // this thread's columns col, col + 1
    for (int t0 = 0; t0 < T; t0 += 2) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int t = t0 + h;
        if (t < T) {
          const int s = t % S;
          mbar_wait(&full[s], (t / S) & 1);
          W::fragments(fa[h], ring + s * kStage + kX, srows + s * kTmaCols, nf4, a, t, n0, col,
                       lane % 4);
          const uint32_t xa = ring_a + s * kStage;
          wgmma_fence();
#pragma unroll
          for (int ks = 0; ks < kTmaBK / 16; ++ks)
            WgmmaRS<R>::mma(acc, fa[h][ks], gmma_desc(xa + ks * 32, 16, 1024));
          wgmma_commit();
          wgmma_wait<1>();  // tile t - 1's products are done: release its stage
#pragma unroll
          for (int ks = 0; ks < kTmaBK / 16; ++ks)  // its fragments stay put until here
#pragma unroll
            for (int i = 0; i < 4; ++i) asm volatile("" : "+r"(fa[h ^ 1][ks][i])::"memory");
          if (t > 0 && lane == 0) mbar_arrive(&empty[(t - 1) % S]);
        }
      }
    }
  } else {
    for (int t = 0; t < T; ++t) {
      const int s = t % S;
      mbar_wait(&full[s], (t / S) & 1);
      const uint32_t xa = ring_a + s * kStage, wa = xa + kX + cw * kTmaBox;
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < kTmaBK / 16; ++ks)
        Wgmma<R>::mma(acc, gmma_desc(wa + ks * 2048, kTmaBox, 1024),
                      gmma_desc(xa + ks * 32, 16, 1024));
      wgmma_commit();
      wgmma_wait<1>();  // tile t - 1's products are done: release its stage
      if (t > 0 && lane == 0) mbar_arrive(&empty[(t - 1) % S]);
    }
  }
  wgmma_wait<0>();
#pragma unroll
  for (int i = 0; i < R / 2; ++i) asm volatile("" : "+f"(acc[i])::"memory");

  // ------------------------------------------------------------- epilogue
  // both warpgroups are done with the ring, the gather warps with xg
  asm volatile("bar.sync 3, %0;\n" ::"r"(epi_threads) : "memory");
  float* st = reinterpret_cast<float*>(ring);  // (R, kTmaStageRow) float32
  const int g = lane / 4, t4 = lane % 4;
  // A rows g and g + 8 of this warp are weight columns c and c + dc: 16w + g
  // and + 8 as TMA lays the dense tile, 16w + 2g and + 1 as the packed
  // fragments pair them
  const int c = cw * 64 + warp * 16 + (W::kDequant ? 2 * g : g), dc = W::kDequant ? 1 : 8;
#pragma unroll
  for (int j = 0; j < R / 8; ++j) {
    const int m = 8 * j + 2 * t4;
    st[m * kTmaStageRow + c] = acc[4 * j];
    st[(m + 1) * kTmaStageRow + c] = acc[4 * j + 1];
    st[m * kTmaStageRow + c + dc] = acc[4 * j + 2];
    st[(m + 1) * kTmaStageRow + c + dc] = acc[4 * j + 3];
  }
  named_bar(4, 256);
  // thread e of the 256 writes columns cc, cc + 1 of rows e / 64 + 4 i, four
  // rows at a time
  const int e = threadIdx.x - 128, cc = 2 * (e % (kTmaCols / 2)), gn = n0 + cc;
  if (gn >= N) return;  // N % 8 == 0 on this route: gn + 1 < N
  const float b0 = a.bias != nullptr ? to_f(a.bias[gn]) : 0.f;
  const float b1 = a.bias != nullptr ? to_f(a.bias[gn + 1]) : 0.f;
  for (int m4 = e / 64; m4 < R; m4 += 16) {
    float2 v[4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
      v[r] = *reinterpret_cast<const float2*>(st + (m4 + 4 * r) * kTmaStageRow + cc);
    for (int j = 0; j < kg; ++j) {  // gathered: x from shared memory
      const float2 w = *reinterpret_cast<const float2*>(xg_val + j * kTmaCols + cc);
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const __nv_bfloat162 x2 = *reinterpret_cast<const __nv_bfloat162*>(
            xg + (j * R + m4 + 4 * r) * kXgRow + cc);
        v[r].x += w.x * __low2float(x2);
        v[r].y += w.y * __high2float(x2);
      }
    }
    for (int j = kg; j < a.k; ++j) {  // past the gather buffer: x's rows in global memory
      const size_t ej = static_cast<size_t>(j) * N + gn;
      const float w0 = a.v_f32 ? static_cast<const float*>(a.val)[ej]
                               : to_f(static_cast<const __nv_bfloat16*>(a.val)[ej]);
      const float w1 = a.v_f32 ? static_cast<const float*>(a.val)[ej + 1]
                               : to_f(static_cast<const __nv_bfloat16*>(a.val)[ej + 1]);
      const int i0 = min(max(a.idx[ej], 0), K - 1), i1 = min(max(a.idx[ej + 1], 0), K - 1);
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const __nv_bfloat16* xr = a.x + static_cast<size_t>(min(m0 + m4 + 4 * r, M - 1)) * K;
        v[r].x += w0 * to_f(xr[i0]);
        v[r].y += w1 * to_f(xr[i1]);
      }
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int gm = m0 + m4 + 4 * r;
      if (gm < M)
        *reinterpret_cast<__nv_bfloat162*>(a.y + static_cast<size_t>(gm) * N + gn) =
            __floats2bfloat162_rn(v[r].x + b0, v[r].y + b1);
    }
  }
}

template <class W, int R>
cudaError_t launch_wgmma_r(const CUtensorMap& xm, const CUtensorMap& wm, const CUtensorMap& sm,
                           const WgmmaArgs& a, cudaStream_t stream) {
  auto kernel = linear_wgmma_kernel<W, R>;
  constexpr size_t smem = WgmmaSmem<W, R>::kBytes;
  static bool ready = false;  // the shared-memory opt-in, once per instantiation
  if (!ready) {
    const cudaError_t err = allow_smem(kernel, smem);
    if (err != cudaSuccess) return err;
    ready = true;
  }
  const dim3 grid((a.N + kTmaCols - 1) / kTmaCols, (a.M + R - 1) / R);
  kernel<<<grid, kTmaThreads, smem, stream>>>(xm, wm, sm, a);
  return cudaGetLastError();
}

// x rows a block takes (the wgmma N side), as fused_linear.TMA_ROWS lists them
inline bool tma_rows_ok(int R) {
  return R == 32 || R == 64 || R == 128 || R == 192 || R == 256;
}

// x (M, K) by xm, the weight by wm, a packed weight's scales by sm (read
// only when a.uniform)
template <class W>
cudaError_t launch_wgmma(int R, const CUtensorMap& xm, const CUtensorMap& wm,
                         const CUtensorMap& sm, const WgmmaArgs& a, cudaStream_t s) {
  switch (R) {
    case 32: return launch_wgmma_r<W, 32>(xm, wm, sm, a, s);
    case 64: return launch_wgmma_r<W, 64>(xm, wm, sm, a, s);
    case 128: return launch_wgmma_r<W, 128>(xm, wm, sm, a, s);
    case 192: return launch_wgmma_r<W, 192>(xm, wm, sm, a, s);
    case 256: return launch_wgmma_r<W, 256>(xm, wm, sm, a, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace rt
