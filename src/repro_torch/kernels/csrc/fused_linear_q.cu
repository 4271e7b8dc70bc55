// Fused dequant x matmul + NeuroAda bypass on a packed (int8 or NF4) frozen
// base: the forward of every adapted projection when training on a
// quantized base, and every base matmul of a serving step on one (k = 0):
//   y[m, n] = sum_c x[m, c] * deq(c, n) + sum_j val[j, n] * x[m, idx[j, n]] (+ b[n])
//   deq(c, n) = code(c, n) * scales[c / block, n]   (float32, cast to x's dtype)
// with float32 accumulation and one cast to x's dtype at the end.
//
// Replaces the TPU kernel src/repro/kernels/quant_linear.py:86
// fused_linear_q_pallas (body _fused_q_kernel, dequant _dequant_tile). That
// kernel dequantizes each 512-deep K tile in VMEM and needs K to divide by
// 512 and the tile by the scale block; qwen2-1.5b's wdown (K = 8960) does
// not. Here any M, N and K, any even block >= 2 (a tile may cross scale
// blocks: each row reads the scale row of its own global k).
//
// Four kernels, chosen by quant_linear.route before the launch:
//
// bf16 past the decode rows where TMA can describe x and the codes (K a
// multiple of 8, N of 16, x, codes and scales 16-byte aligned; the training
// rows and the serving mixed step, M = 2048): the Hopper mainloop of
// linear.cuh with PackedW below, tiles from fused_linear.linear_plan.
// Bound: operations at M = 2048, as fused_linear (2 * 2048 * 46.8 M flops a
// qwen2-1.5b layer, 0.194 ms of bf16 tensor work), while the codes are 50 /
// 25 % of the dense weight's bytes. What it does about the four limits of
// the tiled WMMA kernel below:
// - tensor path: wgmma m64nRk16 with A from registers and B (x) from the
//   swizzled stage, one group in flight, as fused_linear.cu's;
// - the dequantize in series: each thread dequantizes tile t's codes into
//   its own A fragments while tile t - 1's products run, with no shared
//   tile, barrier or proxy fence between the two (the tiled kernel
//   dequantized into one bf16 tile between two block barriers, then
//   reloaded it through load_matrix_sync), and a tile's weight columns are
//   dequantized once for R = 192 rows, not 128;
// - waves and the bypass: the tiles and the gather warps of fused_linear.cu.
// The tensor maps of x, the codes and the scales are encoded on the host per
// call.
//
// bf16, decode rows (M <= 16, rt_fused_linear_q_skinny). Bound: bytes. One
// layer of qwen2-1.5b reads 49.7 MB of int8 codes (26.3 MB NF4) plus 4
// bytes of scale per block column, 15 (8) us on an H100, while the product
// is 2 * 8 * 46.8 M flops. A 128 x 128 tile would leave 15/16 of the tensor
// work as padding and 2-70 blocks on 132 SMs. Design: swap A and B of
// mma.sync.m16n8k16, so the dequantized W^T is A (16 output columns x 16 K)
// and x^T is B (16 K x 8 rows): the 8 decode rows fill the n = 8 side
// exactly (M up to 16 takes two n-tiles). A fragment register holds rows k
// and k + 1 of one column, which is one NF4 byte (low nibble row 2i, high
// nibble 2i + 1) or the same byte of two int8 rows. A thread reads 16
// columns of a packed row in one 16-byte load (int8: rows k0 + 2t, +1, +8,
// +9; NF4: packed rows k0/2 + t, +4, for lane = 4g + t), each byte once,
// and its 16 columns feed the A rows g and g + 8 of 8 mmas (mma j takes
// columns 2j and 2j + 1), so a warp covers 128 columns x 16 K a step with
// no shared memory. Dequantize in registers with the plain version's
// arithmetic: int8 through a byte permute (2^23 + code + 128 as float bits,
// minus 2^23 + 128: exact, no I2F), NF4 through a 16-float codebook in
// shared memory; times the scale in float32, one rounding to bf16. (A
// CUDA-core FMA version would issue the same dequantize work plus 8 FMAs a
// code; on the tensor cores the product costs 8 mmas a 16-row step.) A block
// of 8 warps owns 128 columns and one K chunk; its warps take the chunk's
// 16-row steps in turn, loading step s + 8 (codes, scales, x) into
// registers while step s is dequantized, and reduce over warps in shared
// memory in warp order. The K chunks are a second grid axis sized by
// quant_linear.skinny_split: one wave of blocks (two an SM), every warp a
// step, at most 16 chunks; chunks are multiples of 16 rows, so a chunk
// starts at an even row and no NF4 byte straddles two. The chunks of a
// column tile run as one thread-block cluster and sum their partials
// through distributed shared memory in chunk order, each rank finishing a
// share of the tile (bypass and bias through finish(), one cast): one
// launch a projection, no global partials, no atomics, the same bits on
// every call. (A second, summing kernel measured the same kernel time on
// the card and doubles the launches of a decode step, whose loop is bound
// by the host; so does a last-block-reduces tail behind an atomic counter,
// which measured slower.) Registers (-Xptxas=-v): at M <= 8 int8 127-128,
// NF4 103-117 (launch bound 128: two blocks an SM), at M <= 16 147-199 (one
// block an SM); no spills. 38 KB of static shared memory at M <= 8, 42 KB
// at M <= 16 (warp reduction, partial tile, codebook).
//
// bf16 past the decode rows on shapes TMA cannot describe (K = 78 or
// 1002, N = 129 or 264, a misaligned pointer): the first version, built on
// fused_linear.cu:
// - the dense weight never exists in device memory: each K tile's packed
//   codes (int8 (32, 128) or NF4 uint8 (16, 128)) land in shared memory by
//   cp.async (plain loads when rows are not 16-byte aligned), 2 stages deep;
//   each thread loads its row's scales into registers before waiting on
//   the tile, then dequantizes its codes in shared memory to the compute
//   dtype (code * scale in float32, one rounding to bf16 — the plain
//   version's arithmetic);
// - a K tile starts at an even row, so NF4 nibble pairs never straddle
//   tiles, and rows 2i and 2i + 1 share a scale block (block is even);
// - rows at or past K dequantize to 0 (NF4 code 0 is -1, not 0);
// - the NF4 codebook sits in shared memory (16 floats, copied from
//   __constant__ at block start: per-thread indices would serialize reads
//   of constant memory);
// - WMMA 16x16x16 fragments with float32 accumulators (128x128 block tile,
//   8 warps of 64x32), as the WMMA kernel of fused_linear.cu.
//
// float32 (the reduced card-vs-CPU runs): plain FMA (64x64 tile, 4x4 per
// thread), a true float32 product (no TF32).
//
// k = 0 (no bypass: the serving base matmul) skips the bypass loop; idx and
// val may then be null.
#include <cooperative_groups.h>
#include <mma.h>

#include "linear.cuh"
#include "mma.cuh"

enum { RT_Q_INT8 = 0, RT_Q_NF4 = 1 };

namespace {

using namespace nvcuda;
using namespace rt;
namespace cg = cooperative_groups;

__constant__ float kNF4[16] = {
    -1.0f, -0.6961928009986877f, -0.5250730514526367f, -0.39491748809814453f,
    -0.28444138169288635f, -0.18477343022823334f, -0.09105003625154495f, 0.0f,
    0.07958029955625534f, 0.16093020141124725f, 0.24611230194568634f,
    0.33791524171829224f, 0.44070982933044434f, 0.5626170039176941f,
    0.7229568362236023f, 1.0f};

// Packed rows of a K tile of `rows` logical rows.
template <int QT>
__host__ __device__ constexpr int packed_rows(int rows) {
  return QT == RT_Q_NF4 ? rows / 2 : rows;
}

// ------------------------------------------------------------- bf16, WMMA

// dequant work per thread: int8 one row x 16 columns; NF4 one packed row
// (two logical rows) x 8 columns
constexpr int kColsI8 = 16, kColsNF4 = 8;

// The packed codes of K tile k0: packed rows k0/p .. of `prows` in all.
template <int QT, bool VEC>
__device__ __forceinline__ void load_codes(uint8_t (*Bq)[BN], const uint8_t* __restrict__ data,
                                           int n0, int k0, int N, int K) {
  const int tid = threadIdx.x;
  constexpr int kRows = packed_rows<QT>(BK);
  const int p0 = QT == RT_Q_NF4 ? k0 / 2 : k0;
  const int prows = QT == RT_Q_NF4 ? K / 2 : K;
  if (VEC) {
    if (tid < kRows * (BN / 16)) {  // rows x 8 chunks of 16 bytes
      const int r = tid / (BN / 16), nc = (tid % (BN / 16)) * 16;
      const int gp = p0 + r, gn = n0 + nc;
      const bool ok = gp < prows && gn < N;
      cp_async16(&Bq[r][nc], ok ? data + static_cast<size_t>(gp) * N + gn : data, ok);
    }
  } else {
    for (int e = tid; e < kRows * BN; e += kThreadsTC) {
      const int r = e / BN, nc = e % BN;
      const int gp = p0 + r, gn = n0 + nc;
      Bq[r][nc] = (gp < prows && gn < N) ? data[static_cast<size_t>(gp) * N + gn] : 0;
    }
  }
}

// This thread's slice of tile k0: its (first) logical row and columns.
template <int QT>
__device__ __forceinline__ void dequant_slot(int& r, int& c) {
  const int tid = threadIdx.x;
  if (QT == RT_Q_NF4) {
    r = 2 * (tid / (BN / kColsNF4));
    c = (tid % (BN / kColsNF4)) * kColsNF4;
  } else {
    r = tid / (BN / kColsI8);
    c = (tid % (BN / kColsI8)) * kColsI8;
  }
}

// Scales of this thread's row(s) in tile k0, into registers (0 past K or N).
template <int QT>
__device__ __forceinline__ void load_scales(float* s, const float* __restrict__ scales,
                                            int n0, int k0, int N, int K, int block) {
  constexpr int kCols = QT == RT_Q_NF4 ? kColsNF4 : kColsI8;
  int r, c;
  dequant_slot<QT>(r, c);
  const int gk = k0 + r;  // NF4: rows gk and gk + 1 share a block (both even-aligned)
  const float* srow = scales + static_cast<size_t>(gk / block) * N;
#pragma unroll
  for (int i = 0; i < kCols; ++i) {
    const int gn = n0 + c + i;
    s[i] = (gk < K && gn < N) ? __ldg(srow + gn) : 0.f;
  }
}

// Packed codes x register scales -> bf16 tile Bs (rows past K are 0: their
// scales were loaded as 0 and codes x 0 = 0, NF4's -1 included).
template <int QT>
__device__ __forceinline__ void dequant_tile(__nv_bfloat16 (*Bs)[B_LD], const uint8_t (*Bq)[BN],
                                             const float* s, const float* nf4) {
  int r, c;
  dequant_slot<QT>(r, c);
  if (QT == RT_Q_NF4) {
#pragma unroll
    for (int i = 0; i < kColsNF4; ++i) {
      const uint8_t b = Bq[r / 2][c + i];
      Bs[r][c + i] = __float2bfloat16(nf4[b & 0xF] * s[i]);
      Bs[r + 1][c + i] = __float2bfloat16(nf4[b >> 4] * s[i]);
    }
  } else {
#pragma unroll
    for (int i = 0; i < kColsI8; ++i) {
      const float q = static_cast<float>(static_cast<int8_t>(Bq[r][c + i]));
      Bs[r][c + i] = __float2bfloat16(q * s[i]);
    }
  }
}

template <int QT, typename TV, bool VEC>
__global__ void __launch_bounds__(kThreadsTC)
    fused_linear_q_bf16_kernel(const __nv_bfloat16* __restrict__ x,
                               const uint8_t* __restrict__ data,
                               const float* __restrict__ scales,
                               const int32_t* __restrict__ idx, const TV* __restrict__ val,
                               const __nv_bfloat16* __restrict__ bias,
                               __nv_bfloat16* __restrict__ y, int M, int N, int K, int k,
                               int block) {
  // the epilogue's per-warp staging reuses As once the main loop is done
  __shared__ __align__(128) __nv_bfloat16 As[2][BM][A_LD];
  __shared__ __align__(128) __nv_bfloat16 Bs[BK][B_LD];
  __shared__ __align__(16) uint8_t Bq[2][packed_rows<QT>(BK)][BN];
  __shared__ float nf4[16];
  static_assert(sizeof(As) >= kThreadsTC / 32 * 256 * sizeof(float), "epilogue staging");

  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = warp / (BN / WN), wn = warp % (BN / WN);
  if (threadIdx.x < 16) nf4[threadIdx.x] = kNF4[threadIdx.x];

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[WM / 16][WN / 16];
#pragma unroll
  for (int i = 0; i < WM / 16; ++i)
#pragma unroll
    for (int j = 0; j < WN / 16; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  float s[QT == RT_Q_NF4 ? kColsNF4 : kColsI8];
  const int n_tiles = (K + BK - 1) / BK;
  load_x_tile<VEC>(As[0], x, m0, 0, M, K);
  load_codes<QT, VEC>(Bq[0], data, n0, 0, N, K);
  cp_async_commit();
  for (int t = 0; t < n_tiles; ++t) {
    const int st = t & 1;
    load_scales<QT>(s, scales, n0, t * BK, N, K, block);
    if (t + 1 < n_tiles) {
      load_x_tile<VEC>(As[st ^ 1], x, m0, (t + 1) * BK, M, K);
      load_codes<QT, VEC>(Bq[st ^ 1], data, n0, (t + 1) * BK, N, K);
    }
    cp_async_commit();
    cp_async_wait_1();  // tile t has landed; tile t + 1 may still be in flight
    __syncthreads();
    dequant_tile<QT>(Bs, Bq[st], s, nf4);
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a[WM / 16];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> b[WN / 16];
#pragma unroll
      for (int i = 0; i < WM / 16; ++i)
        wmma::load_matrix_sync(a[i], &As[st][wm * WM + i * 16][kk], A_LD);
#pragma unroll
      for (int j = 0; j < WN / 16; ++j)
        wmma::load_matrix_sync(b[j], &Bs[kk][wn * WN + j * 16], B_LD);
#pragma unroll
      for (int i = 0; i < WM / 16; ++i)
#pragma unroll
        for (int j = 0; j < WN / 16; ++j) wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
    }
    __syncthreads();  // stage st and Bs are free before they are refilled
  }

  float* sc = reinterpret_cast<float*>(&As[0][0][0]) + warp * 256;
#pragma unroll
  for (int i = 0; i < WM / 16; ++i) {
#pragma unroll
    for (int j = 0; j < WN / 16; ++j) {
      wmma::store_matrix_sync(sc, acc[i][j], 16, wmma::mem_row_major);
      __syncwarp();
      for (int e = lane; e < 256; e += 32) {
        const int m = m0 + wm * WM + i * 16 + e / 16;
        const int n = n0 + wn * WN + j * 16 + e % 16;
        if (m < M && n < N) finish(sc[e], x, idx, val, bias, y, m, n, K, N, k);
      }
      __syncwarp();
    }
  }
}

// ------------------------------------------- bf16, decode rows (split K)

constexpr int kSkCols = 128;  // columns of a block: 8 lane groups x 16 bytes
constexpr int kSkWarps = 8, kSkThreads = 32 * kSkWarps;
constexpr int kSkStep = 16;   // K rows of one mma, one warp step
constexpr int kSkMaxSplit = 16;  // K chunks of a column tile: Hopper's largest cluster

// 16 bytes of packed row `prow` at columns n..n+15, zeros past the edges;
// VEC (N % 16 == 0, 16-byte aligned data): one streaming load.
template <bool VEC>
__device__ __forceinline__ uint4 load_codes16(const uint8_t* __restrict__ data, int prow,
                                              int prows, int n, int N) {
  uint4 r = make_uint4(0u, 0u, 0u, 0u);
  if (prow >= prows || n >= N) return r;
  const uint8_t* p = data + static_cast<size_t>(prow) * N + n;
  if (VEC) {
    asm("ld.global.nc.L1::no_allocate.v4.u32 {%0,%1,%2,%3}, [%4];\n"
        : "=r"(r.x), "=r"(r.y), "=r"(r.z), "=r"(r.w) : "l"(p));
    return r;
  }
  uint32_t w[4] = {0u, 0u, 0u, 0u};
  for (int i = 0; i < 16 && n + i < N; ++i) w[i / 4] |= static_cast<uint32_t>(p[i]) << (8 * (i % 4));
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// 16 scales of scale row `srow` at columns n..n+15 (0 past N, or all 0 when
// the row is not valid).
template <bool VEC>
__device__ __forceinline__ void load_scales16(float (&s)[16], const float* __restrict__ scales,
                                              int srow, bool valid, int n, int N) {
  const float* p = scales + static_cast<size_t>(srow) * N + n;
  if (VEC && valid && n < N) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float4 v = __ldg(reinterpret_cast<const float4*>(p) + i);
      s[4 * i] = v.x;
      s[4 * i + 1] = v.y;
      s[4 * i + 2] = v.z;
      s[4 * i + 3] = v.w;
    }
    return;
  }
#pragma unroll
  for (int i = 0; i < 16; ++i) s[i] = (valid && n + i < N) ? __ldg(p + i) : 0.f;
}

// x[m, k], x[m, k + 1] as one B-fragment register (zeros past M and K).
__device__ __forceinline__ uint32_t x_pair(const __nv_bfloat16* __restrict__ x, int m, int k,
                                           int M, int K, bool xvec) {
  if (m >= M || k >= K) return 0u;
  const __nv_bfloat16* p = x + static_cast<size_t>(m) * K + k;
  if (xvec) return __ldg(reinterpret_cast<const unsigned int*>(p));
  const uint32_t lo = __bfloat16_as_ushort(p[0]);
  const uint32_t hi = k + 1 < K ? __bfloat16_as_ushort(p[1]) : 0u;
  return lo | (hi << 16);
}

__device__ __forceinline__ uint32_t word(const uint4& u, int i) {
  return i == 0 ? u.x : i == 1 ? u.y : i == 2 ? u.z : u.w;
}

// One thread's share of a 16-row step: its packed codes (int8 rows k0+2t,
// +1, +8, +9; NF4 packed rows k0/2+t, +4, 16 columns each), the scales when
// the step lies in one scale block (UNIFORM), and x's B fragments.
template <int QT, int MT, bool UNIFORM>
struct SkStage {
  uint4 code[QT == RT_Q_NF4 ? 2 : 4];
  float sc[UNIFORM ? 16 : 1];
  uint32_t xb[MT][2];
};

template <int QT, int MT, bool UNIFORM, bool VEC>
__device__ __forceinline__ void sk_load(SkStage<QT, MT, UNIFORM>& st,
                                        const __nv_bfloat16* __restrict__ x,
                                        const uint8_t* __restrict__ data,
                                        const float* __restrict__ scales, int k0, int nt, int M,
                                        int N, int K, int block, bool xvec) {
  const int lane = threadIdx.x & 31, gr = lane >> 2, t4 = lane & 3;
  if (QT == RT_Q_NF4) {
    const int pa = k0 / 2 + t4;
    st.code[0] = load_codes16<VEC>(data, pa, K / 2, nt, N);
    st.code[1] = load_codes16<VEC>(data, pa + 4, K / 2, nt, N);
  } else {
    const int ra = k0 + 2 * t4;
#pragma unroll
    for (int i = 0; i < 4; ++i)
      st.code[i] = load_codes16<VEC>(data, ra + (i >> 1) * 8 + (i & 1), K, nt, N);
  }
  if constexpr (UNIFORM) load_scales16<VEC>(st.sc, scales, k0 / block, true, nt, N);
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    st.xb[mt][0] = x_pair(x, mt * 8 + gr, k0 + 2 * t4, M, K, xvec);
    st.xb[mt][1] = x_pair(x, mt * 8 + gr, k0 + 2 * t4 + 8, M, K, xvec);
  }
}

// bf16 pair (rows k, k + 1) of column c of one slot: int8 from two code
// rows, NF4 from one packed row; code * scale in float32, one rounding.
template <int QT>
__device__ __forceinline__ uint32_t sk_deq(const uint4& lo, const uint4& hi, int c, float s,
                                           const float* nf4) {
  if (QT == RT_Q_NF4) {
    const uint32_t b = (word(lo, c >> 2) >> (8 * (c & 3))) & 0xFFu;
    return pack_bf16(nf4[b & 0xF] * s, nf4[b >> 4] * s);
  }
  const uint32_t sel = 0x7440u + (c & 3);
  const float f0 = __int_as_float(__byte_perm(word(lo, c >> 2) ^ 0x80808080u, 0x4B000000u, sel));
  const float f1 = __int_as_float(__byte_perm(word(hi, c >> 2) ^ 0x80808080u, 0x4B000000u, sel));
  return pack_bf16((f0 - 8388736.f) * s, (f1 - 8388736.f) * s);
}

// One 16-row step: dequantize the stage's codes into the A fragments of 8
// mmas (mma j takes columns 2j and 2j + 1 of the thread's 16) and multiply
// by x's B fragments.
template <int QT, int MT, bool UNIFORM, bool VEC>
__device__ __forceinline__ void sk_step(const SkStage<QT, MT, UNIFORM>& st,
                                        float (&acc)[MT][8][4], const float* __restrict__ scales,
                                        int k0, int nt, int N, int K, int block,
                                        const float* nf4) {
  const int t4 = threadIdx.x & 3;
  const int ra = k0 + 2 * t4, rb = ra + 8;  // the even row of each slot's pair
  float sa[16], sb[16];
  if constexpr (UNIFORM) {
#pragma unroll
    for (int i = 0; i < 16; ++i) sa[i] = sb[i] = st.sc[i];
  } else {  // the two slots may sit in different scale blocks
    load_scales16<VEC>(sa, scales, ra / block, ra < K, nt, N);
    load_scales16<VEC>(sb, scales, rb / block, rb < K, nt, N);
  }
  // NF4 code 0 is -1: rows at or past K must give 0, not -scale
  const bool va = QT != RT_Q_NF4 || ra < K, vb = QT != RT_Q_NF4 || rb < K;
  const uint4& a_lo = st.code[0];
  const uint4& a_hi = st.code[QT == RT_Q_NF4 ? 0 : 1];
  const uint4& b_lo = st.code[QT == RT_Q_NF4 ? 1 : 2];
  const uint4& b_hi = st.code[QT == RT_Q_NF4 ? 1 : 3];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    uint32_t a[4];
    a[0] = va ? sk_deq<QT>(a_lo, a_hi, 2 * j, sa[2 * j], nf4) : 0u;
    a[1] = va ? sk_deq<QT>(a_lo, a_hi, 2 * j + 1, sa[2 * j + 1], nf4) : 0u;
    a[2] = vb ? sk_deq<QT>(b_lo, b_hi, 2 * j, sb[2 * j], nf4) : 0u;
    a[3] = vb ? sk_deq<QT>(b_lo, b_hi, 2 * j + 1, sb[2 * j + 1], nf4) : 0u;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) mma_bf16(acc[mt][j], a, st.xb[mt][0], st.xb[mt][1]);
  }
}

// grid (ceil(N / 128), n_split), launched as clusters of (1, n_split): the
// n_split blocks of a column tile, one per K chunk, share one cluster. Each
// block's 8 warps take its chunk's 16-row steps in turn, each loading step
// s + 8 into registers while it dequantizes step s; their sums meet in
// shared memory in warp order, giving the block's (M, 128) float32 partial.
// After a cluster barrier, rank r of the cluster sums its share of the
// tile's elements over ranks 0..n_split-1, in rank order, from the ranks'
// shared memory (no global partials, no atomics: the same bits on every
// call), adds the bypass and bias (finish) and writes y.
template <int QT, int MT, bool UNIFORM, bool VEC, typename TV>
__global__ void __launch_bounds__(kSkThreads, MT == 1 ? 2 : 1)
    fused_linear_q_skinny_kernel(const __nv_bfloat16* __restrict__ x,
                                 const uint8_t* __restrict__ data,
                                 const float* __restrict__ scales,
                                 const int32_t* __restrict__ idx, const TV* __restrict__ val,
                                 const __nv_bfloat16* __restrict__ bias,
                                 __nv_bfloat16* __restrict__ y, int M, int N, int K, int k,
                                 int block, int k_chunk, int xvec) {
  __shared__ float red[kSkWarps][32][33];  // (warp, accumulator, lane), padded rows
  __shared__ float tile[8 * MT][kSkCols];  // this block's partial
  __shared__ float nf4[16];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int n0 = blockIdx.x * kSkCols, nt = n0 + 16 * (lane >> 2);  // this thread's 16 columns
  const int kc0 = blockIdx.y * k_chunk;
  const int steps = (min(K, kc0 + k_chunk) - kc0 + kSkStep - 1) / kSkStep;
  if (threadIdx.x < 16) nf4[threadIdx.x] = kNF4[threadIdx.x];
  __syncthreads();

  float acc[MT][8][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[mt][j][0] = acc[mt][j][1] = acc[mt][j][2] = acc[mt][j][3] = 0.f;
  SkStage<QT, MT, UNIFORM> cur, nxt;
  if (warp < steps)
    sk_load<QT, MT, UNIFORM, VEC>(cur, x, data, scales, kc0 + warp * kSkStep, nt, M, N, K,
                                  block, xvec);
  for (int s = warp; s < steps; s += kSkWarps) {
    const int k0 = kc0 + s * kSkStep;
    if (s + kSkWarps < steps)  // the next step's loads fly while this one is dequantized
      sk_load<QT, MT, UNIFORM, VEC>(nxt, x, data, scales, k0 + kSkWarps * kSkStep, nt, M, N,
                                    K, block, xvec);
    sk_step<QT, MT, UNIFORM, VEC>(cur, acc, scales, k0, nt, N, K, block, nf4);
    cur = nxt;
  }

  // accumulator (mt, j, e) of lane 4g + t is column 16g + 2j + (e >> 1) of
  // the block and row mt * 8 + 2t + (e & 1)
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) red[warp][j * 4 + e][lane] = acc[mt][j][e];
    __syncthreads();
    for (int i = threadIdx.x; i < 8 * kSkCols; i += kSkThreads) {
      const int r = i / kSkCols, col = i % kSkCols;
      const int ln = (col >> 4) * 4 + (r >> 1), e = ((col & 15) >> 1) * 4 + (col & 1) * 2 + (r & 1);
      float v = 0.f;
#pragma unroll
      for (int w = 0; w < kSkWarps; ++w) v += red[w][e][ln];
      tile[mt * 8 + r][col] = v;
    }
    __syncthreads();
  }
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();  // every chunk's partial is in its block's shared memory
  const int n_split = gridDim.y, rank = blockIdx.y;
  const int elems = min(M, 8 * MT) * kSkCols;
  const int per = (elems + n_split - 1) / n_split;
  for (int i = rank * per + threadIdx.x; i < min(elems, (rank + 1) * per); i += kSkThreads) {
    const int m = i / kSkCols, col = i % kSkCols;
    if (n0 + col >= N) continue;
    float t[kSkMaxSplit];  // every rank's value in flight at once
#pragma unroll
    for (int q = 0; q < kSkMaxSplit; ++q)
      t[q] = q < n_split ? cluster.map_shared_rank(&tile[0][0], q)[m * kSkCols + col] : 0.f;
    float v = 0.f;
#pragma unroll
    for (int q = 0; q < kSkMaxSplit; ++q) v += t[q];  // chunk order (+0 past n_split)
    finish(v, x, idx, val, bias, y, m, n0 + col, K, N, k);
  }
  cluster.sync();  // no block leaves while another still reads its partial
}

template <int QT, int MT, bool UNIFORM, bool VEC, typename TV>
cudaError_t launch_skinny_main(const void* x, const void* data, const void* scales,
                               const void* idx, const void* val, const void* bias, void* y,
                               int M, int N, int K, int k, int block, int k_chunk, int n_split,
                               bool xvec, cudaStream_t stream) {
  auto kernel = fused_linear_q_skinny_kernel<QT, MT, UNIFORM, VEC, TV>;
  if (n_split > 8) {  // clusters of more than 8 blocks are Hopper's non-portable sizes
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return err;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((N + kSkCols - 1) / kSkCols, n_split);
  cfg.blockDim = dim3(kSkThreads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = n_split;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, static_cast<const __nv_bfloat16*>(x),
                            static_cast<const uint8_t*>(data), static_cast<const float*>(scales),
                            static_cast<const int32_t*>(idx), static_cast<const TV*>(val),
                            static_cast<const __nv_bfloat16*>(bias),
                            static_cast<__nv_bfloat16*>(y), M, N, K, k, block, k_chunk,
                            static_cast<int>(xvec));
}

template <int QT, int MT, typename TV>
cudaError_t launch_skinny_mt(bool uniform, bool vec, const void* x, const void* data,
                             const void* scales, const void* idx, const void* val,
                             const void* bias, void* y, int M, int N, int K, int k, int block,
                             int k_chunk, int n_split, bool xvec, cudaStream_t s) {
#define RT_SK(U, V)                                                                          \
  if (uniform == U && vec == V)                                                              \
    return launch_skinny_main<QT, MT, U, V, TV>(x, data, scales, idx, val, bias, y, M, N, K, \
                                                k, block, k_chunk, n_split, xvec, s);
  RT_SK(true, true) RT_SK(true, false) RT_SK(false, true) RT_SK(false, false)
#undef RT_SK
  return cudaErrorInvalidValue;
}

template <int QT>
cudaError_t launch_skinny(const void* x, const void* data, const void* scales, const void* idx,
                          const void* val, const void* bias, void* y, int M, int N, int K,
                          int k, int block, int v_dtype, int k_chunk, int n_split,
                          cudaStream_t stream) {
  if (M < 1 || M > 16 || k_chunk < kSkStep || k_chunk % kSkStep || n_split < 1 ||
      n_split > kSkMaxSplit || static_cast<long>(k_chunk) * n_split < K ||
      static_cast<long>(k_chunk) * (n_split - 1) >= K)
    return cudaErrorInvalidConfiguration;
  const bool vec = N % 16 == 0 && (reinterpret_cast<uintptr_t>(data) & 15) == 0 &&
                   (reinterpret_cast<uintptr_t>(scales) & 15) == 0;
  const bool xvec = K % 2 == 0 && (reinterpret_cast<uintptr_t>(x) & 3) == 0;
  // a 16-row step lies in one scale block when the block is a multiple of 16
  const bool uniform = block % kSkStep == 0;
  if (v_dtype == RT_F32)
    return M <= 8 ? launch_skinny_mt<QT, 1, float>(uniform, vec, x, data, scales, idx, val,
                                                   bias, y, M, N, K, k, block, k_chunk,
                                                   n_split, xvec, stream)
                  : launch_skinny_mt<QT, 2, float>(uniform, vec, x, data, scales, idx, val,
                                                   bias, y, M, N, K, k, block, k_chunk,
                                                   n_split, xvec, stream);
  return M <= 8 ? launch_skinny_mt<QT, 1, __nv_bfloat16>(uniform, vec, x, data, scales, idx,
                                                         val, bias, y, M, N, K, k, block,
                                                         k_chunk, n_split, xvec, stream)
                : launch_skinny_mt<QT, 2, __nv_bfloat16>(uniform, vec, x, data, scales, idx,
                                                         val, bias, y, M, N, K, k, block,
                                                         k_chunk, n_split, xvec, stream);
}

// ---------------------------------------------------------- float32, FMA

template <int QT, typename TV>
__global__ void __launch_bounds__(kThreadsF)
    fused_linear_q_f32_kernel(const float* __restrict__ x, const uint8_t* __restrict__ data,
                              const float* __restrict__ scales,
                              const int32_t* __restrict__ idx, const TV* __restrict__ val,
                              const float* __restrict__ bias, float* __restrict__ y, int M,
                              int N, int K, int k, int block) {
  __shared__ float As[FK][FM + 4];  // As[c][m]: x tile, transposed
  __shared__ float Bs[FK][FN];      // dequantized weight tile
  __shared__ float nf4[16];
  const int m0 = blockIdx.y * FM, n0 = blockIdx.x * FN;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  if (tid < 16) nf4[tid] = kNF4[tid];
  float acc[4][4] = {};
  for (int k0 = 0; k0 < K; k0 += FK) {
    for (int e = tid; e < FM * FK; e += kThreadsF) {
      const int r = e / FK, c = e % FK;
      const int gm = m0 + r, gk = k0 + c;
      As[c][r] = (gm < M && gk < K) ? x[static_cast<size_t>(gm) * K + gk] : 0.f;
    }
    __syncthreads();  // nf4 is visible before its first read
    for (int e = tid; e < FK * FN; e += kThreadsF) {
      const int r = e / FN, c = e % FN;
      const int gk = k0 + r, gn = n0 + c;
      float w = 0.f;
      if (gk < K && gn < N) {
        const float sc = __ldg(scales + static_cast<size_t>(gk / block) * N + gn);
        if (QT == RT_Q_NF4) {
          const uint8_t b = data[static_cast<size_t>(gk / 2) * N + gn];
          w = nf4[(gk & 1) ? (b >> 4) : (b & 0xF)] * sc;
        } else {
          w = static_cast<float>(reinterpret_cast<const int8_t*>(data)[
                  static_cast<size_t>(gk) * N + gn]) * sc;
        }
      }
      Bs[r][c] = w;
    }
    __syncthreads();
#pragma unroll
    for (int c = 0; c < FK; ++c) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[c][ty * 4 + i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = Bs[c][tx * 4 + j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int m = m0 + ty * 4 + i, n = n0 + tx * 4 + j;
      if (m < M && n < N) finish(acc[i][j], x, idx, val, bias, y, m, n, K, N, k);
    }
  }
}

// ------------------------------------------------- bf16, TMA + wgmma

// The weight operand of the Hopper mainloop on a packed base: the codes of
// a 64-row K tile by TMA with the 128-byte swizzle, (64, 128) int8 or
// (32, 128) NF4 bytes (a tile starts at an even row, so no NF4 byte
// straddles two), and, when one scale row serves the whole tile (`uniform`:
// the block a multiple of 64), that row by TMA into the stage's slot of a
// small ring. Each consumer thread dequantizes its two columns col, col + 1
// (A rows g and g + 8 of its warp) of the tile straight into the wgmma A
// fragments, 4 registers a 16-deep step: code * scale in float32, one
// rounding to bf16 (the plain version's arithmetic). A fragment register
// holds rows k, k + 1 of one column: two int8 code rows, or one NF4 byte
// (low nibble row k). Its reads are 2-byte loads of columns col, col + 1 of
// one code row (int8: rows k, k + 1, k + 8, k + 9 of a step; NF4: packed
// rows k / 2, + 4), which the swizzle keeps free of bank conflicts. Each row
// takes the scale row of its own global k (any even block: a tile may cross
// scale blocks, whose rows are then read from global memory). Rows at or
// past K give 0: NF4's code 0 is -1, and the codes' zero fill past the end
// must not count; only a tile at the edge of the weight takes that branch.
template <int QT>
struct PackedW {
  static constexpr bool kDequant = true;
  static constexpr int kPRows = QT == RT_Q_NF4 ? kTmaBK / 2 : kTmaBK;  // packed rows a tile
  static constexpr int kStageBytes = kPRows * kTmaCols;
  static constexpr int kScaleBytes = kTmaCols * 4;  // one float32 scale row
  __device__ static float code(int i) { return QT == RT_Q_NF4 ? kNF4[i] : 0.f; }
  __device__ static void load(uint8_t* dst, const CUtensorMap* map, uint64_t* bar, int n0,
                              int t) {
    tma_load_2d(dst, map, bar, n0, t * kPRows);
  }
  // bytes (row r, col) and (r, col + 1) of the swizzled code tile, col even
  __device__ static uint32_t pair(const uint8_t* codes, int r, int col) {
    return *reinterpret_cast<const uint16_t*>(codes + r * kTmaCols +
                                              ((((col >> 4) ^ (r & 7))) << 4) + (col & 15));
  }
  // int8 code byte `sel` (0 or 1) of a pair as a float, exactly: 2^23 + code +
  // 128 as float bits, minus 2^23 + 128 (as the decode-row kernel)
  __device__ static float code8(uint32_t pr, int sel) {
    return __int_as_float(__byte_perm(pr ^ 0x8080u, 0x4B000000u, 0x7440u + sel)) - 8388736.f;
  }
  __device__ static void fragments(uint32_t (&f)[kTmaBK / 16][4], const uint8_t* codes,
                                   const float* srow, const float* nf4, const WgmmaArgs& a,
                                   int t, int n0, int col, int t4) {
    // an interior tile with one scale row (all but the last K tile and column
    // tile on the path shapes) takes the branch-free body
    if (a.uniform && (t + 1) * kTmaBK <= a.K && n0 + kTmaCols <= a.N)
      frag<false>(f, codes, srow, nf4, a, t, n0, col, t4);
    else
      frag<true>(f, codes, srow, nf4, a, t, n0, col, t4);
  }
  template <bool EDGE>
  __device__ static void frag(uint32_t (&f)[kTmaBK / 16][4], const uint8_t* codes,
                              const float* srow, const float* nf4, const WgmmaArgs& a, int t,
                              int n0, int col, int t4) {
    const int k0 = t * kTmaBK, gn = n0 + col;
    const bool col_ok = gn < a.N;  // N % 16 == 0: both columns in, or both out
    float s0 = 0.f, s1 = 0.f;
    if (a.uniform) {
      const float2 sv = *reinterpret_cast<const float2*>(srow + col);
      s0 = sv.x;
      s1 = sv.y;
    }
#pragma unroll
    for (int ks = 0; ks < kTmaBK / 16; ++ks) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = 16 * ks + 2 * t4 + 8 * h;  // this register pair's rows r, r + 1
        if (EDGE) {
          if (!col_ok || k0 + r >= a.K) {  // K % 8 == 0: row r + 1 < K with r
            f[ks][2 * h] = f[ks][2 * h + 1] = 0u;
            continue;
          }
          if (!a.uniform) {
            const float2 sv = __ldg(reinterpret_cast<const float2*>(
                a.scales + static_cast<size_t>((k0 + r) / a.block) * a.N + gn));
            s0 = sv.x;
            s1 = sv.y;
          }
        }
        if (QT == RT_Q_NF4) {
          const uint32_t b = pair(codes, r / 2, col);  // col: rows r (low), r + 1; then col + 1
          f[ks][2 * h] = pack_bf16(nf4[b & 0xF] * s0, nf4[(b >> 4) & 0xF] * s0);
          f[ks][2 * h + 1] = pack_bf16(nf4[(b >> 8) & 0xF] * s1, nf4[(b >> 12) & 0xF] * s1);
        } else {
          const uint32_t lo = pair(codes, r, col), hi = pair(codes, r + 1, col);
          f[ks][2 * h] = pack_bf16(code8(lo, 0) * s0, code8(hi, 0) * s0);
          f[ks][2 * h + 1] = pack_bf16(code8(lo, 1) * s1, code8(hi, 1) * s1);
        }
      }
    }
  }
};

template <int QT>
cudaError_t launch_wgmma_q(const void* x, const void* data, const void* scales, const void* idx,
                           const void* val, const void* bias, void* y, int M, int N, int K,
                           int k, int block, int v_dtype, int tile_rows, cudaStream_t stream) {
  CUtensorMap xm, cm, sm;
  cudaError_t err = encode_x(&xm, x, M, K, tile_rows);
  if (err == cudaSuccess)
    err = encode_2d(&cm, CU_TENSOR_MAP_DATA_TYPE_UINT8, data, QT == RT_Q_NF4 ? K / 2 : K, N, 1,
                    PackedW<QT>::kPRows, kTmaCols, true);
  if (err == cudaSuccess)  // one scale row of the block's 128 columns a box
    err = encode_2d(&sm, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, scales, (K + block - 1) / block, N, 4,
                    1, kTmaCols, false);
  if (err != cudaSuccess) return err;
  const WgmmaArgs a{static_cast<const __nv_bfloat16*>(x), static_cast<const float*>(scales),
                    static_cast<const int32_t*>(idx), val,
                    static_cast<const __nv_bfloat16*>(bias), static_cast<__nv_bfloat16*>(y),
                    M, N, K, k, block, v_dtype == RT_F32, block % kTmaBK == 0};
  return launch_wgmma<PackedW<QT>>(tile_rows, xm, cm, sm, a, stream);
}

// ----------------------------------------------------------------- launch

template <int QT, typename TV>
cudaError_t launch_bf16(const void* x, const void* data, const void* scales, const void* idx,
                        const void* val, const void* bias, void* y, int M, int N, int K, int k,
                        int block, cudaStream_t stream) {
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  const bool vec = K % 8 == 0 && N % 16 == 0 && (reinterpret_cast<uintptr_t>(x) & 15) == 0 &&
                   (reinterpret_cast<uintptr_t>(data) & 15) == 0;
  auto xb = static_cast<const __nv_bfloat16*>(x);
  auto db = static_cast<const uint8_t*>(data);
  auto sb = static_cast<const float*>(scales);
  auto bb = static_cast<const __nv_bfloat16*>(bias);
  auto yb = static_cast<__nv_bfloat16*>(y);
  auto ib = static_cast<const int32_t*>(idx);
  auto vb = static_cast<const TV*>(val);
  if (vec)
    fused_linear_q_bf16_kernel<QT, TV, true>
        <<<grid, kThreadsTC, 0, stream>>>(xb, db, sb, ib, vb, bb, yb, M, N, K, k, block);
  else
    fused_linear_q_bf16_kernel<QT, TV, false>
        <<<grid, kThreadsTC, 0, stream>>>(xb, db, sb, ib, vb, bb, yb, M, N, K, k, block);
  return cudaGetLastError();
}

template <int QT, typename TV>
cudaError_t launch_f32(const void* x, const void* data, const void* scales, const void* idx,
                       const void* val, const void* bias, void* y, int M, int N, int K, int k,
                       int block, cudaStream_t stream) {
  dim3 grid((N + FN - 1) / FN, (M + FM - 1) / FM);
  fused_linear_q_f32_kernel<QT, TV><<<grid, kThreadsF, 0, stream>>>(
      static_cast<const float*>(x), static_cast<const uint8_t*>(data),
      static_cast<const float*>(scales), static_cast<const int32_t*>(idx),
      static_cast<const TV*>(val), static_cast<const float*>(bias), static_cast<float*>(y), M,
      N, K, k, block);
  return cudaGetLastError();
}

template <int QT>
cudaError_t dispatch(const void* x, const void* data, const void* scales, const void* idx,
                     const void* val, const void* bias, void* y, int M, int N, int K, int k,
                     int block, int x_dtype, int v_dtype, cudaStream_t s) {
  if (x_dtype == RT_BF16 && v_dtype == RT_BF16)
    return launch_bf16<QT, __nv_bfloat16>(x, data, scales, idx, val, bias, y, M, N, K, k,
                                          block, s);
  if (x_dtype == RT_BF16 && v_dtype == RT_F32)
    return launch_bf16<QT, float>(x, data, scales, idx, val, bias, y, M, N, K, k, block, s);
  if (x_dtype == RT_F32 && v_dtype == RT_BF16)
    return launch_f32<QT, __nv_bfloat16>(x, data, scales, idx, val, bias, y, M, N, K, k,
                                         block, s);
  if (x_dtype == RT_F32 && v_dtype == RT_F32)
    return launch_f32<QT, float>(x, data, scales, idx, val, bias, y, M, N, K, k, block, s);
  return cudaErrorInvalidValue;
}

}  // namespace

// data: int8 (K, N) or NF4 uint8 (K/2, N); scales float32 (ceil(K/block), N);
// idx/val (k, N), null when k = 0; bias may be null. x, bias and y share
// x_dtype; val has v_dtype (ignored when k = 0).
extern "C" int rt_fused_linear_q(const void* x, const void* data, const void* scales,
                                 const void* idx, const void* val, const void* bias, void* y,
                                 int M, int N, int K, int k, int block, int qdtype, int x_dtype,
                                 int v_dtype, void* stream) {
  if (block < 2 || block % 2 || K < 1 || k < 0 || (qdtype == RT_Q_NF4 && K % 2))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (qdtype == RT_Q_INT8)
    err = dispatch<RT_Q_INT8>(x, data, scales, idx, val, bias, y, M, N, K, k, block, x_dtype,
                              v_dtype, s);
  else if (qdtype == RT_Q_NF4)
    err = dispatch<RT_Q_NF4>(x, data, scales, idx, val, bias, y, M, N, K, k, block, x_dtype,
                             v_dtype, s);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}

// The decode-row kernel: x, bias and y bf16, M <= 16; K split in n_split
// <= 16 chunks of k_chunk rows (a multiple of 16, every row covered once),
// one cluster of n_split blocks per 128-column tile.
extern "C" int rt_fused_linear_q_skinny(const void* x, const void* data, const void* scales,
                                        const void* idx, const void* val, const void* bias,
                                        void* y, int M, int N, int K, int k, int block,
                                        int qdtype, int v_dtype, int k_chunk, int n_split,
                                        void* stream) {
  if (block < 2 || block % 2 || K < 1 || k < 0 || (qdtype == RT_Q_NF4 && K % 2) ||
      (v_dtype != RT_F32 && v_dtype != RT_BF16))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (qdtype == RT_Q_INT8)
    err = launch_skinny<RT_Q_INT8>(x, data, scales, idx, val, bias, y, M, N, K, k, block,
                                   v_dtype, k_chunk, n_split, s);
  else if (qdtype == RT_Q_NF4)
    err = launch_skinny<RT_Q_NF4>(x, data, scales, idx, val, bias, y, M, N, K, k, block,
                                  v_dtype, k_chunk, n_split, s);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}

// The Hopper route: x, bias and y bf16, M > 16; K % 8 == 0 and N % 16 == 0
// (TMA row strides), x, data and scales 16-byte aligned; tile_rows one of
// linear.cuh's tma_rows_ok. idx/val null when k = 0.
extern "C" int rt_fused_linear_q_wgmma(const void* x, const void* data, const void* scales,
                                       const void* idx, const void* val, const void* bias,
                                       void* y, int M, int N, int K, int k, int block,
                                       int qdtype, int v_dtype, int tile_rows, void* stream) {
  if (M < 1 || N < 1 || K < 1 || k < 0 || block < 2 || block % 2 || K % 8 || N % 16 ||
      !tma_rows_ok(tile_rows) || (reinterpret_cast<uintptr_t>(x) & 15) ||
      (reinterpret_cast<uintptr_t>(data) & 15) || (reinterpret_cast<uintptr_t>(scales) & 15) ||
      (v_dtype != RT_F32 && v_dtype != RT_BF16))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (qdtype == RT_Q_INT8)
    err = launch_wgmma_q<RT_Q_INT8>(x, data, scales, idx, val, bias, y, M, N, K, k, block,
                                    v_dtype, tile_rows, s);
  else if (qdtype == RT_Q_NF4)
    err = launch_wgmma_q<RT_Q_NF4>(x, data, scales, idx, val, bias, y, M, N, K, k, block,
                                   v_dtype, tile_rows, s);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}
