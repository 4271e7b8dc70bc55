// Flash-attention forward of long-context training: for each (batch, query
// head) the causal (or full) softmax(q k^T / sqrt(hd)) v with an online
// softmax, and the row logsumexp that the backward recomputes p from:
//   out[b, i, h, :] = sum_j p[i, j] v[b, j, h / G, :],
//   lse[b, h, i]    = m_i + log(l_i),  p[i, j] = exp(s[i, j] - m_i) / l_i
// with s = q k^T * hd^-0.5 in float32 and column j masked (p = 0) where
// causal and j > i. Output in q's dtype, lse float32.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py
// flash_attention_fwd_pallas (body _flash_fwd_kernel) and its GQA wrapper
// flash_attention_gqa_pallas. That kernel folds heads into the batch, needs
// Sq and Skv to divide by 128, sweeps KV blocks as the innermost sequential
// grid axis with (m, l, acc) in VMEM, and the GQA wrapper repeats k and v
// per group. Here q, k and v are read in the model layout (B, S, H, hd)
// through their strides, query head h reads kv head h / G (no repeat), any
// Sq and Skv (row and column tails masked in the kernel), any hd that is a
// multiple of 16 up to 128, and the logsumexp is a second output.
//
// Bound: operations. A causal layer of qwen2-1.5b at S = 4096 does 51.5
// GFLOP on 29.5 MB (0.0521 ms at the H100's 989 TFLOP/s). Three routes,
// picked by shape in flash_attention.route and never traded for another:
// - wgmma (bf16, hd 64 and 128: the path's): FlashAttention-3's forward.
//   A block of three warpgroups owns 128 query rows of one (batch, head)
//   (q/k/v as the wrapper passes them are views a tensor map can
//   describe: strides in whole 16 bytes). Warpgroup 0 gives its registers
//   to the others (setmaxnreg) and its first thread is the producer: the Q
//   tile by TMA once, then 128-key K and V tiles into two rings of two
//   stages, K one tile ahead of V as they are consumed (mbarriers: full,
//   and empty once both consumer warpgroups are done with that K or V),
//   through 4-D tensor maps over the strided (B, S, H, hd) views with the
//   128-byte swizzle (an hd-128 row is two 64-element boxes; rows past S
//   load as zeros). Warpgroups 1 and 2 own 64 rows each. In its turn u a
//   warpgroup issues S = Q K^T of tile u (wgmma from shared memory, both
//   K-major) and O += P V of tile u - 1 (P from registers, V the MN-major
//   B operand), then passes the turn to the other warpgroup (named
//   barriers), so one's softmax runs while the other's products do; its own
//   softmax of tile u then runs behind its P V (FlashAttention-3's ping-pong
//   and intra-warpgroup overlap). The softmax works on the accumulator
//   fragment in registers: row max and sum over the 4 lanes of a row, one
//   FFMA and one EX2 a score (log2 units, scale folded in), P rounded to
//   bf16 straight into the A fragments of the next P V; the row sum adds
//   the unrounded p. The steady turns issue both products unconditionally
//   and the epilogue divides by MUFU.RCP: a product issued under a branch,
//   or an IEEE divide's subroutine call, makes ptxas serialise every wgmma
//   of the kernel (a wait for all after each one in the SASS).
//   Causal: heaviest query tiles first, a warpgroup skips tiles wholly
//   above its rows (still taking its turns and releasing their stages),
//   masks only the tiles that cross its diagonal or the Skv tail.
// - mma (bf16, the other head dims, multiples of 16 up to 112):
//   FlashAttention-2's split. A
//   block of 4 warps owns 64 query rows of one (batch, head), each warp 16
//   rows; q stays in registers as mma.sync m16n8k16 A fragments for the
//   whole sweep. 64-key K and V tiles stream through shared memory with
//   cp.async, two stages deep (tails zero-filled), their fragments read by
//   ldmatrix (V transposed); scores, running max and sum and the output
//   accumulator stay in registers, the softmax in exp2 with the scale
//   folded in, P rounded to bf16 for P V. Causal as above.
// - fma (float32): a plain FMA kernel (one warp a query row, 8 rows a
//   block, 32-key tiles in shared memory; lane j scores key j, each lane
//   owns hd / 32 output columns), expf and true divides: the reduced
//   card-vs-CPU checks compare it with the plain version at 2e-5.
#include "hopper.cuh"
#include "mma.cuh"

namespace {

using rt::ldsm_x4;
using rt::mma_bf16;
using rt::pack_bf16;

constexpr float kNeg = -1e30f;  // the Pallas body's mask value

using rt::gmma_desc;
using rt::mbar_arrive;
using rt::mbar_expect_tx;
using rt::mbar_wait;
using rt::smem_addr;

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

// ------------------------------------------------------- bf16, tensor cores

constexpr int kBQ = 64, kBK = 64, kThreadsTC = 128;
constexpr float kLog2e = 1.4426950408889634f, kLn2 = 0.6931471805599453f;

struct Layout {  // element strides of q, k, v: batch, sequence, head
  int q_b, q_s, q_h, k_b, k_s, k_h, v_b, v_s, v_h;
};

// rows [r0, r0 + 64) of one head of a (., S, ., HD) tensor into a padded
// shared tile; rows past n_rows are zero-filled.
template <int HD>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                          int stride_s, int r0, int n_rows) {
  constexpr int LD = HD + 8, CH = HD / 8;  // 16-byte chunks a row
  for (int c = threadIdx.x; c < kBK * CH; c += kThreadsTC) {
    const int r = c / CH, cc = (c % CH) * 8;
    const bool ok = r0 + r < n_rows;
    rt::cp_async16(dst + r * LD + cc,
                   ok ? src + static_cast<size_t>(r0 + r) * stride_s + cc : src, ok);
  }
}

template <int HD>
__global__ void __launch_bounds__(kThreadsTC)
    flash_fwd_bf16_kernel(const __nv_bfloat16* __restrict__ q,
                          const __nv_bfloat16* __restrict__ k,
                          const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ out,
                          float* __restrict__ lse, int Sq, int Skv, int H, int group,
                          int causal, float scale_log2, Layout ly) {
  constexpr int LD = HD + 8;  // padded rows: the fragment loads hit 32 distinct banks
  constexpr int KC = HD / 16, NT = HD / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* Ks = Qs + kBQ * LD;      // 2 stages of kBK x LD
  __nv_bfloat16* Vs = Ks + 2 * kBK * LD;  // 2 stages of kBK x LD

  const int qt = causal ? gridDim.x - 1 - blockIdx.x : blockIdx.x;  // heavy tiles first
  const int h = blockIdx.y, b = blockIdx.z, hk = h / group;
  const int q0 = qt * kBQ;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t4 = lane & 3;  // the mma fragment's row group and lane in it
  const __nv_bfloat16* qb = q + static_cast<size_t>(b) * ly.q_b + static_cast<size_t>(h) * ly.q_h;
  const __nv_bfloat16* kb = k + static_cast<size_t>(b) * ly.k_b + static_cast<size_t>(hk) * ly.k_h;
  const __nv_bfloat16* vb = v + static_cast<size_t>(b) * ly.v_b + static_cast<size_t>(hk) * ly.v_h;

  const int kv_end = causal ? min(Skv, q0 + kBQ) : Skv;  // keys any row of the block sees
  const int n_kt = (kv_end + kBK - 1) / kBK;
  const int row0 = q0 + warp * 16 + g, row1 = row0 + 8;  // this lane's two rows
  const int warp_last = q0 + warp * 16 + 15;

  load_tile<HD>(Qs, qb, ly.q_s, q0, Sq);
  load_tile<HD>(Ks, kb, ly.k_s, 0, Skv);
  load_tile<HD>(Vs, vb, ly.v_s, 0, Skv);
  rt::cp_async_commit();

  uint32_t qa[KC][4];
  float o[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m0 = kNeg, m1 = kNeg, l0 = 0.f, l1 = 0.f;  // l: this lane's share of the row sum

  for (int t = 0; t < n_kt; ++t) {
    const int s = t & 1;
    if (t + 1 < n_kt) {
      load_tile<HD>(Ks + (s ^ 1) * kBK * LD, kb, ly.k_s, (t + 1) * kBK, Skv);
      load_tile<HD>(Vs + (s ^ 1) * kBK * LD, vb, ly.v_s, (t + 1) * kBK, Skv);
    }
    rt::cp_async_commit();
    rt::cp_async_wait_1();  // tile t (and q) landed; tile t + 1 may be in flight
    __syncthreads();
    if (t == 0) {
#pragma unroll
      for (int c = 0; c < KC; ++c) {
        const __nv_bfloat16* qr = Qs + (warp * 16 + g) * LD + c * 16 + 2 * t4;
        qa[c][0] = *reinterpret_cast<const uint32_t*>(qr);
        qa[c][1] = *reinterpret_cast<const uint32_t*>(qr + 8 * LD);
        qa[c][2] = *reinterpret_cast<const uint32_t*>(qr + 8);
        qa[c][3] = *reinterpret_cast<const uint32_t*>(qr + 8 * LD + 8);
      }
    }
    const int kv0 = t * kBK;
    if (!causal || kv0 <= warp_last) {  // else every key of the tile lies above this warp's rows
      const __nv_bfloat16* Kt = Ks + s * kBK * LD;
      const __nv_bfloat16* Vt = Vs + s * kBK * LD;
      const int mq = lane >> 3, mr = lane & 7;  // the ldmatrix row this lane names
      float sc[8][4];  // 16 rows x 64 keys: n-tile j holds keys 8j..8j+7
#pragma unroll
      for (int j = 0; j < 8; ++j) sc[j][0] = sc[j][1] = sc[j][2] = sc[j][3] = 0.f;
#pragma unroll
      for (int c = 0; c < KC; ++c) {
#pragma unroll
        for (int j = 0; j < 8; j += 2) {  // keys of n-tiles j, j+1; hd halves of chunk c
          uint32_t kf[4];
          ldsm_x4<false>(kf, Kt + ((j + (mq >> 1)) * 8 + mr) * LD + c * 16 + (mq & 1) * 8);
          mma_bf16(sc[j], qa[c], kf[0], kf[1]);
          mma_bf16(sc[j + 1], qa[c], kf[2], kf[3]);
        }
      }
      // scores in log2 units: p = 2^(s * scale * log2 e - m)
      const bool masked = kv0 + kBK > Skv || (causal && kv0 + kBK - 1 > q0 + warp * 16);
      float mx0 = kNeg, mx1 = kNeg;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = kv0 + j * 8 + 2 * t4 + (e & 1);
          const bool ok = !masked || (col < Skv && (!causal || col <= (e < 2 ? row0 : row1)));
          sc[j][e] = ok ? sc[j][e] * scale_log2 : kNeg;
        }
        mx0 = fmaxf(mx0, fmaxf(sc[j][0], sc[j][1]));
        mx1 = fmaxf(mx1, fmaxf(sc[j][2], sc[j][3]));
      }
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
        mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
      }
      const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
      const float a0 = exp2f(m0 - mn0), a1 = exp2f(m1 - mn1);
      m0 = mn0;
      m1 = mn1;
      float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          // a masked score is kNeg; its p is 0 even while the row's max is kNeg too
          const float p = exp2f(sc[j][e] - (e < 2 ? mn0 : mn1));
          sc[j][e] = sc[j][e] == kNeg ? 0.f : p;
        }
        ps0 += sc[j][0] + sc[j][1];
        ps1 += sc[j][2] + sc[j][3];
      }
      l0 = l0 * a0 + ps0;
      l1 = l1 * a1 + ps1;
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        o[n][0] *= a0;
        o[n][1] *= a0;
        o[n][2] *= a1;
        o[n][3] *= a1;
      }
#pragma unroll
      for (int c = 0; c < 4; ++c) {  // 16 keys at a time: the C fragments of n-tiles 2c, 2c+1
        const uint32_t pa[4] = {pack_bf16(sc[2 * c][0], sc[2 * c][1]),
                                pack_bf16(sc[2 * c][2], sc[2 * c][3]),
                                pack_bf16(sc[2 * c + 1][0], sc[2 * c + 1][1]),
                                pack_bf16(sc[2 * c + 1][2], sc[2 * c + 1][3])};
#pragma unroll
        for (int n = 0; n < NT; n += 2) {  // hd columns of n-tiles n, n+1; key halves of c
          uint32_t vf[4];
          ldsm_x4<true>(vf, Vt + (c * 16 + (mq & 1) * 8 + mr) * LD + (n + (mq >> 1)) * 8);
          mma_bf16(o[n], pa, vf[0], vf[1]);
          mma_bf16(o[n + 1], pa, vf[2], vf[3]);
        }
      }
    }
    __syncthreads();  // everyone is done with stage s before it is refilled
  }
  rt::cp_async_wait_0();

#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  const float d0 = fmaxf(l0, 1e-30f), d1 = fmaxf(l1, 1e-30f);
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = half ? row1 : row0;
    if (row >= Sq) continue;
    const float d = half ? d1 : d0;
    __nv_bfloat16* orow = out + (static_cast<size_t>(b) * Sq + row) * H * HD +
                          static_cast<size_t>(h) * HD;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      *reinterpret_cast<uint32_t*>(orow + n * 8 + 2 * t4) =
          pack_bf16(o[n][2 * half] / d, o[n][2 * half + 1] / d);
    }
    if (t4 == 0)  // m is in log2 units
      lse[(static_cast<size_t>(b) * H + h) * Sq + row] = (half ? m1 : m0) * kLn2 + logf(d);
  }
}

// ---------------------------------------------- bf16, TMA + wgmma (Hopper)

constexpr int kWgRows = 128;        // query rows a block: two consumer warpgroups of 64
constexpr int kWgThreads = 384;     // warpgroup 0: the producer; 1 and 2: consumers
constexpr int kBoxBytes = 64 * 2;   // a 128-byte swizzle row: 64 bf16 of hd

template <int HD, int BK, int S>
struct FlashSmem {
  static constexpr int kQBox = kWgRows * kBoxBytes, kKVBox = BK * kBoxBytes;
  static constexpr int kQ = HD / 64 * kQBox, kKV = HD / 64 * kKVBox;
  static constexpr int kBars = 8 * (1 + 4 * S);
  static constexpr int kBytes = kQ + 2 * S * kKV + kBars + 1024;  // + alignment slack
  static_assert(kBytes <= rt::kSmemMax, "the ring fits");
};

// 2^x in one instruction (MUFU.EX2; denormal results flush to 0)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

template <int HD, int BK, int S>
__global__ void __launch_bounds__(kWgThreads, 1)
    flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap q_map,
                           const __grid_constant__ CUtensorMap k_map,
                           const __grid_constant__ CUtensorMap v_map,
                           __nv_bfloat16* __restrict__ out, float* __restrict__ lse, int Sq,
                           int Skv, int H, int group, int causal, float scale_log2) {
  using L = FlashSmem<HD, BK, S>;
  constexpr int NB = HD / 64, KS = HD / 16, PK = BK / 16;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  uint8_t* Qs = base;
  uint8_t* ring = base + L::kQ;  // K stages (S x kKV bytes), then V stages
  uint64_t* q_full = reinterpret_cast<uint64_t*>(ring + 2 * S * L::kKV);
  uint64_t* k_full = q_full + 1;
  uint64_t* v_full = k_full + S;
  uint64_t* k_empty = v_full + S;
  uint64_t* v_empty = k_empty + S;

  const int qt = causal ? gridDim.x - 1 - blockIdx.x : blockIdx.x;  // heavy tiles first
  const int h = blockIdx.y, b = blockIdx.z, hk = h / group;
  const int q0 = qt * kWgRows;
  const int kv_end = causal ? min(Skv, q0 + kWgRows) : Skv;  // keys any row of the block sees
  const int T = (kv_end + BK - 1) / BK;
  const int wg = threadIdx.x / 128;
  if (threadIdx.x == 0) {
    rt::mbar_init(q_full, 1);
    for (int s = 0; s < S; ++s) {
      rt::mbar_init(&k_full[s], 1);
      rt::mbar_init(&v_full[s], 1);
      rt::mbar_init(&k_empty[s], 8);  // one arrival from each consumer warp
      rt::mbar_init(&v_empty[s], 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {  // ---------------------------------------------- producer
    rt::setmaxnreg_dec<40>();
    if (threadIdx.x == 0) {
      // K runs one tile ahead of V, as the consumers take them: K_0, K_1,
      // V_0, K_2, V_1, ...
      auto load = [&](const CUtensorMap* map, uint64_t* full, uint64_t* empty, uint8_t* dst,
                      int t) {
        const int s = t % S;
        if (t >= S) mbar_wait(&empty[s], (t / S - 1) & 1);
        mbar_expect_tx(&full[s], L::kKV);
        for (int c = 0; c < NB; ++c)
          rt::tma_load_4d(dst + s * L::kKV + c * L::kKVBox, map, &full[s], 64 * c, hk, t * BK, b);
      };
      mbar_expect_tx(q_full, L::kQ);
      for (int c = 0; c < NB; ++c)
        rt::tma_load_4d(Qs + c * L::kQBox, &q_map, q_full, 64 * c, h, q0, b);
      load(&k_map, k_full, k_empty, ring, 0);
      for (int t = 1; t < T; ++t) {
        load(&k_map, k_full, k_empty, ring, t);
        load(&v_map, v_full, v_empty, ring + S * L::kKV, t - 1);
      }
      load(&v_map, v_full, v_empty, ring + S * L::kKV, T - 1);
    }
    return;
  }

  // -------------------------------------------------------------- consumers
  rt::setmaxnreg_inc<232>();
  const int cw = wg - 1;  // rows q0 + 64 cw ..
  const int warp = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, tq = lane % 4;
  const int first = q0 + 64 * cw, row0 = first + 16 * warp + g, row1 = row0 + 8;
  // tiles this warpgroup computes; the rest lie wholly above its rows
  const int Tw = causal ? min(T, (first + 63) / BK + 1) : T;
  const uint32_t qa = smem_addr(Qs) + cw * 64 * kBoxBytes;
  const uint32_t ka0 = smem_addr(ring), va0 = ka0 + S * L::kKV;
  // the two warpgroups take turns at issuing their products (named barriers
  // 1 and 2: "warpgroup 1 / 2 may issue"), so one's softmax runs while the
  // other's products do; warpgroup 2 lets warpgroup 1 go first
  const int bar_mine = 1 + cw, bar_other = 2 - cw;
  if (cw == 1) asm volatile("bar.arrive %0, 256;\n" ::"r"(bar_other) : "memory");

  float o[HD / 2], sc[BK / 2];
  uint32_t pa[PK][4];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) o[i] = 0.f;
  // m: the running row max of the scaled scores (log2 units); l: this
  // lane's share of the row sum
  float m0 = kNeg, m1 = kNeg, l0 = 0.f, l1 = 0.f;

  // turn u: issue S = Q K^T of tile u (u < Tw) and O += P V of tile u - 1
  // (1 <= u <= Tw), pass the turn, then the softmax of tile u while P V
  // runs; turns past Tw release the tiles wholly above this warpgroup's
  // rows. The steady turns issue both products unconditionally, so ptxas
  // can see which commit group each wait retires and keeps the products
  // pipelined (products issued under a branch get serialised).
  auto turn_begin = [&] { rt::named_bar(bar_mine, 256); };
  auto turn_end = [&](int u) {
    if (cw == 0 || u < T) asm volatile("bar.arrive %0, 256;\n" ::"r"(bar_other) : "memory");
  };
  auto issue_qk = [&](int u) {  // both operands K-major from shared memory
    rt::wgmma_fence();
    const uint32_t ka = ka0 + (u % S) * L::kKV;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks)  // the first k step overwrites sc
      rt::Wgmma<BK>::template mma<0, 0>(
          sc, gmma_desc(qa + (ks / 4) * L::kQBox + (ks % 4) * 32, 16, 1024),
          gmma_desc(ka + (ks / 4) * L::kKVBox + (ks % 4) * 32, 16, 1024), ks > 0);
    rt::wgmma_commit();
  };
  auto issue_pv = [&](int u) {  // V MN-major: 64 hd columns a box, the next box LBO away
    rt::wgmma_fence();
    const uint32_t va = va0 + (u % S) * L::kKV;
#pragma unroll
    for (int kk = 0; kk < PK; ++kk)
      rt::WgmmaRS<HD>::template mma<1>(o, pa[kk],
                                       gmma_desc(va + kk * 16 * kBoxBytes, L::kKVBox, 1024));
    rt::wgmma_commit();
  };
  auto pin_sc = [&] {
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) asm volatile("" : "+f"(sc[i])::"memory");
  };
  auto pin_o = [&] {
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) asm volatile("" : "+f"(o[i])::"memory");
  };
  float a0, a1;  // the rescale of o that tile u's softmax asks for
  auto softmax = [&](int u) {  // sc: tile u's scores -> p, in place; m, l, a0, a1
    const int kv0 = u * BK;
    // a tile crossing this warpgroup's diagonal or the Skv tail: masked
    // scores are kNeg, whose p below is 0 (a row always sees key 0 in tile
    // 0, so its running max is a real score from then on)
    if (kv0 + BK > Skv || (causal && kv0 + BK - 1 > first)) {
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) {
        const int col = kv0 + 8 * (i / 4) + 2 * tq + (i & 1);
        if (col >= Skv || (causal && col > ((i & 2) ? row1 : row0))) sc[i] = kNeg;
      }
    }
    // row maxima, then row sums, in four interleaved partials (i % 8 / 4
    // and i % 2 pick one): short dependency chains
    float mx[4] = {kNeg, kNeg, kNeg, kNeg};
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) {
      const int r = (i & 2) >> 1, c = ((i >> 2) & 1);
      mx[2 * r + c] = fmaxf(mx[2 * r + c], sc[i]);
    }
    float mx0 = fmaxf(mx[0], mx[1]), mx1 = fmaxf(mx[2], mx[3]);
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
    }
    // p = 2^(s * scale * log2 e - m), one FFMA and one EX2 a score
    const float mn0 = fmaxf(m0, mx0 * scale_log2), mn1 = fmaxf(m1, mx1 * scale_log2);
    a0 = ex2(m0 - mn0);
    a1 = ex2(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
    float ps[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) {
      const int r = (i & 2) >> 1, c = ((i >> 2) & 1);
      sc[i] = ex2(fmaf(sc[i], scale_log2, r ? -mn1 : -mn0));
      ps[2 * r + c] += sc[i];
    }
    l0 = l0 * a0 + (ps[0] + ps[1]);
    l1 = l1 * a1 + (ps[2] + ps[3]);
  };
  auto fold = [&] {  // o rescaled, p rounded to bf16 into the A fragments of P V
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) o[i] *= (i & 2) ? a1 : a0;
#pragma unroll
    for (int kk = 0; kk < PK; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r) pa[kk][r] = rt::pack_bf16(sc[8 * kk + 2 * r], sc[8 * kk + 2 * r + 1]);
  };

  mbar_wait(q_full, 0);
  mbar_wait(&k_full[0], 0);  // the data first, then the turn
  turn_begin();
  issue_qk(0);
  turn_end(0);
  rt::wgmma_wait<0>();
  pin_sc();
  if (lane == 0) mbar_arrive(&k_empty[0]);
  softmax(0);
  fold();
  for (int u = 1; u < Tw; ++u) {
    mbar_wait(&k_full[u % S], (u / S) & 1);
    mbar_wait(&v_full[(u - 1) % S], ((u - 1) / S) & 1);
    turn_begin();
    issue_qk(u);
    issue_pv(u - 1);
    turn_end(u);
    rt::wgmma_wait<1>();  // the scores are done; P V may still run
    pin_sc();
    if (lane == 0) mbar_arrive(&k_empty[u % S]);
    softmax(u);
    rt::wgmma_wait<0>();  // tile u - 1's P V is done: its V stage, o and pa are free
    pin_o();
    if (lane == 0) mbar_arrive(&v_empty[(u - 1) % S]);
    fold();
  }
  mbar_wait(&v_full[(Tw - 1) % S], ((Tw - 1) / S) & 1);
  turn_begin();
  issue_pv(Tw - 1);
  turn_end(Tw);
  rt::wgmma_wait<0>();
  pin_o();
  if (lane == 0) mbar_arrive(&v_empty[(Tw - 1) % S]);
  for (int u = Tw + 1; u <= T; ++u) {  // tile u - 1 lies wholly above this warpgroup's rows
    turn_begin();
    turn_end(u);
    mbar_wait(&k_full[(u - 1) % S], ((u - 1) / S) & 1);
    mbar_wait(&v_full[(u - 1) % S], ((u - 1) / S) & 1);
    if (lane == 0) {
      mbar_arrive(&k_empty[(u - 1) % S]);
      mbar_arrive(&v_empty[(u - 1) % S]);
    }
  }

#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  const float d0 = fmaxf(l0, 1e-30f), d1 = fmaxf(l1, 1e-30f);
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = half ? row1 : row0;
    if (row >= Sq) continue;
    const float d = half ? d1 : d0;
    // 1 / d by MUFU.RCP: an IEEE divide would bring a slow-path subroutine
    // call into the kernel, and with it ptxas serialises every wgmma
    float inv;
    asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(inv) : "f"(d));
    __nv_bfloat16* orow = out + (static_cast<size_t>(b) * Sq + row) * H * HD +
                          static_cast<size_t>(h) * HD;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j)
      *reinterpret_cast<uint32_t*>(orow + 8 * j + 2 * tq) =
          rt::pack_bf16(o[4 * j + 2 * half] * inv, o[4 * j + 2 * half + 1] * inv);
    if (tq == 0)  // m is in log2 units
      lse[(static_cast<size_t>(b) * H + h) * Sq + row] = (half ? m1 : m0) * kLn2 + logf(d);
  }
}

// ---------------------------------------------------------------- float32

constexpr int kRowsF = 8, kKeysF = 32;

template <int HD>
__global__ void __launch_bounds__(kRowsF * 32)
    flash_fwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                         const float* __restrict__ v, float* __restrict__ out,
                         float* __restrict__ lse, int Sq, int Skv, int H, int group,
                         int causal, float scale, Layout ly) {
  constexpr int NPL = (HD + 31) / 32;  // output columns a lane
  __shared__ float Ks[kKeysF][HD + 1];  // +1: lane j reads row j, no bank conflict
  __shared__ float Vs[kKeysF][HD];
  __shared__ float Qs[kRowsF][HD];
  const int qt = causal ? gridDim.x - 1 - blockIdx.x : blockIdx.x;
  const int h = blockIdx.y, b = blockIdx.z, hk = h / group;
  const int q0 = qt * kRowsF;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int row = q0 + warp;
  const float* qb = q + static_cast<size_t>(b) * ly.q_b + static_cast<size_t>(h) * ly.q_h;
  const float* kb = k + static_cast<size_t>(b) * ly.k_b + static_cast<size_t>(hk) * ly.k_h;
  const float* vb = v + static_cast<size_t>(b) * ly.v_b + static_cast<size_t>(hk) * ly.v_h;
  for (int e = threadIdx.x; e < kRowsF * HD; e += blockDim.x) {
    const int r = e / HD, d = e % HD;
    Qs[r][d] = q0 + r < Sq ? qb[static_cast<size_t>(q0 + r) * ly.q_s + d] : 0.f;
  }
  const int kv_end = causal ? min(Skv, q0 + kRowsF) : Skv;
  float m = kNeg, l = 0.f, acc[NPL];
#pragma unroll
  for (int i = 0; i < NPL; ++i) acc[i] = 0.f;
  for (int kv0 = 0; kv0 < kv_end; kv0 += kKeysF) {
    __syncthreads();  // the previous tile is consumed (and q has landed)
    for (int e = threadIdx.x; e < kKeysF * HD; e += blockDim.x) {
      const int r = e / HD, d = e % HD;
      const bool ok = kv0 + r < Skv;
      Ks[r][d] = ok ? kb[static_cast<size_t>(kv0 + r) * ly.k_s + d] : 0.f;
      Vs[r][d] = ok ? vb[static_cast<size_t>(kv0 + r) * ly.v_s + d] : 0.f;
    }
    __syncthreads();
    const int col = kv0 + lane;
    const bool ok = col < Skv && (!causal || col <= row);
    float s = 0.f;
#pragma unroll 8
    for (int d = 0; d < HD; ++d) s = fmaf(Qs[warp][d], Ks[lane][d], s);
    s = ok ? s * scale : kNeg;
    const float mn = fmaxf(m, warp_max(s));
    const float p = ok ? expf(s - mn) : 0.f;
    const float alpha = expf(m - mn);
    m = mn;
    l = l * alpha + rt::warp_sum(p);
#pragma unroll
    for (int i = 0; i < NPL; ++i) acc[i] *= alpha;
    for (int j = 0; j < kKeysF; ++j) {
      const float pj = __shfl_sync(0xffffffffu, p, j);
#pragma unroll
      for (int i = 0; i < NPL; ++i) {
        const int d = lane + 32 * i;
        if (d < HD) acc[i] = fmaf(pj, Vs[j][d], acc[i]);
      }
    }
  }
  if (row >= Sq) return;
  const float den = fmaxf(l, 1e-30f);
  float* orow = out + (static_cast<size_t>(b) * Sq + row) * H * HD + static_cast<size_t>(h) * HD;
#pragma unroll
  for (int i = 0; i < NPL; ++i) {
    const int d = lane + 32 * i;
    if (d < HD) orow[d] = acc[i] / den;
  }
  if (lane == 0) lse[(static_cast<size_t>(b) * H + h) * Sq + row] = m + logf(den);
}

// ----------------------------------------------------------------- launch

template <int HD>
cudaError_t launch(const void* q, const void* k, const void* v, void* out, float* lse, int B,
                   int Sq, int Skv, int H, int group, int causal, int dtype, const Layout& ly,
                   cudaStream_t stream) {
  const float scale = 1.0f / sqrtf(static_cast<float>(HD));
  if (dtype == RT_BF16) {
    const size_t smem = static_cast<size_t>(kBQ + 4 * kBK) * (HD + 8) * sizeof(__nv_bfloat16);
    cudaError_t err = rt::allow_smem(flash_fwd_bf16_kernel<HD>, smem);
    if (err != cudaSuccess) return err;
    dim3 grid((Sq + kBQ - 1) / kBQ, H, B);
    flash_fwd_bf16_kernel<HD><<<grid, kThreadsTC, smem, stream>>>(
        static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(out), lse, Sq, Skv, H,
        group, causal, scale * kLog2e, ly);
  } else if (dtype == RT_F32) {
    dim3 grid((Sq + kRowsF - 1) / kRowsF, H, B);
    flash_fwd_f32_kernel<HD><<<grid, kRowsF * 32, 0, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<float*>(out), lse, Sq, Skv, H, group, causal,
        scale, ly);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

// a (B, S, heads, hd) bf16 view through its element strides as a 4-D tensor
// map (hd innermost), boxes of 64 hd x `rows` positions of one (batch, head)
cudaError_t encode_view(CUtensorMap* map, const void* ptr, int B, int S, int heads, int hd,
                        int s_b, int s_s, int s_h, int rows) {
  const uint64_t dims[4] = {static_cast<uint64_t>(hd), static_cast<uint64_t>(heads),
                            static_cast<uint64_t>(S), static_cast<uint64_t>(B)};
  const uint64_t strides[3] = {2ull * s_h, 2ull * s_s, 2ull * s_b};
  const uint32_t box[4] = {64, 1, static_cast<uint32_t>(rows), 1};
  return rt::encode_4d(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, ptr, dims, strides, box, true);
}

template <int HD, int BK, int S>
cudaError_t launch_wgmma(const void* q, const void* k, const void* v, void* out, float* lse,
                         int B, int Sq, int Skv, int H, int Hkv, int causal, const Layout& ly,
                         cudaStream_t stream) {
  CUtensorMap qm, km, vm;
  cudaError_t err = encode_view(&qm, q, B, Sq, H, HD, ly.q_b, ly.q_s, ly.q_h, kWgRows);
  if (err == cudaSuccess) err = encode_view(&km, k, B, Skv, Hkv, HD, ly.k_b, ly.k_s, ly.k_h, BK);
  if (err == cudaSuccess) err = encode_view(&vm, v, B, Skv, Hkv, HD, ly.v_b, ly.v_s, ly.v_h, BK);
  if (err != cudaSuccess) return err;
  auto kernel = flash_fwd_wgmma_kernel<HD, BK, S>;
  constexpr int smem = FlashSmem<HD, BK, S>::kBytes;
  static bool ready = false;  // the shared-memory opt-in, once per instantiation
  if (!ready) {
    err = rt::allow_smem(kernel, smem);
    if (err != cudaSuccess) return err;
    ready = true;
  }
  const dim3 grid((Sq + kWgRows - 1) / kWgRows, H, B);
  kernel<<<grid, kWgThreads, smem, stream>>>(
      qm, km, vm, static_cast<__nv_bfloat16*>(out), lse, Sq, Skv, H, H / Hkv, causal,
      1.0f / sqrtf(static_cast<float>(HD)) * kLog2e);
  return cudaGetLastError();
}

// the (hd, key tile, stages) instantiations the wgmma route has
template <int HD>
cudaError_t launch_wgmma_hd(int bk, int stages, const void* q, const void* k, const void* v,
                            void* out, float* lse, int B, int Sq, int Skv, int H, int Hkv,
                            int causal, const Layout& ly, cudaStream_t s) {
  if (bk == 128 && stages == 2)
    return launch_wgmma<HD, 128, 2>(q, k, v, out, lse, B, Sq, Skv, H, Hkv, causal, ly, s);
  if (bk == 128 && stages == 3)
    return launch_wgmma<HD, 128, 3>(q, k, v, out, lse, B, Sq, Skv, H, Hkv, causal, ly, s);
  if (bk == 64 && stages == 2)
    return launch_wgmma<HD, 64, 2>(q, k, v, out, lse, B, Sq, Skv, H, Hkv, causal, ly, s);
  if (bk == 64 && stages == 3)
    return launch_wgmma<HD, 64, 3>(q, k, v, out, lse, B, Sq, Skv, H, Hkv, causal, ly, s);
  return cudaErrorInvalidValue;
}

}  // namespace

// The wgmma route: bf16 q (B, Sq, H, hd), k/v (B, Skv, Hkv, hd) through
// their element strides (the last dim unit-stride, the others multiples of
// 8, pointers 16-byte aligned: what a tensor map takes); hd 64 or 128; out
// (B, Sq, H, hd) contiguous bf16, lse (B, H, Sq) float32. block_keys (64 or
// 128) and stages (2 or 3) pick the key tile and the ring's depth.
extern "C" int rt_flash_attention_fwd_wgmma(const void* q, const void* k, const void* v,
                                            void* out, void* lse, int B, int Sq, int Skv, int H,
                                            int Hkv, int hd, int causal, int q_b, int q_s,
                                            int q_h, int k_b, int k_s, int k_h, int v_b, int v_s,
                                            int v_h, int block_keys, int stages, void* stream) {
  if (B < 1 || Sq < 1 || Skv < 1 || Hkv < 1 || H % Hkv) return cudaErrorInvalidValue;
  const Layout ly{q_b, q_s, q_h, k_b, k_s, k_h, v_b, v_s, v_h};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  cudaError_t err = cudaErrorInvalidValue;
  if (hd == 64)
    err = launch_wgmma_hd<64>(block_keys, stages, q, k, v, out, l, B, Sq, Skv, H, Hkv, causal,
                              ly, s);
  else if (hd == 128)
    err = launch_wgmma_hd<128>(block_keys, stages, q, k, v, out, l, B, Sq, Skv, H, Hkv, causal,
                               ly, s);
  return static_cast<int>(err);
}

// The mma and fma routes: q (B, Sq, H, hd), k/v (B, Skv, Hkv, hd) through
// their element strides (the last dim unit-stride; bf16 rows 16-byte
// aligned); out (B, Sq, H, hd) contiguous in q's dtype, lse (B, H, Sq)
// float32. hd a multiple of 16 up to 128.
extern "C" int rt_flash_attention_fwd(const void* q, const void* k, const void* v, void* out,
                                      void* lse, int B, int Sq, int Skv, int H, int Hkv, int hd,
                                      int causal, int dtype, int q_b, int q_s, int q_h, int k_b,
                                      int k_s, int k_h, int v_b, int v_s, int v_h,
                                      void* stream) {
  const Layout ly{q_b, q_s, q_h, k_b, k_s, k_h, v_b, v_s, v_h};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  const int g = H / Hkv;
  cudaError_t err;
  switch (hd) {
    case 16: err = launch<16>(q, k, v, out, l, B, Sq, Skv, H, g, causal, dtype, ly, s); break;
    case 32: err = launch<32>(q, k, v, out, l, B, Sq, Skv, H, g, causal, dtype, ly, s); break;
    case 48: err = launch<48>(q, k, v, out, l, B, Sq, Skv, H, g, causal, dtype, ly, s); break;
    case 64: err = launch<64>(q, k, v, out, l, B, Sq, Skv, H, g, causal, dtype, ly, s); break;
    case 80: err = launch<80>(q, k, v, out, l, B, Sq, Skv, H, g, causal, dtype, ly, s); break;
    case 96: err = launch<96>(q, k, v, out, l, B, Sq, Skv, H, g, causal, dtype, ly, s); break;
    case 112: err = launch<112>(q, k, v, out, l, B, Sq, Skv, H, g, causal, dtype, ly, s); break;
    case 128: err = launch<128>(q, k, v, out, l, B, Sq, Skv, H, g, causal, dtype, ly, s); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
