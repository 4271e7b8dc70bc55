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
// GFLOP on 29.5 MB. Design, a simple first version:
// - bf16: FlashAttention-2's split. A block of 4 warps owns 64 query rows
//   of one (batch, head), each warp 16 rows; q stays in registers as
//   mma.sync m16n8k16 A fragments for the whole sweep. 64-key K and V tiles
//   stream through shared memory with cp.async, two stages deep (tails
//   zero-filled). S = q k^T and O += P V run on the tensor cores (bf16 in,
//   float32 accumulators), their K and V fragments read by ldmatrix (V
//   transposed); the scores, the running max and sum, and the output
//   accumulator stay in registers, the row reductions are shuffles among
//   the 4 lanes that share a row, and the softmax runs in exp2 with the
//   scale folded in. P is rounded to bf16 for the P V product (the Pallas
//   body multiplies in float32); the row sum l adds the unrounded p.
//   Causal: a block stops at the tile holding its last row's diagonal, a
//   warp skips tiles wholly above its rows, masks are built only on the
//   tiles that cross the diagonal or the Skv tail, and the heaviest query
//   tiles launch first.
// - float32: a plain FMA kernel (one warp a query row, 8 rows a block,
//   32-key tiles in shared memory; lane j scores key j, each lane owns
//   hd / 32 output columns), expf and true divides: the reduced card-vs-CPU
//   checks compare it with the plain version at 2e-5.
#include "mma.cuh"

namespace {

using rt::ldsm_x4;
using rt::mma_bf16;
using rt::pack_bf16;

constexpr float kNeg = -1e30f;  // the Pallas body's mask value

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

}  // namespace

// q (B, Sq, H, hd), k/v (B, Skv, Hkv, hd) through their element strides (the
// last dim unit-stride; bf16 rows 16-byte aligned); out (B, Sq, H, hd)
// contiguous in q's dtype, lse (B, H, Sq) float32. hd a multiple of 16 up to 128.
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
