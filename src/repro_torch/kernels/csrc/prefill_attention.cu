// Paged chunked-prefill attention: a chunk of C queries per slot against a
// block pool (N, P, Hkv, hd) through a (B, n_pages) block table. Query i of
// slot b sits at logical position q_offset[b] + i and sees column c iff
//   c <= q_offset[b] + i  and  c < kv_valid_len[b]
// (intra-chunk causality and the slot's post-write frontier). Rows with no
// visible column (idle slots) return zeros. The pools hold q's element type
// (rt_paged_prefill_attention) or int8 codes with one float32 scale per
// (block, kv-head) per pool (rt_paged_prefill_attention_q).
//
// Replaces the TPU kernel src/repro/kernels/prefill_attention.py
// paged_prefill_attention_pallas, both of its bodies:
// _paged_prefill_attn_kernel (fp pools) and _paged_prefill_attn_q_kernel
// (int8 pools, each page dequantized against its block's scale). That
// kernel holds all C*G rows of a (slot, kv-head) in one VMEM tile (1536
// rows at C = 256, G = 6), far more than one Hopper block's registers, and
// sweeps every page of the table.
//
// Bound: at the serving shapes, memory on paper (the K/V bytes up to each
// slot's frontier, plus q and the output: 0.0043 ms for qwen2-1.5b's mixed
// step on an H100); the work is 4 * hd flops for every visible (row,
// column) pair, and a pad row (i >= q_len) sees its slot's whole frontier
// as the reference defines it, so the pairs are about twice the real rows'
// (569,162 against 264,320 a head at chip_smoke.py's path shape). The pad
// rows stay computed: each has its own q, the whole output is compared, and
// on MoE their hidden states reach the router.
//
// Design, bf16 with hd in {16, 32, 64, 128}: FlashAttention-2's tiles, as
// in flash_attention.cu (helpers in mma.cuh). Rows fold as the reference
// folds them, r = i * G + gi, so one staged K/V tile serves the whole GQA
// group; a block of 4 warps owns 64 folded rows of one (slot, kv-head)
// (about 64 / G query positions; each warp 16 rows, q in registers as
// m16n8k16 A fragments). 64-column K/V tiles (4 pages of 16) are resolved
// page by page through the slot's block-table row, clamped as
// TableBlocks::block clamps it, and land in shared memory by cp.async in
// 16-byte chunks, two stages deep; columns at or past the block's frontier
// are zero-filled and never read, so no page the engine left unallocated is
// touched. Scores, running max and sum, and the output accumulator stay in
// registers (exp2 with the scale folded in); P is rounded to bf16 for P V
// and the row sum adds the unrounded p. A row's frontier is
// min(q_offset + r / G + 1, kv_valid_len): a warp skips the tiles past its
// last row's frontier and builds masks only on tiles that cross its first
// row's. The grid is (slot x kv-head, row tile), row tiles last to first,
// so the longest tiles (the chunk's end, and pad rows, which see the whole
// frontier) launch first. Shared memory 87 KB at hd 128 (Q, and K and V two
// stages, rows padded by 8 so ldmatrix hits distinct banks; 86 KB for int8
// pools); 180 registers a thread at hd 128, no spills (-Xptxas=-v); two
// blocks an SM.
// int8 pools run the same tiles without rounding a dequantized value: the
// codes (exact in bf16) are staged by cp.async as int8, two stages deep,
// and widened to bf16 in shared memory once per tile; a page's k scale
// multiplies its columns' scores in float32, its v scale multiplies their p
// before p is rounded for P V (the row sum stays the unscaled p's). The
// only rounding beyond the plain version's float32 dequantize is then P's.
// float32 (the reduced card-vs-CPU runs, which need the CPU's greedy
// tokens), and bf16 at other head dims, keep the first version: one warp a
// row, pages staged as float32 (rt::sweep_pages), dot products on the CUDA
// cores.
#include "mma.cuh"
#include "paged_attention.cuh"

namespace {

constexpr int kWarps = 8;  // query rows per block

template <typename T, typename C, int E>
__global__ void paged_prefill_kernel(const T* __restrict__ q, const C* __restrict__ k_pool,
                                     const C* __restrict__ v_pool,
                                     const float* __restrict__ k_scale,
                                     const float* __restrict__ v_scale,
                                     const int32_t* __restrict__ table,
                                     const int32_t* __restrict__ q_offset,
                                     const int32_t* __restrict__ kv_valid_len,
                                     T* __restrict__ out, int n_blocks, int page, int hkv,
                                     int hd, int g, int c, int n_pages, float scale) {
  extern __shared__ float smem[];
  const int b = blockIdx.x;
  const int h = blockIdx.y;
  const int warps = blockDim.x / 32;
  const int rows = c * g;  // rows fold (query i, group member gi): r = i * g + gi
  const int r0 = blockIdx.z * warps;
  const int r = r0 + threadIdx.x / 32;
  const bool active = r < rows;
  const int cap = max(0, min(kv_valid_len[b], n_pages * page));
  const int q0 = q_offset[b];
  // frontiers grow with the row index, so the block's last row bounds them all
  const int r_last = min(r0 + warps, rows) - 1;
  const int block_end = max(0, min(q0 + r_last / g + 1, cap));
  const int used = (block_end + page - 1) / page;
  const int i = r / g;
  const int row_end = active ? max(0, min(q0 + i + 1, cap)) : 0;
  const int head = h * g + (r - i * g);
  const size_t off = active ? ((static_cast<size_t>(b) * c + i) * hkv * g + head) * hd : 0;
  float qr[E];
  rt::load_row<T, E>(q + off, hd, active, qr);
  rt::SoftmaxState<E> st;
  const rt::TableBlocks blocks{table + static_cast<size_t>(b) * n_pages, n_blocks, page};
  rt::sweep_pages(qr, k_pool, v_pool, k_scale, v_scale, blocks, page, hkv, hd, h, 0, used,
                  block_end, row_end, active, scale, smem, smem + page * hd, st);
  if (active) rt::store_row<T, E>(st, hd, out + off);
}

// ------------------------------------------------------ bf16, tensor cores

constexpr int kRowsTC = 64, kColsTC = 64, kThreadsTC = 128;
constexpr float kLog2e = 1.4426950408889634f;

// Shared memory of the tensor-core kernel: Qs (64 x LD bf16), then K and V
// bf16 tiles (two stages for fp pools, one for int8), then for int8 the
// staged codes (2 stages x 64 x HD bytes, k and v) and the columns' k and v
// scales (2 stages x 64 floats each).
template <int HD, bool Q>
struct TcSmem {
  static constexpr int LD = HD + 8;
  static constexpr int kStages = Q ? 1 : 2;
  static constexpr size_t kTiles = static_cast<size_t>(kRowsTC + 2 * kStages * kColsTC) * LD;
  static constexpr size_t kBytes =
      kTiles * sizeof(__nv_bfloat16) +
      (Q ? 2 * 2 * kColsTC * HD + 2 * 2 * kColsTC * sizeof(float) : 0);
};

// 16 int8 codes -> 16 bf16 (exact): float(code) as 2^23 + (code + 128) by a
// byte permute, minus 2^23 + 128, then packed in pairs.
__device__ __forceinline__ void widen_codes(__nv_bfloat16* dst, uint4 c) {
  const uint32_t w[4] = {c.x, c.y, c.z, c.w};
  uint32_t o[8];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const uint32_t u = w[i] ^ 0x80808080u;
    float f[4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
      f[j] = __int_as_float(__byte_perm(u, 0x4B000000u, 0x7440 + j)) - 8388736.f;
    o[2 * i] = rt::pack_bf16(f[0], f[1]);
    o[2 * i + 1] = rt::pack_bf16(f[2], f[3]);
  }
  *reinterpret_cast<uint4*>(dst) = make_uint4(o[0], o[1], o[2], o[3]);
  *reinterpret_cast<uint4*>(dst + 8) = make_uint4(o[4], o[5], o[6], o[7]);
}

template <int HD, bool Q>
__global__ void __launch_bounds__(kThreadsTC)
    paged_prefill_tc_kernel(const __nv_bfloat16* __restrict__ q,
                      const rt::code_t<__nv_bfloat16, Q>* __restrict__ k_pool,
                      const rt::code_t<__nv_bfloat16, Q>* __restrict__ v_pool,
                      const float* __restrict__ k_scale, const float* __restrict__ v_scale,
                      const int32_t* __restrict__ table, const int32_t* __restrict__ q_offset,
                      const int32_t* __restrict__ kv_valid_len, __nv_bfloat16* __restrict__ out,
                      int n_blocks, int page, int hkv, int g, int c, int n_pages,
                      float scale_log2) {
  using Sm = TcSmem<HD, Q>;
  constexpr int LD = Sm::LD, KC = HD / 16, NT = HD / 8, CH = HD / 8, CQ = HD / 16;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* Ks = Qs + kRowsTC * LD;
  __nv_bfloat16* Vs = Ks + Sm::kStages * kColsTC * LD;
  int8_t* Kq = reinterpret_cast<int8_t*>(Vs + Sm::kStages * kColsTC * LD);  // int8 pools only
  int8_t* Vq = Kq + 2 * kColsTC * HD;
  float* ksc = reinterpret_cast<float*>(Vq + 2 * kColsTC * HD);
  float* vsc = ksc + 2 * kColsTC;

  const int b = blockIdx.x / hkv, h = blockIdx.x % hkv;
  const int r0 = (gridDim.y - 1 - blockIdx.y) * kRowsTC;  // the longest row tiles first
  const int rows = c * g;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gr = lane >> 2, t4 = lane & 3;  // the mma fragment's row group and lane in it
  const int cap = max(0, min(kv_valid_len[b], n_pages * page));
  const int q0 = q_offset[b];
  // columns folded row r sees: [0, frontier); rows past the chunk take the last row's
  auto frontier = [&](int r) { return max(0, min(q0 + min(r, rows - 1) / g + 1, cap)); };
  const int kv_end = frontier(r0 + kRowsTC - 1);  // frontiers grow with r
  const int n_kt = (kv_end + kColsTC - 1) / kColsTC;
  const int wr = r0 + warp * 16;
  const int w_lo = frontier(wr), w_hi = frontier(wr + 15);
  const int row0 = wr + gr, row1 = row0 + 8;  // this lane's two rows
  const int f0 = frontier(row0), f1 = frontier(row1);
  const int32_t* trow = table + static_cast<size_t>(b) * n_pages;
  const size_t tok = static_cast<size_t>(hkv) * HD;  // elements between a page's rows

  // q: folded row r is query i = r / g of head h * g + r % g
  for (int e = threadIdx.x; e < kRowsTC * CH; e += kThreadsTC) {
    const int r = e / CH, ch = (e % CH) * 8, rr = r0 + r;
    const bool ok = rr < rows;
    const __nv_bfloat16* src = q;
    if (ok) {
      const int i = rr / g;
      src += ((static_cast<size_t>(b) * c + i) * hkv * g + h * g + (rr - i * g)) * HD + ch;
    }
    rt::cp_async16(Qs + r * LD + ch, src, ok);
  }
  // pool offset of column cc (< kv_end) for this kv-head; blk its block
  auto column = [&](int cc, int& blk) {
    const int p = cc / page;
    blk = min(max(trow[p], 0), n_blocks - 1);
    return (static_cast<size_t>(blk) * page + (cc - p * page)) * tok + static_cast<size_t>(h) * HD;
  };
  auto load_kv = [&](int st, int t) {
    const int kv0 = t * kColsTC;
    if constexpr (Q) {
      for (int e = threadIdx.x; e < kColsTC * CQ; e += kThreadsTC) {
        const int col = e / CQ, ch = (e % CQ) * 16, cc = kv0 + col;
        const bool ok = cc < kv_end;
        int blk;
        const size_t off = ok ? column(cc, blk) + ch : 0;
        rt::cp_async16(Kq + (st * kColsTC + col) * HD + ch, k_pool + off, ok);
        rt::cp_async16(Vq + (st * kColsTC + col) * HD + ch, v_pool + off, ok);
      }
      for (int col = threadIdx.x; col < kColsTC; col += kThreadsTC) {
        const int cc = kv0 + col;
        float sk = 0.f, sv = 0.f;
        if (cc < kv_end) {
          int blk;
          column(cc, blk);
          sk = k_scale[static_cast<size_t>(blk) * hkv + h];
          sv = v_scale[static_cast<size_t>(blk) * hkv + h];
        }
        ksc[st * kColsTC + col] = sk;
        vsc[st * kColsTC + col] = sv;
      }
    } else {
      for (int e = threadIdx.x; e < kColsTC * CH; e += kThreadsTC) {
        const int col = e / CH, ch = (e % CH) * 8, cc = kv0 + col;
        const bool ok = cc < kv_end;
        int blk;
        const size_t off = ok ? column(cc, blk) + ch : 0;
        rt::cp_async16(Ks + (st * kColsTC + col) * LD + ch, k_pool + off, ok);
        rt::cp_async16(Vs + (st * kColsTC + col) * LD + ch, v_pool + off, ok);
      }
    }
  };

  if (n_kt > 0) load_kv(0, 0);
  rt::cp_async_commit();

  uint32_t qa[KC][4];
  float o[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m0 = rt::kNeg, m1 = rt::kNeg, l0 = 0.f, l1 = 0.f;  // l: this lane's share of the row sum

  for (int t = 0; t < n_kt; ++t) {
    const int st = t & 1;                  // staging stage of tile t
    const int sb = Q ? 0 : st;             // its bf16 tiles
    if (t + 1 < n_kt) load_kv(st ^ 1, t + 1);
    rt::cp_async_commit();
    rt::cp_async_wait_1();  // tile t (and q) landed; tile t + 1 may be in flight
    __syncthreads();
    if constexpr (Q) {  // widen tile t's codes to bf16 once for all four warps
      for (int e = threadIdx.x; e < kColsTC * CQ; e += kThreadsTC) {
        const int col = e / CQ, ch = (e % CQ) * 16;
        widen_codes(Ks + col * LD + ch,
                    *reinterpret_cast<const uint4*>(Kq + (st * kColsTC + col) * HD + ch));
        widen_codes(Vs + col * LD + ch,
                    *reinterpret_cast<const uint4*>(Vq + (st * kColsTC + col) * HD + ch));
      }
      __syncthreads();
    }
    if (t == 0) {
#pragma unroll
      for (int cc = 0; cc < KC; ++cc) {
        const __nv_bfloat16* qr = Qs + (warp * 16 + gr) * LD + cc * 16 + 2 * t4;
        qa[cc][0] = *reinterpret_cast<const uint32_t*>(qr);
        qa[cc][1] = *reinterpret_cast<const uint32_t*>(qr + 8 * LD);
        qa[cc][2] = *reinterpret_cast<const uint32_t*>(qr + 8);
        qa[cc][3] = *reinterpret_cast<const uint32_t*>(qr + 8 * LD + 8);
      }
    }
    const int kv0 = t * kColsTC;
    if (kv0 < w_hi) {  // else no row of this warp sees a column of the tile
      const __nv_bfloat16* Kt = Ks + sb * kColsTC * LD;
      const __nv_bfloat16* Vt = Vs + sb * kColsTC * LD;
      const int mq = lane >> 3, mr = lane & 7;  // the ldmatrix row this lane names
      float sc[8][4];  // 16 rows x 64 columns: n-tile j holds columns 8j..8j+7
#pragma unroll
      for (int j = 0; j < 8; ++j) sc[j][0] = sc[j][1] = sc[j][2] = sc[j][3] = 0.f;
#pragma unroll
      for (int cc = 0; cc < KC; ++cc) {
#pragma unroll
        for (int j = 0; j < 8; j += 2) {  // columns of n-tiles j, j+1; hd halves of chunk cc
          uint32_t kf[4];
          rt::ldsm_x4<false>(kf, Kt + ((j + (mq >> 1)) * 8 + mr) * LD + cc * 16 + (mq & 1) * 8);
          rt::mma_bf16(sc[j], qa[cc], kf[0], kf[1]);
          rt::mma_bf16(sc[j + 1], qa[cc], kf[2], kf[3]);
        }
      }
      // scores in log2 units: p = 2^(s * scale * log2 e - m); int8: s *= the page's k scale
      const bool masked = kv0 + kColsTC > w_lo;
      float mx0 = rt::kNeg, mx1 = rt::kNeg;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = j * 8 + 2 * t4 + (e & 1);
          float v = sc[j][e] * scale_log2;
          if constexpr (Q) v = sc[j][e] * ksc[st * kColsTC + col] * scale_log2;
          const bool ok = !masked || kv0 + col < (e < 2 ? f0 : f1);
          sc[j][e] = ok ? v : rt::kNeg;
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
          sc[j][e] = sc[j][e] == rt::kNeg ? 0.f : p;
        }
        ps0 += sc[j][0] + sc[j][1];
        ps1 += sc[j][2] + sc[j][3];
        if constexpr (Q) {  // P V takes p times the page's v scale
#pragma unroll
          for (int e = 0; e < 4; ++e) sc[j][e] *= vsc[st * kColsTC + j * 8 + 2 * t4 + (e & 1)];
        }
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
      for (int cc = 0; cc < 4; ++cc) {  // 16 columns at a time: C fragments of n-tiles 2cc, 2cc+1
        const uint32_t pa[4] = {rt::pack_bf16(sc[2 * cc][0], sc[2 * cc][1]),
                                rt::pack_bf16(sc[2 * cc][2], sc[2 * cc][3]),
                                rt::pack_bf16(sc[2 * cc + 1][0], sc[2 * cc + 1][1]),
                                rt::pack_bf16(sc[2 * cc + 1][2], sc[2 * cc + 1][3])};
#pragma unroll
        for (int n = 0; n < NT; n += 2) {  // hd columns of n-tiles n, n+1; key halves of cc
          uint32_t vf[4];
          rt::ldsm_x4<true>(vf, Vt + (cc * 16 + (mq & 1) * 8 + mr) * LD + (n + (mq >> 1)) * 8);
          rt::mma_bf16(o[n], pa, vf[0], vf[1]);
          rt::mma_bf16(o[n + 1], pa, vf[2], vf[3]);
        }
      }
    }
    __syncthreads();  // everyone is done with tile t before its buffers are refilled
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
    if (row >= rows) continue;
    const int i = row / g;
    const float d = half ? d1 : d0;
    __nv_bfloat16* orow =
        out + ((static_cast<size_t>(b) * c + i) * hkv * g + h * g + (row - i * g)) * HD;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      *reinterpret_cast<uint32_t*>(orow + n * 8 + 2 * t4) =
          rt::pack_bf16(o[n][2 * half] / d, o[n][2 * half + 1] / d);
    }
  }
}

template <int HD, bool Q>
cudaError_t launch_tc(const void* q, const void* k_pool, const void* v_pool, const void* k_scale,
                      const void* v_scale, const void* table, const void* qoff, const void* vl,
                      void* out, int B, int C, int n_blocks, int page, int hkv, int g,
                      int n_pages, cudaStream_t stream) {
  using Code = rt::code_t<__nv_bfloat16, Q>;
  auto kernel = paged_prefill_tc_kernel<HD, Q>;
  const size_t smem = TcSmem<HD, Q>::kBytes;
  cudaError_t err = rt::allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  dim3 grid(B * hkv, (C * g + kRowsTC - 1) / kRowsTC);
  kernel<<<grid, kThreadsTC, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const Code*>(k_pool),
      static_cast<const Code*>(v_pool), static_cast<const float*>(k_scale),
      static_cast<const float*>(v_scale), static_cast<const int32_t*>(table),
      static_cast<const int32_t*>(qoff), static_cast<const int32_t*>(vl),
      static_cast<__nv_bfloat16*>(out), n_blocks, page, hkv, g, C, n_pages,
      kLog2e / sqrtf(static_cast<float>(HD)));
  return cudaGetLastError();
}

template <typename T, bool Q, int E>
cudaError_t launch(const void* q, const void* k_pool, const void* v_pool, const void* k_scale,
                   const void* v_scale, const void* table, const void* qoff, const void* vl,
                   void* out, int B, int C, int n_blocks, int page, int hkv, int hd, int g,
                   int n_pages, cudaStream_t stream) {
  using Code = rt::code_t<T, Q>;
  if (Q && (k_scale == nullptr || v_scale == nullptr)) return cudaErrorInvalidValue;
  const size_t smem = 2 * static_cast<size_t>(page) * hd * sizeof(float);
  auto kernel = paged_prefill_kernel<T, Code, E>;
  cudaError_t err = rt::allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const int rows = C * g;
  dim3 grid(B, hkv, (rows + kWarps - 1) / kWarps);
  kernel<<<grid, 32 * kWarps, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const Code*>(k_pool),
      static_cast<const Code*>(v_pool), static_cast<const float*>(k_scale),
      static_cast<const float*>(v_scale), static_cast<const int32_t*>(table),
      static_cast<const int32_t*>(qoff), static_cast<const int32_t*>(vl), static_cast<T*>(out),
      n_blocks, page, hkv, hd, g, C, n_pages, 1.0f / sqrtf(static_cast<float>(hd)));
  return cudaGetLastError();
}

template <bool Q>
cudaError_t dispatch(const void* q, const void* k_pool, const void* v_pool, const void* k_scale,
                     const void* v_scale, const void* table, const void* qoff, const void* vl,
                     void* out, int B, int C, int n_blocks, int page, int hkv, int hd, int g,
                     int n_pages, int dtype, cudaStream_t stream) {
  if (Q && (k_scale == nullptr || v_scale == nullptr)) return cudaErrorInvalidValue;
  if (dtype == RT_BF16) {
#define RT_TC(HD)                                                                          \
  if (hd == HD)                                                                            \
    return launch_tc<HD, Q>(q, k_pool, v_pool, k_scale, v_scale, table, qoff, vl, out, B, C, \
                            n_blocks, page, hkv, g, n_pages, stream);
    RT_TC(16) RT_TC(32) RT_TC(64) RT_TC(128)
#undef RT_TC
  }
  RT_DISPATCH_ATTENTION(launch, Q, dtype, hd, q, k_pool, v_pool, k_scale, v_scale, table, qoff,
                        vl, out, B, C, n_blocks, page, hkv, hd, g, n_pages, stream);
}

}  // namespace

extern "C" int rt_paged_prefill_attention(const void* q, const void* k_pool,
                                          const void* v_pool, const void* table,
                                          const void* q_offset, const void* kv_valid_len,
                                          void* out, int B, int C, int n_blocks, int page,
                                          int hkv, int hd, int g, int n_pages, int dtype,
                                          void* stream) {
  return static_cast<int>(dispatch<false>(q, k_pool, v_pool, nullptr, nullptr, table,
                                          q_offset, kv_valid_len, out, B, C, n_blocks, page,
                                          hkv, hd, g, n_pages, dtype,
                                          static_cast<cudaStream_t>(stream)));
}

extern "C" int rt_paged_prefill_attention_q(const void* q, const void* k_pool,
                                            const void* v_pool, const void* k_scale,
                                            const void* v_scale, const void* table,
                                            const void* q_offset, const void* kv_valid_len,
                                            void* out, int B, int C, int n_blocks, int page,
                                            int hkv, int hd, int g, int n_pages, int dtype,
                                            void* stream) {
  return static_cast<int>(dispatch<true>(q, k_pool, v_pool, k_scale, v_scale, table, q_offset,
                                         kv_valid_len, out, B, C, n_blocks, page, hkv, hd, g,
                                         n_pages, dtype, static_cast<cudaStream_t>(stream)));
}
