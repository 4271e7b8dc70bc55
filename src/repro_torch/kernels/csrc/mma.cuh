// Tensor-core helpers shared by the mma.sync kernels (flash_attention.cu,
// prefill_attention.cu, fused_linear_q.cu): bf16 packing, ldmatrix and the
// m16n8k16 bf16 product with float32 accumulators.
//
// Fragment layout of mma.sync.m16n8k16 (lane = 4 * gr + t4):
//   A (16 x 16, row-major): a[0] row gr, cols 2t4..2t4+1; a[1] row gr + 8,
//     same cols; a[2] row gr, cols 2t4+8..+9; a[3] row gr + 8, cols 2t4+8..+9;
//   B (16 x 8, "col"): b0 rows 2t4..2t4+1 of col gr, b1 rows 2t4+8..+9;
//   C/D (16 x 8): d[0..1] row gr, cols 2t4..2t4+1; d[2..3] row gr + 8.
// Each 32-bit register holds two bf16, the lower index in the low half.
#pragma once

#include "common.cuh"

namespace rt {

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x (lo) in the low half
  return *reinterpret_cast<uint32_t*>(&v);
}

// Four 8x8 bf16 matrices from shared memory, lanes 8q..8q+7 naming the rows
// of matrix q; r[q] is matrix q's mma fragment (transposed with TRANS).
template <bool TRANS>
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const __nv_bfloat16* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  if (TRANS)
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(a));
  else
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(a));
}

// d += a b: a 16x16 bf16 row-major A, a 16x8 bf16 column-major B, float32 C.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

}  // namespace rt
