// bfloat16 on mma.sync.aligned.m16n8k16 for sm_90a: what the bfloat16
// tensor-core kernels of this directory share (epic_layer.cu, the EPiC
// layer's local products; attention_mma.cuh, the bfloat16 tile step of the
// packed and flash kernels).
//
// A bfloat16 product is exact in float32 and the instruction accumulates in
// float32, so one instruction computes what the Pallas kernels' bfloat16
// `jnp.dot(..., preferred_element_type=float32)` computes, up to the order of
// the sum: one product per product, where float32 operands take three TF32
// products (mma_tf32.cuh).
//
// Fragments of m16n8k16 in bfloat16 (g = lane / 4, t = lane % 4; each 32-bit
// register holds two neighbouring elements, the lower index in the lower
// half):
//   A  a[0] (g, 2t..2t+1)   a[1] (g+8, 2t..2t+1)   a[2] (g, 2t+8..)   a[3] (g+8, 2t+8..)
//   B  b[0] (k=2t..2t+1, n=g)   b[1] (k=2t+8..2t+9, n=g)
//   C  c0 c1 (g, 2t..2t+1)   c2 c3 (g+8, 2t..2t+1)
// ldmatrix loads four 8 x 8 bfloat16 matrices from shared memory, lanes
// 8i .. 8i+7 giving the row addresses of matrix i (16 bytes each, on 16
// bytes); a lane receives row g, columns 2t..2t+1 of each, or with .trans
// rows 2t..2t+1 of column g. So from a row-major 16 x 16 tile with lane l
// pointing at row (l & 15), column 8 (l >> 4):
//   ldmatrix_x4        gives A's four registers;
//   ldmatrix_x4_trans  gives B's two registers for the n8 tile of columns
//                      0..7 (r[0], r[1]) and for columns 8..15 (r[2], r[3]),
//                      where the tile holds B itself (k rows, n columns).
// A tile that holds B transposed (n rows, k columns, as K's rows hold Q . K^T's
// B) is read without .trans, lane l pointing at row (l & 7) + 8 (l >> 4),
// column 8 ((l >> 3) & 1): r[0], r[1] for rows 0..7 and r[2], r[3] for rows
// 8..15.
// Rows of a tile in shared memory sit 8 bfloat16 (16 bytes) beyond a multiple
// of 16 elements apart: 8 rows of 16 bytes then fall on 32 different banks.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

#define MMA_BF16_INSTRUCTION "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32"

// c += a . b, one product per product
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      MMA_BF16_INSTRUCTION
      " {%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const __nv_bfloat16* row) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(row));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const __nv_bfloat16* row) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(row));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

// Two floats, each rounded to the nearest bfloat16 (ties to even, as a cast
// in JAX or PyTorch rounds), in one register: `lo` in the lower half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// float -> bfloat16 -> float: the value a cast to bfloat16 keeps
__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

}  // namespace
