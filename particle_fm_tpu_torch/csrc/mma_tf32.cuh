// Split-precision TF32 on mma.sync.aligned.m16n8k8 for sm_90a: what the
// tensor-core kernels of this directory share (attention_mma.cuh, the tile
// step of the attention kernels; epic_layer.cu, the EPiC layer's local
// matmuls).
//
// Split precision. The matrix unit reads the sign, the exponent and the upper
// 10 mantissa bits of a float32 operand: one TF32 product keeps three decimal
// digits, and the kernels are held to 1e-4 against float32. So every operand
// is split into a TF32 head and the remainder, hi = x rounded to 10 mantissa
// bits (to nearest, ties away from zero) and lo = x - hi (exact in float32;
// the unit reads its upper bits), and every float32 product is three TF32
// products, small terms first: lo.hi + hi.lo + hi.hi. What is dropped, the
// lo.lo term and the last bits of lo, is 2^-21 of the product
// (ops/tf32.py models this arithmetic). The head is an integer add and an
// AND: cvt.rna.tf32.f32 computes the same through the narrow conversion unit
// and is slower; the AND alone, rounding towards zero, is faster and less
// exact (attention_mma.cuh has the times and errors).
//
// Fragments of m16n8k8 in TF32 (g = lane / 4, t = lane % 4):
//   A  a0 (g, t)  a1 (g+8, t)  a2 (g, t+4)  a3 (g+8, t+4)
//   B  b0 (k=t, n=g)  b1 (k=t+4, n=g)
//   C  c0 (g, 2t)  c1 (g, 2t+1)  c2 (g+8, 2t)  c3 (g+8, 2t+1)

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMmaProducts = 3;  // TF32 products per float32 product (mma_3xtf32)
#define MMA_TF32_INSTRUCTION "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32"

struct Tf32 {
  uint32_t hi, lo;
};

__device__ __forceinline__ Tf32 split_tf32(float x) {
  Tf32 r;
  r.hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  r.lo = __float_as_uint(x - __uint_as_float(r.hi));
  return r;
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      MMA_TF32_INSTRUCTION
      " {%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += a . b in float32: three TF32 products, small terms first
__device__ __forceinline__ void mma_3xtf32(float (&c)[4], const uint32_t (&a_hi)[4],
                                           const uint32_t (&a_lo)[4], Tf32 b0, Tf32 b1) {
  static_assert(kMmaProducts == 3, "one mma_tf32 below per product");
  mma_tf32(c, a_lo, b0.hi, b1.hi);
  mma_tf32(c, a_hi, b0.lo, b1.lo);
  mma_tf32(c, a_hi, b0.hi, b1.hi);
}

// c[mt][nt] += a[mt] . b[nt] over a warp's tile of MT x NT fragments, each
// float32 product as three TF32 products, small terms first, as mma_3xtf32
// does. The instructions are issued product by product over the whole tile:
// the three into one accumulator depend on each other, and an mma.sync waits
// for the one before it into the same accumulator (the asm statements keep
// their order), so only the independent ones between them hide its latency.
// No branch may sit between them: a guard per fragment made the compiler wrap
// every mma.sync in a warp synchronisation of its own, and none overlapped.
template <int MT, int NT>
__device__ __forceinline__ void mma_3xtf32_tile(float (&c)[MT][NT][4],
                                                const uint32_t (&a_hi)[MT][4],
                                                const uint32_t (&a_lo)[MT][4],
                                                const Tf32 (&b0)[NT], const Tf32 (&b1)[NT]) {
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) mma_tf32(c[mt][nt], a_lo[mt], b0[nt].hi, b1[nt].hi);
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) mma_tf32(c[mt][nt], a_hi[mt], b0[nt].lo, b1[nt].lo);
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) mma_tf32(c[mt][nt], a_hi[mt], b0[nt].hi, b1[nt].hi);
}

}  // namespace
