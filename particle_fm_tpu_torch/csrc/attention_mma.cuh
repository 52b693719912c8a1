// The streaming-softmax tile step of the attention kernels on the tensor
// cores (short_attention.cu: packed; flash_attention.cu: more than 4 query
// rows, head dims up to 64). float32 in and out, sm_90a.
//
// Instruction: mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32. A warp
// owns a tile of 16 query rows and walks over the staged keys 8 at a time:
//
//   S (16 x 8)   = Q (16 x D) . K^T (D x 8)      D / 8 steps over the head dim
//   s            = S * scale + madd (+ bias)      float32, on the accumulator
//   m, l, O      rescaled by exp(m_old - m_new); p = exp(s - m_new); l += p
//   O (16 x D)  += P (16 x 8) . V (8 x D)         D / 8 tiles of 8 columns
//
// Split precision (mma_tf32.cuh): every float32 product is three TF32
// products, lo.hi + hi.lo + hi.hi. P . V needs the three as much as Q . K
// does: with two the result misses 1e-4 (ops/attention_tf32.py models this
// arithmetic; tests/test_torch_port_attention_tf32.py). Q is split once, into
// registers that stay for the whole key loop. K and V are split where a
// fragment is loaded from shared memory, by every warp that reads it: staging
// them split would double their shared memory, and the packed kernel at
// L=256, D=64 would no longer fit a block.
//
// Fragments: mma_tf32.cuh. S comes out in the C layout, P . V wants P in the A layout. No lane
// exchanges anything: a sum over keys does not care about their order, so
// C's columns 2t and 2t+1 are taken as A's columns t and t+4, and V's B
// fragment is loaded from keys 2t and 2t+1 accordingly.
//
// Shared memory: K and V rows at a stride of D+4 floats. K's fragment reads
// (key g, column t): 8 rows 4(D/4+1) banks apart, 4 neighbouring banks each.
// V's reads (key 2t or 2t+1, column g): 4 rows 8(D/4+1) banks apart, 8
// neighbouring banks each. Both hit 32 different banks for D = 8, 16, 32, 64.
//
// What sets the pace (NVIDIA H100 80GB HBM3, 700 W;
// scripts/attention_mma_variants.py times these versions in turns; ms at the
// packed kernel's served shape, B=640, L=150, 16 heads of 16, and at the flash
// kernel's, B=256, Lq=Lk=279, 16 heads of 16). As committed: 0.413 and 0.560.
// With one product in place of three 0.307 and 0.428: the 8 mma that go cost
// some 7 cycles of an SM quarter each at the boost clock, and they add to the
// other instructions' issue slots instead of hiding behind them. So the 12
// mma for 16 rows x 8 keys are about half of a step; the rest is the count of
// the other instructions, and how many warps an SM holds to hide their
// latencies:
//   - 8 keys per softmax step in place of 16 (one update of the maximum and
//     one rescale for two tiles): 0.454 and 0.650. Head dims above 16 take 8,
//     16 would spill there.
//   - the packed kernel without its cap of 64 registers (88: two blocks of 10
//     warps to an SM in place of three): 0.480.
//   - the head by cvt.rna.tf32.f32: 0.469 and 0.637. By the AND alone: 0.392
//     and 0.540, with errors of 5.8e-6 and 8.5e-6 in place of 3.6e-6 and
//     5.7e-6 at unit scale, against a tolerance of 1e-4.
// Two row tiles per warp, which share every K and V fragment, need twice the
// registers and lost. wgmma was not timed: for TF32 it wants both operands
// K-major in shared memory (V transposed while staging), and its 64-row tile
// wastes more of 150 and 279 rows.

#pragma once

#include "attention_common.cuh"
#include "mma_bf16.cuh"
#include "mma_tf32.cuh"

namespace {

constexpr int kMmaRows = 16;     // query rows of a warp's tile
constexpr int kMmaKeys = 8;      // keys of one tile of scores

// 8-key tiles per softmax step: they share one update of the maximum and one
// rescale of the accumulator.
__host__ __device__ constexpr int mma_key_tiles(int dp) { return dp <= 16 ? 2 : 1; }

// 2^x for x <= 0 or -inf (gives 0); 2^0 is exactly 1
__device__ __forceinline__ float exp2_neg(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// What a warp keeps in registers for its tile of 16 query rows: Q's head and
// remainder fragments, the accumulator O in the C layout, and per row
// (half 0: row g, half 1: row g+8) the running maximum and this lane's share
// of the running sum (keys 2t and 2t+1 of every tile).
template <int DP>
struct MmaTile {
  uint32_t q_hi[DP / 8][4], q_lo[DP / 8][4];
  float o[DP / 8][4];
  float m[2], l[2];
};

// Rows row0 .. row0 + 15 of one head of q (row distance ld, d wide); rows
// past last_row repeat last_row (they are computed and not stored).
template <int DP>
__device__ __forceinline__ void mma_tile_init(MmaTile<DP>& t, const float* qhead, long long ld,
                                              int row0, int last_row, int d, float m_init) {
  const int g = (threadIdx.x & 31) >> 2, tt = threadIdx.x & 3;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const float* qrow = qhead + min(row0 + 8 * half + g, last_row) * ld;
#pragma unroll
    for (int kk = 0; kk < DP / 8; ++kk) {
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int col = 8 * kk + 4 * c + tt;
        const Tf32 x = split_tf32(col < d ? qrow[col] : 0.f);
        t.q_hi[kk][half + 2 * c] = x.hi;
        t.q_lo[kk][half + 2 * c] = x.lo;
      }
    }
    t.m[half] = m_init;
    t.l[half] = 0.f;
  }
#pragma unroll
  for (int n = 0; n < DP / 8; ++n) {
#pragma unroll
    for (int i = 0; i < 4; ++i) t.o[n][i] = 0.f;
  }
}

struct NoBias {
  static constexpr bool kOn = false;
  __device__ __forceinline__ float operator()(int, int) const { return 0.f; }
};

// One softmax step over the 8 KT staged keys from `key0` on. `ks`, `vs`: the
// staged K and V rows in shared memory (row stride DP+4 floats); `madd`:
// their additive mask (-inf past the set's end; the step's first key is a key
// of the set, so the step's maximum is finite); `bias(row_in_tile, key)`:
// what else is added to that score.
template <int DP, int KT, typename Bias>
__device__ __forceinline__ void mma_softmax_step(MmaTile<DP>& t, const float* ks, const float* vs,
                                                 const float* madd, int key0, float scale,
                                                 Bias bias) {
  constexpr int ST = DP + 4;
  const int g = (threadIdx.x & 31) >> 2, tt = threadIdx.x & 3;
  ks += key0 * ST;
  vs += key0 * ST;
  madd += key0;

  // S = Q . K^T
  float s[KT][4];
#pragma unroll
  for (int kt = 0; kt < KT; ++kt) {
#pragma unroll
    for (int i = 0; i < 4; ++i) s[kt][i] = 0.f;
    const float* krow = ks + (kMmaKeys * kt + g) * ST + tt;
#pragma unroll
    for (int kk = 0; kk < DP / 8; ++kk)
      mma_3xtf32(s[kt], t.q_hi[kk], t.q_lo[kk], split_tf32(krow[8 * kk]),
                 split_tf32(krow[8 * kk + 4]));
  }

  // scale, mask and bias in float32 on the accumulated score; the rows' maxima
  float mx[2] = {-CUDART_INF_F, -CUDART_INF_F};
#pragma unroll
  for (int kt = 0; kt < KT; ++kt) {
    const int key = kMmaKeys * kt + 2 * tt;
    const float2 ma = *reinterpret_cast<const float2*>(madd + key);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float sc = fmaf(s[kt][i], scale, (i & 1) ? ma.y : ma.x);
      if (Bias::kOn) sc += bias(8 * (i >> 1), key0 + key + (i & 1));
      s[kt][i] = sc;
      mx[i >> 1] = fmaxf(mx[i >> 1], sc);
    }
  }
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    float x = mx[half];  // over the four lanes that share the row
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
    x = fmaxf(x, t.m[half]);
    const float corr = exp2_neg((t.m[half] - x) * kLog2e);
    t.m[half] = x;
    t.l[half] *= corr;
#pragma unroll
    for (int n = 0; n < DP / 8; ++n) {
      t.o[n][2 * half] *= corr;
      t.o[n][2 * half + 1] *= corr;
    }
  }

  // p = exp(s - m), the log2 e factor applied after the mask was added; O += P . V
#pragma unroll
  for (int kt = 0; kt < KT; ++kt) {
    uint32_t p_hi[4], p_lo[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float p = exp2_neg((s[kt][i] - t.m[i >> 1]) * kLog2e);
      t.l[i >> 1] += p;
      // C's (row, key 2t | 2t+1) is A's (row, column t | t+4): c0 c1 c2 c3 -> a0 a2 a1 a3
      const int a = (i >> 1) + 2 * (i & 1);
      const Tf32 x = split_tf32(p);
      p_hi[a] = x.hi;
      p_lo[a] = x.lo;
    }
    const float* v0 = vs + (kMmaKeys * kt + 2 * tt) * ST + g;
#pragma unroll
    for (int n = 0; n < DP / 8; ++n)
      mma_3xtf32(t.o[n], p_hi, p_lo, split_tf32(v0[8 * n]), split_tf32(v0[ST + 8 * n]));
  }
}

// The staged keys 0 .. n_p - 1 (n_p a multiple of 8): steps of 8 KT keys, then
// steps of 8.
template <int DP, typename Bias>
__device__ __forceinline__ void mma_softmax_keys(MmaTile<DP>& t, const float* ks, const float* vs,
                                                 const float* madd, int n_p, float scale,
                                                 Bias bias) {
  constexpr int KT = mma_key_tiles(DP);
  int key0 = 0;
  for (; key0 + kMmaKeys * KT <= n_p; key0 += kMmaKeys * KT)
    mma_softmax_step<DP, KT>(t, ks, vs, madd, key0, scale, bias);
  if constexpr (KT > 1) {
    for (; key0 < n_p; key0 += kMmaKeys)
      mma_softmax_step<DP, 1>(t, ks, vs, madd, key0, scale, bias);
  }
}

// The running sum of row `half`, summed over the four lanes that share it.
template <int DP>
__device__ __forceinline__ float mma_row_sum(const MmaTile<DP>& t, int half) {
  float l = t.l[half];
  l += __shfl_xor_sync(0xffffffffu, l, 1);
  l += __shfl_xor_sync(0xffffffffu, l, 2);
  return l;
}

// This lane's columns of row `half` of O times f, to a row of d floats.
template <int DP>
__device__ __forceinline__ void mma_store_row(const MmaTile<DP>& t, int half, float f, float* orow,
                                              int d) {
  const int tt = threadIdx.x & 3;
#pragma unroll
  for (int n = 0; n < DP / 8; ++n) {
    const int col = 8 * n + 2 * tt;
    const float x0 = t.o[n][2 * half] * f, x1 = t.o[n][2 * half + 1] * f;
    if (d % 2 == 0) {
      if (col < d) *reinterpret_cast<float2*>(orow + col) = make_float2(x0, x1);
    } else {
      if (col < d) orow[col] = x0;
      if (col + 1 < d) orow[col + 1] = x1;
    }
  }
}

// What a launcher gave, or would give, a block of a kernel on this tile step,
// for the `*_geometry` entry points: the Python wrappers mirror these numbers
// (for the shared-memory check and the key split), and chip_smoke.py and the
// kernel tests hold the mirrors against them.
template <typename Kernel>
cudaError_t mma_report(Kernel kernel, int blocks, int warps, int keys, size_t smem, int* out) {
  cudaFuncAttributes attr;
  const cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return err;
  const int report[6] = {blocks, warps, keys, (int)smem, attr.numRegs, kMmaProducts};
  for (int i = 0; i < 6; ++i) out[i] = report[i];
  return cudaSuccess;
}

// Keys of a set's additive mask into shared memory: 0 for a real key, -1e9
// for a masked one, -inf from `n` on (keys past the range take no weight).
__device__ __forceinline__ void stage_mask(float* madd, const float* mask_row, int n, int n_p) {
  for (int j = threadIdx.x; j < n_p; j += blockDim.x) {
    float a = -CUDART_INF_F;
    if (j < n) a = mask_row ? (mask_row[j] - 1.f) * kNeg : 0.f;
    madd[j] = a;
  }
}

// ---------------------------------------------------------------------------
// bfloat16 operands: the tile step of the packed and flash kernels' bfloat16
// variants (instruction: mma_bf16.cuh's m16n8k16). A warp owns 16 query rows,
// Q's bfloat16 A fragments stay in registers, and the staged keys are taken
// 16 at a time:
//
//   S (16 x 16)  = Q (16 x DP) . K^T      DP / 16 steps, 2 mma each (two n8 key tiles)
//   s            = S * scale + madd (+ bias), float32 on the accumulator
//
// K and V sit in shared memory as bfloat16 rows at a stride of DP + 8
// elements (DP: the head dim padded to 16, 32 or 64; rows 16 bytes beyond a
// multiple of 32 bytes apart), read by ldmatrix: K without .trans (its rows
// are B's columns), V with .trans. What follows S differs by kernel:
//   packed (`packed_bf16_keys`): two passes over the keys, the first for the
//     rows' maxima, the second recomputing S (the same instructions in the
//     same order: the same values) for p = exp(s - max), the sum of the
//     unrounded p, and O += bf16(P) . V as bfloat16 products, P taken from the
//     accumulator's registers as A without any exchange (C's key tiles 0 and
//     1 are A's columns 0..7 and 8..15). That is the Pallas `_packed_kernel`
//     on bfloat16 (short_attention.py:187-206): the softmax over the whole row
//     before P is rounded, the normalisation after PV.
//   flash (`flash_bf16_step`): the streaming softmax over steps of 16 keys, P
//     kept in float32 as the Pallas flash kernel keeps it
//     (flash_attention.py:31-54): O += P . V as two TF32 products on
//     m16n8k8, the head and the remainder of P, V exact in TF32 (a bfloat16
//     has 8 bits of mantissa). The dropped part is the remainder's last bits,
//     2^-21 of P.

using bf16 = __nv_bfloat16;

constexpr int kBfKeys = 16;  // keys of a step
constexpr int kBfTf32Products = 2;  // TF32 products of P . V in the flash variant

// The head dim a bfloat16 variant is compiled for: 16, 32 or 64.
__host__ __device__ constexpr int bf16_head_dim(int dp) { return dp < 16 ? 16 : dp; }

template <int DP>
struct MmaTileBf16 {
  uint32_t q[DP / 16][4];
  float o[DP / 8][4];
  float m[2], l[2];
};

__device__ __forceinline__ uint32_t pack_raw_bf16(bf16 lo, bf16 hi) {
  return (uint32_t)__bfloat16_as_ushort(lo) | ((uint32_t)__bfloat16_as_ushort(hi) << 16);
}

// Rows row0 .. row0 + 15 of one head of q (row distance ld, d wide) as A
// fragments; rows past last_row repeat it.
template <int DP>
__device__ __forceinline__ void mma_tile_init_bf16(MmaTileBf16<DP>& t, const bf16* qhead,
                                                   long long ld, int row0, int last_row, int d,
                                                   float m_init) {
  const int g = (threadIdx.x & 31) >> 2, tt = threadIdx.x & 3;
  const bf16 zero = __float2bfloat16_rn(0.f);
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const bf16* qrow = qhead + min(row0 + 8 * half + g, last_row) * ld;
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int col = 16 * kk + 8 * c + 2 * tt;
        t.q[kk][half + 2 * c] =
            pack_raw_bf16(col < d ? qrow[col] : zero, col + 1 < d ? qrow[col + 1] : zero);
      }
    }
    t.m[half] = m_init;
    t.l[half] = 0.f;
  }
#pragma unroll
  for (int n = 0; n < DP / 8; ++n) {
#pragma unroll
    for (int i = 0; i < 4; ++i) t.o[n][i] = 0.f;
  }
}

// s[kt][i] = the scores of keys key0 + 8 kt + 2 tt + (i & 1) for row g + 8 (i >> 1)
// of the tile, scaled, masked and biased; returns nothing else.
template <int DP, typename Bias>
__device__ __forceinline__ void mma_scores_bf16(float (&s)[2][4], const MmaTileBf16<DP>& t,
                                                const bf16* ks, const float* madd, int key0,
                                                float scale, Bias bias) {
  constexpr int ST = DP + 8;
  const int lane = threadIdx.x & 31, tt = lane & 3;
  const bf16* krow = ks + (key0 + (lane & 7) + 8 * (lane >> 4)) * ST + 8 * ((lane >> 3) & 1);
#pragma unroll
  for (int kt = 0; kt < 2; ++kt)
#pragma unroll
    for (int i = 0; i < 4; ++i) s[kt][i] = 0.f;
#pragma unroll
  for (int kk = 0; kk < DP / 16; ++kk) {
    uint32_t b[4];
    ldmatrix_x4(b, krow + 16 * kk);
    mma_bf16(s[0], t.q[kk], b[0], b[1]);
    mma_bf16(s[1], t.q[kk], b[2], b[3]);
  }
#pragma unroll
  for (int kt = 0; kt < 2; ++kt) {
    const int key = key0 + 8 * kt + 2 * tt;
    const float2 ma = *reinterpret_cast<const float2*>(madd + key);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float sc = fmaf(s[kt][i], scale, (i & 1) ? ma.y : ma.x);
      if (Bias::kOn) sc += bias(8 * (i >> 1), key + (i & 1));
      s[kt][i] = sc;
    }
  }
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

// The packed kernel's softmax over the staged keys 0 .. n_p - 1 (n_p a
// multiple of 16): the rows' maxima, then p, its sum and O += bf16(P) . V.
template <int DP, typename Bias>
__device__ __forceinline__ void packed_bf16_keys(MmaTileBf16<DP>& t, const bf16* ks,
                                                 const bf16* vs, const float* madd, int n_p,
                                                 float scale, Bias bias) {
  constexpr int ST = DP + 8;
  const int lane = threadIdx.x & 31;
  float mx[2] = {-CUDART_INF_F, -CUDART_INF_F};
  for (int key0 = 0; key0 < n_p; key0 += kBfKeys) {
    float s[2][4];
    mma_scores_bf16(s, t, ks, madd, key0, scale, bias);
#pragma unroll
    for (int kt = 0; kt < 2; ++kt)
#pragma unroll
      for (int i = 0; i < 4; ++i) mx[i >> 1] = fmaxf(mx[i >> 1], s[kt][i]);
  }
  t.m[0] = quad_max(mx[0]);
  t.m[1] = quad_max(mx[1]);

  const bf16* vrow = vs + (lane & 15) * ST + 8 * (lane >> 4);
  for (int key0 = 0; key0 < n_p; key0 += kBfKeys) {
    float s[2][4];
    mma_scores_bf16(s, t, ks, madd, key0, scale, bias);
    float p[2][4];
#pragma unroll
    for (int kt = 0; kt < 2; ++kt)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        p[kt][i] = exp2_neg((s[kt][i] - t.m[i >> 1]) * kLog2e);
        t.l[i >> 1] += p[kt][i];
      }
    const uint32_t a[4] = {pack_bf16(p[0][0], p[0][1]), pack_bf16(p[0][2], p[0][3]),
                           pack_bf16(p[1][0], p[1][1]), pack_bf16(p[1][2], p[1][3])};
#pragma unroll
    for (int np = 0; np < DP / 16; ++np) {
      uint32_t b[4];
      ldmatrix_x4_trans(b, vrow + key0 * ST + 16 * np);
      mma_bf16(t.o[2 * np], a, b[0], b[1]);
      mma_bf16(t.o[2 * np + 1], a, b[2], b[3]);
    }
  }
}

// One step of the flash kernel's streaming softmax over the 16 staged keys
// from key0 on (the step's first key is a key of the range, so its maximum is
// finite).
template <int DP>
__device__ __forceinline__ void flash_bf16_step(MmaTileBf16<DP>& t, const bf16* ks,
                                                const bf16* vs, const float* madd, int key0,
                                                float scale) {
  constexpr int ST = DP + 8;
  const int g = (threadIdx.x & 31) >> 2, tt = threadIdx.x & 3;
  float s[2][4];
  mma_scores_bf16(s, t, ks, madd, key0, scale, NoBias{});
  float mx[2] = {-CUDART_INF_F, -CUDART_INF_F};
#pragma unroll
  for (int kt = 0; kt < 2; ++kt)
#pragma unroll
    for (int i = 0; i < 4; ++i) mx[i >> 1] = fmaxf(mx[i >> 1], s[kt][i]);
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const float x = fmaxf(quad_max(mx[half]), t.m[half]);
    const float corr = exp2_neg((t.m[half] - x) * kLog2e);
    t.m[half] = x;
    t.l[half] *= corr;
#pragma unroll
    for (int n = 0; n < DP / 8; ++n) {
      t.o[n][2 * half] *= corr;
      t.o[n][2 * half + 1] *= corr;
    }
  }
#pragma unroll
  for (int kt = 0; kt < 2; ++kt) {
    uint32_t p_hi[4], p_lo[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float p = exp2_neg((s[kt][i] - t.m[i >> 1]) * kLog2e);
      t.l[i >> 1] += p;
      // C's (row, key 2t | 2t+1) is A's (row, column t | t+4): c0 c1 c2 c3 -> a0 a2 a1 a3
      const int a = (i >> 1) + 2 * (i & 1);
      const Tf32 x = split_tf32(p);
      p_hi[a] = x.hi;
      p_lo[a] = x.lo;
    }
    const bf16* v0 = vs + (key0 + 8 * kt + 2 * tt) * ST + g;
#pragma unroll
    for (int n = 0; n < DP / 8; ++n) {  // bfloat16 -> float32 is exact, and exact in TF32
      const uint32_t b0 = __float_as_uint(__bfloat162float(v0[8 * n]));
      const uint32_t b1 = __float_as_uint(__bfloat162float(v0[ST + 8 * n]));
      mma_tf32(t.o[n], p_lo, b0, b1);
      mma_tf32(t.o[n], p_hi, b0, b1);
    }
  }
}

// This lane's columns of row `half` of O times f, to a row of d outputs.
template <int DP, typename T>
__device__ __forceinline__ void mma_store_row_bf16(const MmaTileBf16<DP>& t, int half, float f,
                                                   T* orow, int d) {
  const int tt = threadIdx.x & 3;
#pragma unroll
  for (int n = 0; n < DP / 8; ++n)
    store2(orow, 8 * n + 2 * tt, d, t.o[n][2 * half] * f, t.o[n][2 * half + 1] * f);
}

// Stage `rows` rows of one bfloat16 head (d wide) at a row stride of DP + 8
// elements; columns d..DP-1 and rows rows..rows_p-1 become zero. 16-byte
// pieces where d % 8 == 0 and the rows allow it, else elements.
template <int DP>
__device__ __forceinline__ void stage_head_bf16(bf16* dst, const bf16* src, long long ld,
                                                int rows, int rows_p, int d) {
  constexpr int ST = DP + 8;
  const bool vec = d % 8 == 0 && ld % 8 == 0 && (reinterpret_cast<uintptr_t>(src) & 15) == 0;
  if (vec) {
    constexpr int Q = DP / 8;
    for (int i = threadIdx.x; i < rows_p * Q; i += blockDim.x) {
      const int r = i / Q, c = (i % Q) * 8;
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (r < rows && c < d) val = *reinterpret_cast<const uint4*>(src + r * ld + c);
      *reinterpret_cast<uint4*>(dst + r * ST + c) = val;
    }
  } else {
    const bf16 zero = __float2bfloat16_rn(0.f);
    for (int i = threadIdx.x; i < rows_p * DP; i += blockDim.x) {
      const int r = i / DP, c = i % DP;
      dst[r * ST + c] = r < rows && c < d ? src[r * ld + c] : zero;
    }
  }
}

}  // namespace
