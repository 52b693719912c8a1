// Whole-set attention for short particle sets, forward only, float32, sm_90a.
// Two entry points, one per TPU kernel of
// particle_fm_tpu/ops/pallas/short_attention.py:
//
//   packed_short_attention_f32  replaces `packed_short_attention`
//     (-> `_packed_call` -> `_packed_kernel`): self-attention, Lq == Lk <= 256,
//       s = (q . k) * scale + madd (+ bias_h),  madd = (mask - 1) * 1e9
//       p = exp(s - max s),  o = (p . v) / sum p      (normalised after PV)
//   fused_short_attention_f32   replaces `fused_short_attention` (-> `_kernel`):
//     Lq != Lk allowed, both <= 512,
//       s = (q * scale) . k (+ bias) + (mask - 1) * 1e9
//       p = softmax(s)                                 (divided before PV)
//       o = p . v
//
// Both read q, k, v in the (B, L, H, D) layout the projections write (heads
// packed in the last two axes; the distances between rows and between sets are
// arguments, so the three slices of one fused QKV projection are read where
// they lie) and write a contiguous (B, Lq, H, D) output. The score block never
// goes to device memory. -1e9 is added, never -inf, so a set whose keys are
// all masked gets uniform weights and stays finite; in float32 the sum
// s + (-1e9) rounds the score away, as in the plain versions. Every query row
// is computed, padded ones included. The TPU kernels pad L to the tile of the
// matrix unit; here the ragged edge is handled in the kernel.
//
// Bounds on an H100 SXM (3.35 TB/s; TF32 on the tensor cores 495 TFLOP/s
// dense; float32 on the CUDA cores 67 TFLOP/s), counted as chip_smoke.py
// counts them:
//   packed, PC-Droid transformer shape (B=640, L=150, H=16, D=16): q, k, v,
//     the mask and the output are 393.6 MB, 0.117 ms. The two products are
//     4*B*H*L*L*D = 14.7 GFLOP, issued three times in TF32 (split precision,
//     attention_mma.cuh): 0.089 ms; the 5 operations per score beside them
//     (1.2 GFLOP) stay on the CUDA cores, 0.017 ms. Bound by bytes, 0.117 ms.
//   fused, cross-attention shapes (B=640, H=16, D=8; Lq=4, Lk=150 and Lq=150,
//     Lk=4): about 100 MB and 0.2 GFLOP each. Bound by bytes.
//
// Design of the packed kernel: one block per (set, head), so 640 sets x 16
// heads give the 132 SMs 10,240 blocks. The head's K and V rows are staged in
// shared memory once, at a row stride of D+4 floats, the keys padded to a
// multiple of 8 with rows of zeros that take a mask of -inf. A warp owns a
// tile of 16 query rows (10 warps at L=150; at most 16 warps, 8 at D=64,
// which then take several tiles in turn) and runs the tensor-core tile step
// of attention_mma.cuh over the keys: Q's fragments and the accumulator stay
// in registers, both products go through mma.sync in split-precision TF32,
// the softmax between them works on the accumulator's registers. Query rows
// past the set's end inside the last tile repeat the last row and are not
// stored.
//
// Design of the fused kernel: its shapes on the serving path are lopsided
// (4 queries against 150 keys, 150 queries against 4 keys) and bound by
// bytes, so it needs whole rows read with wide loads and many of them in
// flight, not arithmetic. In the (B, L, H, D) layout one row of a set holds
// all heads, H*D floats: at 16 heads of 8, 512 contiguous bytes, one 16-byte
// load per lane of a warp. So a block takes one set and 32 slots of 4 floats
// of a row (all the heads at H*D = 128; wider rows take several blocks), a
// lane owns 4 floats of one head, a head spans D/4 lanes (padded to a power
// of two) and reduces its dot products in log2(D/4) shuffles, one at D=8. The
// first version staged each head's keys in shared memory, 32-byte pieces 512
// bytes apart, and ran a chain of grouped reductions over every output
// column. Two kernels, by the number of keys:
//   * at most 8 keys (150 queries on 4 keys): every lane keeps its slot of
//     the set's K and V rows in registers, and a warp streams query rows, 4
//     at a time (2 with 5 to 8 keys), each row read and written once whole.
//     The (set, 4 rows) items are dealt to a grid that fills the card once,
//     in runs of consecutive items per warp: blocks of one set each left a
//     second wave 60% full;
//   * more keys (4 queries on 150 keys): each of 4 warps keeps a group of 4
//     query rows in registers and streams its share of the keys (keys w,
//     w+4, ...) with a running maximum, sum and output per (row, head); the
//     warps' partial results meet once in shared memory (12 KB). Five blocks
//     fit an SM, so 640 sets run in one wave.
// The softmax is taken with a running maximum and the output divided by the
// sum at the end: the same function as the plain version's softmax divided
// before PV, summed in another order (1e-4).
//
// bfloat16: two more entry points, with q, k, v and the output in bfloat16
// (the mask and the bias stay float32).
//   packed_short_attention_bf16: the Pallas `_packed_kernel` on bfloat16
//     (short_attention.py:187-206): Q . K^T as bfloat16 products with float32
//     accumulation, the softmax over the whole row in float32 (the row's
//     maximum before any exponential), P rounded to bfloat16 for a bfloat16
//     P . V, the sum of the unrounded p, the normalisation after PV, the
//     output rounded once. Its served shape is path A (fm_droid_transformer:
//     B=640, L=150, 16 heads of 16, q, k and v slices of one (B, L, 768)
//     projection, 30-150 real keys). Bound there by bytes: 197 MB, 0.059 ms
//     over all keys; over the keys the data needs (each set's extent, 60%
//     of them) about 0.047. The exponentials, one SFU operation a score (16
//     a clock an SM), come to a floor of about 0.04 ms over those keys.
//     The first version (a block per (set, head), two passes over the keys
//     to round P against the row's final maximum, every key of every set, K
//     and V staged through registers, Q by 2-byte loads) took 0.215 ms
//     (NVIDIA H100 80GB HBM3, 700 W; scripts/bf16_attention_readings.py).
//     This design (packed_attention_bf16_kernel):
//     * One pass over Q . K^T: a warp keeps its 16 rows' scores for all the
//       steps of 16 keys it takes in registers (attention_mma.cuh,
//       `packed_bf16_rows`; at most 16 steps, 8 floats a lane each), takes
//       the rows' maxima from them, then P, the sums and P . V from the same
//       registers in the same order: the first version's values, bit for
//       bit. The register bound NS is a template parameter (4, 10 or 16
//       steps for L up to 64, 160, 256); the steps run in straight-line
//       groups of 4, so that their loads, products and exponentials overlap.
//     * It stops at the set's last real key (attention_common.cuh,
//       `stage_mask_extent`, from one read of the mask row: keys past it
//       take p = 0 exactly), rounded up to a step of 16. Every query row is
//       computed and written.
//     * A block takes one set's group of heads, 32 columns wide (2 heads at
//       head dim 16: rows of 64 contiguous bytes in place of 32; one head
//       at head dims above 16), stages the group's Q, K and V by cp.async
//       (K and V only up to the extent), reads Q's fragments by ldmatrix,
//       and writes the output in 16-byte pieces through its Q tile's place
//       in shared memory. 4 warps take the group's (head, row tile) pairs in
//       turn; the launch bounds ask for 16 warps an SM (four blocks at path
//       A, 39 KB of shared memory and 128 registers a thread each), so that
//       the staging of some blocks overlaps the steps of others.
//     Times, alternatives and knock-outs (scripts/attention_bf16_variants.py):
//     PERF.md.
//   fused_short_attention_bf16: the Pallas `_kernel` upcasts q, k and v and
//     keeps P in float32 (short_attention.py:47-65): float32 arithmetic on
//     the bfloat16 values, the softmax divided, the output rounded once. Its
//     own two kernels (below the float32 ones), bound by latency at path B
//     (B=640, 16 heads of 8; bytes 0.030 ms a pair, about 0.024 over the keys
//     the data needs): a lane holds 8 values of a head, one 16-byte load (a
//     whole head at head dim 8, so a dot product needs no shuffle), and a
//     warp load reads two 256-byte rows.
//     * "from" (4 queries on 150 masked keys): a block per set stops at the
//       set's last real key, as the flash kernel does; each lane keeps the 4
//       query rows and loads its next 2 keys' K and V before it uses the
//       first, one maximum per group of keys; 4 warps a block, 5 blocks an
//       SM (20 warps): path B's 640 sets in one wave.
//     * "to" (150 queries on 4 keys): K and V of the keys in registers, 8
//       query rows an item (4 loads of two rows each), the items dealt in runs
//       to a grid that fills the card once.

#include "attention_mma.cuh"

namespace {

constexpr int kMaxPackedLen = 256;
constexpr int kMaxFusedLen = 512;
constexpr int kMaxHeadDim = 64;
constexpr int kFewWarps = 8;    // warps of a block of the fused kernel with few keys
constexpr int kManyWarps = 4;   // ... with many keys
constexpr int kFusedRegKeys = 8;   // at most this many keys: K and V rows in registers
constexpr int kFusedRows = 4;      // query rows a warp keeps while it streams the keys

// ---------------------------------------------------------------------------
// packed: block = (set, head), warp = tiles of 16 query rows
// ---------------------------------------------------------------------------

// Most warps of a block: one per row tile of the longest set, as far as the
// registers of Q's fragments and the accumulator allow.
__host__ __device__ constexpr int packed_max_warps(int dp) {
  return kMaxPackedLen / kMmaRows / (dp <= 32 ? 1 : 2);
}

struct PackedBias {  // one head's (L, L) bias; rows and keys past the set's end add nothing
  static constexpr bool kOn = true;
  const float* head;
  int l, row0;
  __device__ __forceinline__ float operator()(int row_in_tile, int key) const {
    const int row = row0 + row_in_tile + ((threadIdx.x & 31) >> 2);
    return row < l && key < l ? head[(long long)row * l + key] : 0.f;
  }
};

// At head dims up to 16 without a bias, 64 registers a thread: three blocks of
// 10 warps (L=150) to an SM in place of two.
template <int DP, bool kBias>
__global__ void __launch_bounds__(32 * packed_max_warps(DP), DP <= 16 && !kBias ? 2 : 1)
packed_attention_kernel(Heads q, Heads k, Heads v, const float* __restrict__ mask,
                        const float* __restrict__ bias, float* __restrict__ out,
                        int l, int h, int d, float scale) {
  constexpr int ST = DP + 4;
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  const int lp = (l + kMmaKeys - 1) / kMmaKeys * kMmaKeys;
  float* ks = sm;
  float* vs = ks + lp * ST;
  float* madd = vs + lp * ST;
  const int b = blockIdx.x / h, hd = blockIdx.x % h;

  stage_head<DP>(ks, ST, k.p + b * k.bs + hd * d, k.ld, l, lp, d, k.vec);
  stage_head<DP>(vs, ST, v.p + b * v.bs + hd * d, v.ld, l, lp, d, v.vec);
  stage_mask(madd, mask ? mask + (long long)b * l : nullptr, l, lp);
  __syncthreads();

  const int g = (threadIdx.x & 31) >> 2;
  const float* qhead = q.p + b * q.bs + hd * d;
  for (int row0 = (threadIdx.x >> 5) * kMmaRows; row0 < l; row0 += (blockDim.x >> 5) * kMmaRows) {
    MmaTile<DP> t;
    mma_tile_init(t, qhead, q.ld, row0, l - 1, d, -CUDART_INF_F);
    if constexpr (kBias) {
      const PackedBias bs{bias + ((long long)b * h + hd) * l * l, l, row0};
      mma_softmax_keys(t, ks, vs, madd, lp, scale, bs);
    } else {
      mma_softmax_keys(t, ks, vs, madd, lp, scale, NoBias{});
    }
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const float sum = mma_row_sum(t, half);  // every lane shuffles
      const int row = row0 + 8 * half + g;
      if (row < l)
        mma_store_row(t, half, 1.f / sum, out + (((long long)b * l + row) * h + hd) * d, d);
    }
  }
}

// ---------------------------------------------------------------------------
// packed, bfloat16: block = (set, group of heads), warp = (head, tile of 16
// query rows) in turn
// ---------------------------------------------------------------------------

constexpr int kPackedBf16Warps = 4;   // warps of a block
constexpr int kPackedBf16Cols = 32;   // columns of a block's group of heads, at least

// The columns of a block's group: kPackedBf16Cols / DP heads, or one head of
// DP columns where that is wider. Staged rows lie 8 more elements apart.
__host__ __device__ constexpr int packed_bf16_cols(int dp) {
  return dp < kPackedBf16Cols ? kPackedBf16Cols : dp;
}

// The steps of 16 keys whose scores a warp keeps in registers, at most: the
// template's bound on the set's steps (L up to 64, 160, 256).
__host__ __device__ constexpr int packed_bf16_steps(int l) {
  return l <= 64 ? 4 : l <= 160 ? 10 : 16;
}

// Resident blocks an SM that the launch bounds ask for: 16 warps an SM (at
// most 128 registers a thread) where the scores (8 floats a step), Q's
// fragments, O and a bias's rows leave room for the rest, else 8 (up to 255).
__host__ __device__ constexpr int packed_bf16_min_blocks(int dp, int ns, bool bias) {
  return ((ns * 8 + dp + (bias ? 16 : 0) <= 96 ? 16 : 8) + kPackedBf16Warps - 1) /
         kPackedBf16Warps;
}

// Rows 0 .. rows_p - 1 of a group of nh heads (d wide, at most C / DP) into
// shared memory, C + 8 elements apart (C = packed_bf16_cols(DP)), head j at
// column j * DP; rows from `rows` on, heads from nh on and columns from d on
// zero. `wide`: by cp.async in 16-byte pieces (not committed), else element
// by element.
template <int DP>
__device__ __forceinline__ void stage_group_bf16(bf16* dst, const bf16* src, long long ld,
                                                 int rows, int rows_p, int nh, int d, bool wide) {
  constexpr int C = packed_bf16_cols(DP), SW = C + 8;
  if (wide) {
    for (int e = threadIdx.x; e < rows_p * (C / 8); e += blockDim.x) {
      const int r = e / (C / 8), j = (e % (C / 8)) / (DP / 8), c = (e % (DP / 8)) * 8;
      const bool in = r < rows && j < nh && c < d;
      cp_async16(dst + r * SW + j * DP + c, src + (in ? r * ld + j * d + c : 0), in);
    }
  } else {
    const bf16 zero = __float2bfloat16_rn(0.f);
    for (int e = threadIdx.x; e < rows_p * C; e += blockDim.x) {
      const int r = e / C, j = (e % C) / DP, c = e % DP;
      dst[r * SW + j * DP + c] = r < rows && j < nh && c < d ? src[r * ld + j * d + c] : zero;
    }
  }
}

// The bfloat16 packed kernel: a block per item (set, group of G heads, C =
// packed_bf16_cols(DP) columns). It copies the group's Q for every row (rows past the set's end
// zero) by cp.async, reads the set's mask row once for the additive mask and
// the extent of its real keys (`stage_mask_extent`), copies
// K and V up to that extent, rounded up to a step of 16, then its warps take
// the item's (head, row tile) pairs in turn (`packed_bf16_rows`: one pass
// over Q . K^T for the extent's steps), each writing its normalised rows,
// rounded to bfloat16, over its tile of the staged Q; after a barrier the
// block writes the group's rows out, 16-byte pieces of G * d contiguous
// elements. Blocks of 4 warps, four of them an SM at path A (each 39 KB of
// shared memory): the blocks' staging, steps and stores overlap across them.
template <int DP, int NS, bool kBias>
__global__ void __launch_bounds__(32 * kPackedBf16Warps, packed_bf16_min_blocks(DP, NS, kBias))
packed_attention_bf16_kernel(HeadsT<bf16> q, HeadsT<bf16> k, HeadsT<bf16> v,
                             const float* __restrict__ mask, const float* __restrict__ bias,
                             bf16* __restrict__ out, int l, int h, int d, float scale,
                             bool wide) {
  constexpr int C = packed_bf16_cols(DP), G = C / DP, SW = C + 8;
  extern __shared__ float4 smem4[];
  __shared__ int sm_last;
  const int lp = (l + kBfKeys - 1) / kBfKeys * kBfKeys;  // rows of whole tiles, keys of whole steps
  bf16* qs = reinterpret_cast<bf16*>(smem4);
  bf16* ks = qs + lp * SW;
  bf16* vs = ks + lp * SW;
  float* madd = reinterpret_cast<float*>(vs + lp * SW);
  const int groups = (h + G - 1) / G;
  const int b = blockIdx.x / groups, h0 = (blockIdx.x % groups) * G, nh = min(G, h - h0);
  const long long col0 = (long long)h0 * d;

  stage_group_bf16<DP>(qs, q.p + b * q.bs + col0, q.ld, l, lp, nh, d, wide);
  const int ext = stage_mask_extent(madd, mask ? mask + (long long)b * l : nullptr, l, lp,
                                    &sm_last);
  const int kp = min(lp, (ext + kBfKeys - 1) / kBfKeys * kBfKeys);
  stage_group_bf16<DP>(ks, k.p + b * k.bs + col0, k.ld, l, kp, nh, d, wide);
  stage_group_bf16<DP>(vs, v.p + b * v.bs + col0, v.ld, l, kp, nh, d, wide);
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();

  const int tiles = lp / kMmaRows;
  for (int task = threadIdx.x >> 5; task < nh * tiles; task += blockDim.x >> 5) {
    const int hd = task / tiles, row0 = (task % tiles) * kMmaRows;
    bf16* qt = qs + row0 * SW + hd * DP;
    if constexpr (kBias) {
      const PackedBias bs{bias + ((long long)b * h + h0 + hd) * l * l, l, row0};
      packed_bf16_rows<DP, NS>(qt, ks + hd * DP, vs + hd * DP, SW, madd, kp / kBfKeys, scale,
                               bs, qt);
    } else {
      packed_bf16_rows<DP, NS>(qt, ks + hd * DP, vs + hd * DP, SW, madd, kp / kBfKeys, scale,
                               NoBias{}, qt);
    }
  }
  __syncthreads();

  bf16* ob = out + (long long)b * l * h * d + col0;
  const long long ld = (long long)h * d;
  if (d % 8 == 0) {
    for (int e = threadIdx.x; e < l * (C / 8); e += blockDim.x) {
      const int r = e / (C / 8), j = (e % (C / 8)) / (DP / 8), c = (e % (DP / 8)) * 8;
      if (j < nh && c < d)
        *reinterpret_cast<uint4*>(ob + r * ld + j * d + c) =
            *reinterpret_cast<const uint4*>(qs + r * SW + j * DP + c);
    }
  } else {
    for (int e = threadIdx.x; e < l * C; e += blockDim.x) {
      const int r = e / C, j = (e % C) / DP, c = e % DP;
      if (j < nh && c < d) ob[r * ld + j * d + c] = qs[r * SW + j * DP + c];
    }
  }
}

// ---------------------------------------------------------------------------
// fused: block = (set, 32 slots of a row across the heads), lane = 4 floats
// ---------------------------------------------------------------------------

// Slot 32 * chunk + lane of a row of H heads of D floats: floats 4c .. 4c+3
// of head hd = slot / QP, c = slot % QP, where QP, the lanes a head spans, is
// the power of two at or above D/4. A slot past the last head or the head dim
// holds no float (n = 0): it reads zeros, stores nothing, and still takes part
// in the shuffles.
template <int QP>
struct Slot {
  int off;  // offset of its first float in a row
  int hd;   // its head, at most h - 1
  int n;    // how many of its 4 floats lie in the head
  __device__ __forceinline__ Slot(int chunk, int h, int d) {
    const int s = 32 * chunk + (threadIdx.x & 31), c = s % QP;
    const int head = s / QP;
    n = head < h ? max(0, min(4, d - 4 * c)) : 0;
    hd = min(head, h - 1);
    off = head * d + 4 * c;
  }
};

// The slot's floats of a row (vec: d % 4 == 0 and 16-byte rows, so n is 0 or 4)
__device__ __forceinline__ float4 load_slot(const float* p, int n, bool vec) {
  float4 r = make_float4(0.f, 0.f, 0.f, 0.f);
  if (vec) {
    if (n) r = *reinterpret_cast<const float4*>(p);
  } else {
    if (n > 0) r.x = p[0];
    if (n > 1) r.y = p[1];
    if (n > 2) r.z = p[2];
    if (n > 3) r.w = p[3];
  }
  return r;
}

__device__ __forceinline__ void store_slot(float* p, float4 r, int n, bool vec) {
  if (vec) {
    if (n) *reinterpret_cast<float4*>(p) = r;
  } else {
    if (n > 0) p[0] = r.x;
    if (n > 1) p[1] = r.y;
    if (n > 2) p[2] = r.z;
    if (n > 3) p[3] = r.w;
  }
}

// q . k over the head: this lane's 4 products, summed over the QP lanes of the head
template <int QP>
__device__ __forceinline__ float head_dot(float4 a, float4 b) {
  float x = fmaf(a.x, b.x, fmaf(a.y, b.y, fmaf(a.z, b.z, a.w * b.w)));
#pragma unroll
  for (int off = QP / 2; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

__device__ __forceinline__ float4 scaled(float4 a, float f) {
  return make_float4(a.x * f, a.y * f, a.z * f, a.w * f);
}
__device__ __forceinline__ float4 axpy(float p, float4 v, float4 o) {
  return make_float4(fmaf(p, v.x, o.x), fmaf(p, v.y, o.y), fmaf(p, v.z, o.z), fmaf(p, v.w, o.w));
}

// At most KR keys (4 or 8): every lane keeps its slot of a set's K and V rows
// in registers and streams the set's query rows, RB at a time. The work items
// (set, slots, RB rows) are dealt to the warps of a grid that fills the card
// once, in runs of `per_warp` consecutive items, so a warp reloads K and V only
// where its run crosses into the next set and no wave of blocks is left half
// full.
template <typename T, int QP, int KR>
__global__ void __launch_bounds__(32 * kFewWarps)
fused_few_keys_kernel(HeadsT<T> q, HeadsT<T> k, HeadsT<T> v, const float* __restrict__ mask,
                      const float* __restrict__ bias, T* __restrict__ out, int n_sets,
                      int lq, int lk, int h, int d, int chunks, float scale, int per_warp) {
  constexpr int RB = KR <= 4 ? 4 : 2;
  const int groups = (lq + RB - 1) / RB;
  const long long total = (long long)n_sets * chunks * groups;
  long long it = ((long long)blockIdx.x * kFewWarps + (threadIdx.x >> 5)) * per_warp;
  const long long end = min(it + per_warp, total);
  const bool ovec = d % 4 == 0;
  int held = -1;  // the (set, slots) whose K and V the registers hold
  Slot<QP> sl(0, h, d);
  float4 kr[KR], vr[KR];
  float madd[KR];
  const T* qb = nullptr;
  const float* bb = nullptr;
  T* ob = nullptr;
  for (; it < end; ++it) {
    const int bc = (int)(it / groups), r0 = (int)(it % groups) * RB;
    if (bc != held) {  // warp-uniform
      held = bc;
      const int b = bc / chunks;
      sl = Slot<QP>(bc % chunks, h, d);
#pragma unroll
      for (int j = 0; j < KR; ++j) {
        const bool in = j < lk;
        kr[j] = load_slot(k.p + b * k.bs + j * k.ld + sl.off, in ? sl.n : 0, k.vec);
        vr[j] = load_slot(v.p + b * v.bs + j * v.ld + sl.off, in ? sl.n : 0, v.vec);
        madd[j] = !in ? -CUDART_INF_F : mask ? (mask[(long long)b * lk + j] - 1.f) * kNeg : 0.f;
      }
      qb = q.p + b * q.bs + sl.off;
      ob = out + (long long)b * lq * h * d + sl.off;
      bb = bias ? bias + ((long long)b * h + sl.hd) * lq * lk : nullptr;
    }
    float4 qv[RB];
#pragma unroll
    for (int i = 0; i < RB; ++i)  // rows past the last repeat it and store nothing
      qv[i] = scaled(load_slot(qb + min(r0 + i, lq - 1) * q.ld, sl.n, q.vec), scale);
#pragma unroll
    for (int i = 0; i < RB; ++i) {
      const int row = min(r0 + i, lq - 1);
      float s[KR], m = -CUDART_INF_F;
#pragma unroll
      for (int j = 0; j < KR; ++j) {
        float sc = head_dot<QP>(qv[i], kr[j]);
        if (bb != nullptr && j < lk) sc += bb[(long long)row * lk + j];
        s[j] = sc + madd[j];
        m = fmaxf(m, s[j]);
      }
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < KR; ++j) {
        s[j] = exp_neg(s[j] - m);
        sum += s[j];
      }
      float4 o = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int j = 0; j < KR; ++j) o = axpy(s[j] / sum, vr[j], o);
      if (r0 + i < lq) store_slot(ob + (long long)(r0 + i) * h * d, o, sl.n, ovec);
    }
  }
}

// More than kFusedRegKeys keys: the query rows in groups of kFusedRows; every
// warp keeps a group's rows in registers and streams its share of the keys
// (keys warp, warp + 4, ...) with a running maximum, sum and output per row
// and head; the warps' partial results meet once in shared memory. Blocks of
// 4 warps at most 102 registers a thread: five blocks to an SM, so the 640
// sets of the served shape run in one wave.
template <typename T, int QP>
__global__ void __launch_bounds__(32 * kManyWarps, 5)
fused_many_keys_kernel(HeadsT<T> q, HeadsT<T> k, HeadsT<T> v, const float* __restrict__ mask,
                       const float* __restrict__ bias, T* __restrict__ out,
                       int lq, int lk, int h, int d, int chunks, float scale) {
  constexpr int R = kFusedRows;
  __shared__ float4 part_o[kManyWarps][R][32];
  __shared__ float2 part_ml[kManyWarps][R][32];
  const int b = blockIdx.x / chunks, warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const Slot<QP> sl(blockIdx.x % chunks, h, d);
  const T* qb = q.p + b * q.bs + sl.off;
  const T* kb = k.p + b * k.bs + sl.off;
  const T* vb = v.p + b * v.bs + sl.off;
  const float* mb = mask ? mask + (long long)b * lk : nullptr;
  const float* bb = bias ? bias + ((long long)b * h + sl.hd) * lq * lk : nullptr;
  T* ob = out + (long long)b * lq * h * d + sl.off;
  for (int r0 = 0; r0 < lq; r0 += R) {
    float4 qv[R], o[R];
    float m[R], l[R];
#pragma unroll
    for (int i = 0; i < R; ++i) {
      qv[i] = scaled(load_slot(qb + min(r0 + i, lq - 1) * q.ld, sl.n, q.vec), scale);
      o[i] = make_float4(0.f, 0.f, 0.f, 0.f);
      m[i] = -CUDART_INF_F;
      l[i] = 0.f;
    }
#pragma unroll 2
    for (int j = warp; j < lk; j += kManyWarps) {
      const float4 kv = load_slot(kb + j * k.ld, sl.n, k.vec);
      const float4 vv = load_slot(vb + j * v.ld, sl.n, v.vec);
      const float ma = mb ? (mb[j] - 1.f) * kNeg : 0.f;
#pragma unroll
      for (int i = 0; i < R; ++i) {
        float sc = head_dot<QP>(qv[i], kv);
        if (bb != nullptr) sc += bb[(long long)min(r0 + i, lq - 1) * lk + j];
        sc += ma;
        const float mn = fmaxf(m[i], sc);
        const float corr = exp_neg(m[i] - mn), p = exp_neg(sc - mn);
        l[i] = fmaf(l[i], corr, p);
        o[i] = axpy(p, vv, scaled(o[i], corr));
        m[i] = mn;
      }
    }
#pragma unroll
    for (int i = 0; i < R; ++i) {
      part_o[warp][i][lane] = o[i];
      part_ml[warp][i][lane] = make_float2(m[i], l[i]);
    }
    __syncthreads();
    if (warp < R && r0 + warp < lq) {  // warp i merges row r0 + i
      float mx = -CUDART_INF_F;
#pragma unroll
      for (int w = 0; w < kManyWarps; ++w) mx = fmaxf(mx, part_ml[w][warp][lane].x);
      float sum = 0.f;
      float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int w = 0; w < kManyWarps; ++w) {
        const float2 ml = part_ml[w][warp][lane];
        const float f = exp_neg(ml.x - mx);
        sum = fmaf(ml.y, f, sum);
        acc = axpy(f, part_o[w][warp][lane], acc);
      }
      store_slot(ob + (long long)(r0 + warp) * h * d, scaled(acc, 1.f / sum), sl.n, d % 4 == 0);
    }
    __syncthreads();
  }
}

// ---------------------------------------------------------------------------
// launchers
// ---------------------------------------------------------------------------

// With `report`, nothing is launched: the block's geometry goes there instead
// (mma_report).
template <int DP, bool kBias>
cudaError_t launch_packed(Heads q, Heads k, Heads v, const float* mask, const float* bias,
                          float* out, int b, int l, int h, int d, cudaStream_t stream,
                          int* report) {
  const int lp = (l + kMmaKeys - 1) / kMmaKeys * kMmaKeys;
  const size_t smem = sizeof(float) * ((size_t)2 * lp * (DP + 4) + lp);
  const int warps = min((l + kMmaRows - 1) / kMmaRows, packed_max_warps(DP));
  if (report)
    return mma_report(packed_attention_kernel<DP, kBias>, b * h, warps, lp, smem, report);
  cudaError_t err = allow_smem(packed_attention_kernel<DP, kBias>, smem);
  if (err != cudaSuccess) return err;
  packed_attention_kernel<DP, kBias><<<b * h, 32 * warps, smem, stream>>>(
      q, k, v, mask, bias, out, l, h, d, 1.f / sqrtf((float)d));
  return cudaGetLastError();
}

template <int DP>
cudaError_t launch_packed_dp(Heads q, Heads k, Heads v, const float* mask, const float* bias,
                             float* out, int b, int l, int h, int d, cudaStream_t stream,
                             bool biased, int* report) {
  if (biased)
    return launch_packed<DP, true>(q, k, v, mask, bias, out, b, l, h, d, stream, report);
  return launch_packed<DP, false>(q, k, v, mask, bias, out, b, l, h, d, stream, report);
}

cudaError_t launch_packed_d(Heads q, Heads k, Heads v, const float* mask, const float* bias,
                            float* out, int b, int l, int h, int d, cudaStream_t stream,
                            bool biased, int* report) {
  if (b <= 0 || h <= 0 || l <= 0 || l > kMaxPackedLen || d <= 0 || d > kMaxHeadDim)
    return cudaErrorInvalidValue;
  if (d <= 8)
    return launch_packed_dp<8>(q, k, v, mask, bias, out, b, l, h, d, stream, biased, report);
  if (d <= 16)
    return launch_packed_dp<16>(q, k, v, mask, bias, out, b, l, h, d, stream, biased, report);
  if (d <= 32)
    return launch_packed_dp<32>(q, k, v, mask, bias, out, b, l, h, d, stream, biased, report);
  return launch_packed_dp<64>(q, k, v, mask, bias, out, b, l, h, d, stream, biased, report);
}

// With `report` (8 ints), nothing is launched: blocks, warps of a block, heads
// of a block, steps of 16 keys a warp keeps scores for (NS), bytes of shared
// memory, registers per thread, resident blocks an SM (CUDA's occupancy
// calculator), the resident blocks the launch bounds ask for.
template <int DP, int NS, bool kBias>
cudaError_t launch_packed_bf16(HeadsT<bf16> q, HeadsT<bf16> k, HeadsT<bf16> v, const float* mask,
                               const float* bias, bf16* out, int b, int l, int h, int d,
                               cudaStream_t stream, int* report) {
  constexpr int G = packed_bf16_cols(DP) / DP;
  const int lp = (l + kBfKeys - 1) / kBfKeys * kBfKeys;
  const size_t smem = sizeof(bf16) * (size_t)3 * lp * (packed_bf16_cols(DP) + 8) +
                      sizeof(float) * lp;
  const int group = min(G, h);
  const int warps = min(kPackedBf16Warps, group * (lp / kMmaRows));
  const int blocks = b * ((h + G - 1) / G);
  auto kernel = packed_attention_bf16_kernel<DP, NS, kBias>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  if (report) {
    cudaFuncAttributes attr;
    if ((err = cudaFuncGetAttributes(&attr, kernel)) != cudaSuccess) return err;
    int resident = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&resident, kernel, 32 * warps, smem);
    if (err != cudaSuccess) return err;
    const int r[8] = {blocks, warps, group, NS, (int)smem, attr.numRegs, resident,
                      packed_bf16_min_blocks(DP, NS, kBias)};
    for (int i = 0; i < 8; ++i) report[i] = r[i];
    return cudaSuccess;
  }
  // 16-byte pieces where every head's rows start on 16 bytes
  const bool wide = d % 8 == 0 && q.bs % 8 == 0 && q.ld % 8 == 0 && k.bs % 8 == 0 &&
                    k.ld % 8 == 0 && v.bs % 8 == 0 && v.ld % 8 == 0 &&
                    reinterpret_cast<uintptr_t>(q.p) % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(k.p) % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(v.p) % 16 == 0;
  packed_attention_bf16_kernel<DP, NS, kBias><<<blocks, 32 * warps, smem, stream>>>(
      q, k, v, mask, bias, out, l, h, d, 1.f / sqrtf((float)d), wide);
  return cudaGetLastError();
}

template <int DP, bool kBias>
cudaError_t launch_packed_bf16_ns(HeadsT<bf16> q, HeadsT<bf16> k, HeadsT<bf16> v,
                                  const float* mask, const float* bias, bf16* out, int b, int l,
                                  int h, int d, cudaStream_t stream, int* report) {
  switch (packed_bf16_steps(l)) {
    case packed_bf16_steps(64):
      return launch_packed_bf16<DP, packed_bf16_steps(64), kBias>(q, k, v, mask, bias, out, b, l,
                                                                  h, d, stream, report);
    case packed_bf16_steps(160):
      return launch_packed_bf16<DP, packed_bf16_steps(160), kBias>(q, k, v, mask, bias, out, b, l,
                                                                   h, d, stream, report);
    default:
      return launch_packed_bf16<DP, packed_bf16_steps(kMaxPackedLen), kBias>(
          q, k, v, mask, bias, out, b, l, h, d, stream, report);
  }
}

template <int DP>
cudaError_t launch_packed_bf16_dp(HeadsT<bf16> q, HeadsT<bf16> k, HeadsT<bf16> v,
                                  const float* mask, const float* bias, bf16* out, int b, int l,
                                  int h, int d, cudaStream_t stream, int* report) {
  if (bias != nullptr)
    return launch_packed_bf16_ns<DP, true>(q, k, v, mask, bias, out, b, l, h, d, stream, report);
  return launch_packed_bf16_ns<DP, false>(q, k, v, mask, bias, out, b, l, h, d, stream, report);
}

cudaError_t launch_packed_bf16_d(HeadsT<bf16> q, HeadsT<bf16> k, HeadsT<bf16> v,
                                 const float* mask, const float* bias, bf16* out, int b, int l,
                                 int h, int d, cudaStream_t stream, int* report) {
  if (b <= 0 || h <= 0 || l <= 0 || l > kMaxPackedLen || d <= 0 || d > kMaxHeadDim)
    return cudaErrorInvalidValue;
  if (d <= 16)
    return launch_packed_bf16_dp<16>(q, k, v, mask, bias, out, b, l, h, d, stream, report);
  if (d <= 32)
    return launch_packed_bf16_dp<32>(q, k, v, mask, bias, out, b, l, h, d, stream, report);
  return launch_packed_bf16_dp<64>(q, k, v, mask, bias, out, b, l, h, d, stream, report);
}

template <typename T, int QP, int KR>
cudaError_t launch_few_keys(HeadsT<T> q, HeadsT<T> k, HeadsT<T> v, const float* mask,
                            const float* bias, T* out, int b, int lq, int lk, int h, int d,
                            int chunks, float scale, cudaStream_t stream) {
  constexpr int RB = KR <= 4 ? 4 : 2;
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fused_few_keys_kernel<T, QP, KR>,
                                                      32 * kFewWarps, 0);
  if (err != cudaSuccess) return err;
  const long long items = (long long)b * chunks * ((lq + RB - 1) / RB);
  const long long warps = (long long)sms * max(per_sm, 1) * kFewWarps;
  const int per_warp = (int)((items + warps - 1) / warps);
  const int grid = (int)((items + (long long)per_warp * kFewWarps - 1) / (per_warp * kFewWarps));
  fused_few_keys_kernel<T, QP, KR><<<grid, 32 * kFewWarps, 0, stream>>>(
      q, k, v, mask, bias, out, b, lq, lk, h, d, chunks, scale, per_warp);
  return cudaGetLastError();
}

// QP: lanes a head spans (1, 2, 4, 8 or 16 for head dims up to 4, 8, 16, 32, 64)
template <typename T, int QP>
cudaError_t launch_fused(HeadsT<T> q, HeadsT<T> k, HeadsT<T> v, const float* mask,
                         const float* bias, T* out, int b, int lq, int lk, int h, int d,
                         cudaStream_t stream) {
  const int chunks = (h * QP + 31) / 32;
  const float scale = 1.f / sqrtf((float)d);
  if (lk <= 4)
    return launch_few_keys<T, QP, 4>(q, k, v, mask, bias, out, b, lq, lk, h, d, chunks, scale,
                                     stream);
  if (lk <= kFusedRegKeys)
    return launch_few_keys<T, QP, kFusedRegKeys>(q, k, v, mask, bias, out, b, lq, lk, h, d,
                                                 chunks, scale, stream);
  fused_many_keys_kernel<T, QP><<<b * chunks, 32 * kManyWarps, 0, stream>>>(
      q, k, v, mask, bias, out, lq, lk, h, d, chunks, scale);
  return cudaGetLastError();
}

template <typename T>
int fused_entry(const T* q, const T* k, const T* v, const float* mask, const float* bias, T* out,
                int b, int lq, int lk, int h, int d, long long q_bs, long long q_ld,
                long long k_bs, long long k_ld, long long v_bs, long long v_ld,
                void* stream_ptr) {
  if (b <= 0 || h <= 0 || lq <= 0 || lq > kMaxFusedLen || lk <= 0 || lk > kMaxFusedLen ||
      d <= 0 || d > kMaxHeadDim)
    return (int)cudaErrorInvalidValue;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const HeadsT<T> qh = heads(q, q_bs, q_ld, d), kh = heads(k, k_bs, k_ld, d),
                  vh = heads(v, v_bs, v_ld, d);
  if (d <= 4) return (int)launch_fused<T, 1>(qh, kh, vh, mask, bias, out, b, lq, lk, h, d, stream);
  if (d <= 8) return (int)launch_fused<T, 2>(qh, kh, vh, mask, bias, out, b, lq, lk, h, d, stream);
  if (d <= 16) return (int)launch_fused<T, 4>(qh, kh, vh, mask, bias, out, b, lq, lk, h, d, stream);
  if (d <= 32) return (int)launch_fused<T, 8>(qh, kh, vh, mask, bias, out, b, lq, lk, h, d, stream);
  return (int)launch_fused<T, 16>(qh, kh, vh, mask, bias, out, b, lq, lk, h, d, stream);
}


// ---------------------------------------------------------------------------
// fused, bfloat16: lane = 8 values of a head (one 16-byte load)
// ---------------------------------------------------------------------------

constexpr int kFromWarps = 4;        // warps of a block of the "from" kernel (many keys)
constexpr int kFromBlocksPerSm = 5;  // its resident blocks an SM (launch bounds)
constexpr int kFromRows = 4;         // query rows a lane keeps while it streams the keys
constexpr int kFromKeys = 2;         // keys a lane loads before it uses the first
constexpr int kToWarps = 8;          // warps of a block of the "to" kernel (at most 8 keys)
constexpr int kToBlocksPerSm = 2;    // its resident blocks an SM (launch bounds)
constexpr float kEmptyMax = -1e30f;  // running maximum of a stream that has no key yet

// Query rows of a lane in an item of the "to" kernel, with KR keys in registers
__host__ __device__ constexpr int to_lane_rows(int kr) { return kr <= 4 ? 4 : 2; }

// Lanes that hold one row of H heads at QP8 lanes a head: the power of two at
// or above H * QP8, at most a warp (wider rows take several blocks or items,
// `chunks`); a warp load then reads 32 / lanes rows.
__host__ __device__ inline int row_lanes(int h, int qp8) {
  int n = 1;
  while (n < h * qp8 && n < 32) n *= 2;
  return n;
}

// Slot s of a row of H heads of D values: values 8c .. 8c+7 of head hd = s /
// QP8, c = s % QP8. A slot past the last head or the head dim holds no value
// (n = 0): it reads zeros, stores nothing, and takes part in the shuffles.
template <int QP8>
struct Slot8 {
  int off;  // offset of its first value in a row
  int hd;   // its head, at most h - 1
  int n;    // how many of its 8 values lie in the head
  __device__ __forceinline__ Slot8(int s, int h, int d) {
    const int c = s % QP8, head = s / QP8;
    n = head < h ? max(0, min(8, d - 8 * c)) : 0;
    hd = min(head, h - 1);
    off = head * d + 8 * c;
  }
};

// 8 floats to the slot's n values of a row, rounded to the nearest bfloat16
__device__ __forceinline__ void store_slot8(bf16* p, const float (&o)[8], float f, int n,
                                            bool wide) {
  if (wide) {
    if (n)
      *reinterpret_cast<uint4*>(p) = make_uint4(pack_bf16(o[0] * f, o[1] * f),
                                                pack_bf16(o[2] * f, o[3] * f),
                                                pack_bf16(o[4] * f, o[5] * f),
                                                pack_bf16(o[6] * f, o[7] * f));
    return;
  }
#pragma unroll
  for (int i = 0; i < 8; ++i)
    if (i < n) p[i] = __float2bfloat16_rn(o[i] * f);
}

// q . k over the head: this lane's 8 products, summed over the QP8 lanes of the head
template <int QP8>
__device__ __forceinline__ float head_dot8(const float (&a)[8], const float (&b)[8]) {
  float x = 0.f;
#pragma unroll
  for (int i = 0; i < 8; ++i) x = fmaf(a[i], b[i], x);
#pragma unroll
  for (int off = QP8 / 2; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// The "from" half (more than 8 keys; path B: 4 queries on 150 masked keys).
// Block: one set and a chunk of 32 slots. The block reads its mask row once
// and stops at the set's last real key (as flash_mma_bf16_kernel does). A
// warp load reads 32 / lanes key rows (two at 16 heads of 8), so the block's
// keys fall into `streams` = warps * 32 / lanes interleaved streams (stream
// st takes keys st, st + streams, ...). Each lane keeps kFromRows query rows
// (scaled, float32) and loads its next kFromKeys keys' K and V before it uses
// the first; a group of keys takes one update of each row's maximum and one
// rescale. The streams meet by shuffles inside a warp, then once in shared
// memory; the output is divided by the sum at the end.
template <int QP8, bool kBias>
__global__ void __launch_bounds__(32 * kFromWarps, kFromBlocksPerSm)
fused_from_bf16_kernel(HeadsT<bf16> q, HeadsT<bf16> k, HeadsT<bf16> v,
                       const float* __restrict__ mask, const float* __restrict__ bias,
                       bf16* __restrict__ out, int lq, int lk, int h, int d, int chunks,
                       float scale, bool wide) {
  constexpr int R = kFromRows, U = kFromKeys;
  __shared__ float part_o[kFromWarps][R][32][8];
  __shared__ float2 part_ml[kFromWarps][R][32];
  __shared__ int sm_last;
  const int b = blockIdx.x / chunks, warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int lanes = row_lanes(h, QP8), sub = lane / lanes;
  const int streams = kFromWarps * (32 / lanes), st0 = warp * (32 / lanes);
  const Slot8<QP8> sl(32 * (blockIdx.x % chunks) + lane % lanes, h, d);
  const float* mb = mask ? mask + (long long)b * lk : nullptr;

  const int ext = real_key_extent(mb, lk, &sm_last);

  const bf16* qb = q.p + b * q.bs + sl.off;
  const bf16* kb = k.p + b * k.bs + sl.off;
  const bf16* vb = v.p + b * v.bs + sl.off;
  const float* bb = kBias ? bias + ((long long)b * h + sl.hd) * lq * lk : nullptr;
  const bool owide = d % 8 == 0;
  for (int r0 = 0; r0 < lq; r0 += R) {
    float qv[R][8], o[R][8], m[R], l[R];
#pragma unroll
    for (int i = 0; i < R; ++i) {  // rows past the last repeat it and store nothing
      unpack8(load8_raw(qb + min(r0 + i, lq - 1) * q.ld, 0, sl.n, wide), qv[i]);
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        qv[i][c] *= scale;
        o[i][c] = 0.f;
      }
      m[i] = kEmptyMax;
      l[i] = 0.f;
    }
    // warp-uniform trips (the shuffles of head_dot8); a stream whose group
    // holds no key in range adds nothing (its maximum stays kEmptyMax)
    for (int j0 = st0; j0 < ext; j0 += U * streams) {
      uint4 kr[U], vr[U];
      float s[R][U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int key = j0 + sub + u * streams;
        const bool in = key < ext;
        kr[u] = load8_raw<false>(kb + (in ? key * k.ld : 0), 0, in ? sl.n : 0, wide);
        vr[u] = load8_raw<false>(vb + (in ? key * v.ld : 0), 0, in ? sl.n : 0, wide);
        const float ma = !in ? -CUDART_INF_F : mb ? (mb[key] - 1.f) * kNeg : 0.f;
#pragma unroll
        for (int i = 0; i < R; ++i) s[i][u] = ma;
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        float kf[8];
        unpack8(kr[u], kf);
        const int key = min(j0 + sub + u * streams, ext - 1);
#pragma unroll
        for (int i = 0; i < R; ++i) {
          float sc = head_dot8<QP8>(qv[i], kf);
          if (kBias) sc += bb[(long long)min(r0 + i, lq - 1) * lk + key];
          s[i][u] += sc;
        }
      }
#pragma unroll
      for (int i = 0; i < R; ++i) {
        float cm = s[i][0];
#pragma unroll
        for (int u = 1; u < U; ++u) cm = fmaxf(cm, s[i][u]);
        const float mn = fmaxf(m[i], cm);
        const float corr = exp_neg(m[i] - mn);
        l[i] *= corr;
#pragma unroll
        for (int c = 0; c < 8; ++c) o[i][c] *= corr;
        m[i] = mn;
#pragma unroll
        for (int u = 0; u < U; ++u) {
          s[i][u] = exp_neg(s[i][u] - mn);
          l[i] += s[i][u];
        }
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        float vf[8];
        unpack8(vr[u], vf);
#pragma unroll
        for (int i = 0; i < R; ++i)
#pragma unroll
          for (int c = 0; c < 8; ++c) o[i][c] = fmaf(s[i][u], vf[c], o[i][c]);
      }
    }
    // the warp's streams into one (lanes that hold the same slot), then the warps'
#pragma unroll
    for (int i = 0; i < R; ++i) {
      for (int off = lanes; off < 32; off <<= 1) {
        float o2[8];
#pragma unroll
        for (int c = 0; c < 8; ++c) o2[c] = __shfl_xor_sync(0xffffffffu, o[i][c], off);
        const float m2 = __shfl_xor_sync(0xffffffffu, m[i], off);
        const float l2 = __shfl_xor_sync(0xffffffffu, l[i], off);
        merge_stream(m[i], l[i], o[i], m2, l2, o2);
      }
      if (sub == 0) {
#pragma unroll
        for (int c = 0; c < 8; ++c) part_o[warp][i][lane][c] = o[i][c];
        part_ml[warp][i][lane] = make_float2(m[i], l[i]);
      }
    }
    __syncthreads();
    for (int e = threadIdx.x; e < R * lanes; e += blockDim.x) {
      const int i = e / lanes, sl_lane = e % lanes;
      const Slot8<QP8> so(32 * (blockIdx.x % chunks) + sl_lane, h, d);
      if (r0 + i >= lq || so.n == 0) continue;
      float mx = kEmptyMax;
#pragma unroll
      for (int w = 0; w < kFromWarps; ++w) mx = fmaxf(mx, part_ml[w][i][sl_lane].x);
      float sum = 0.f, acc[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int w = 0; w < kFromWarps; ++w) {
        const float2 ml = part_ml[w][i][sl_lane];
        const float f = exp_neg(ml.x - mx);
        sum = fmaf(ml.y, f, sum);
#pragma unroll
        for (int c = 0; c < 8; ++c) acc[c] = fmaf(f, part_o[w][i][sl_lane][c], acc[c]);
      }
      store_slot8(out + (long long)b * lq * h * d + (long long)(r0 + i) * h * d + so.off, acc,
                  1.f / sum, so.n, owide);
    }
    __syncthreads();
  }
}

// The "to" half (at most KR = 4 or 8 keys; path B: 150 queries on 4 keys).
// Every lane keeps its slot of the set's K and V rows (as floats) and the
// keys' additive mask in registers; a warp load reads 32 / lanes query rows
// (two at 16 heads of 8), and an item is RL such loads: (set, chunk, RL * 32
// / lanes rows), each row read and written once. The items are dealt to a
// grid that fills the card once (kToBlocksPerSm blocks an SM), in runs of
// `per_warp` consecutive items, so a warp reloads K and V only where its run
// crosses into the next set. The softmax is divided before P . V, as the
// Pallas kernel divides it.
template <int QP8, int KR, bool kBias>
__global__ void __launch_bounds__(32 * kToWarps, kToBlocksPerSm)
fused_to_bf16_kernel(HeadsT<bf16> q, HeadsT<bf16> k, HeadsT<bf16> v,
                     const float* __restrict__ mask, const float* __restrict__ bias,
                     bf16* __restrict__ out, int n_sets, int lq, int lk, int h, int d, int chunks,
                     float scale, int per_warp, bool wide) {
  constexpr int RL = to_lane_rows(KR);
  const int lane = threadIdx.x & 31, lanes = row_lanes(h, QP8), sub = lane / lanes;
  const int rows = RL * (32 / lanes);  // of an item
  const int groups = (lq + rows - 1) / rows;
  const long long total = (long long)n_sets * chunks * groups;
  long long it = ((long long)blockIdx.x * kToWarps + (threadIdx.x >> 5)) * per_warp;
  const long long end = min(it + per_warp, total);
  const bool owide = d % 8 == 0;
  int held = -1;  // the (set, chunk) whose K and V the registers hold
  Slot8<QP8> sl(0, h, d);
  float kf[KR][8], vf[KR][8], madd[KR];
  const bf16* qb = nullptr;
  const float* bb = nullptr;
  bf16* ob = nullptr;
  for (; it < end; ++it) {
    const int bc = (int)(it / groups), r0 = (int)(it % groups) * rows;
    if (bc != held) {  // warp-uniform
      held = bc;
      const int b = bc / chunks;
      sl = Slot8<QP8>(32 * (bc % chunks) + lane % lanes, h, d);
#pragma unroll
      for (int j = 0; j < KR; ++j) {
        const bool in = j < lk;
        const long long row = in ? j : 0;
        unpack8(load8_raw(k.p + b * k.bs + row * k.ld + sl.off, 0, in ? sl.n : 0, wide), kf[j]);
        unpack8(load8_raw(v.p + b * v.bs + row * v.ld + sl.off, 0, in ? sl.n : 0, wide), vf[j]);
        madd[j] = !in ? -CUDART_INF_F : mask ? (mask[(long long)b * lk + j] - 1.f) * kNeg : 0.f;
      }
      qb = q.p + b * q.bs + sl.off;
      ob = out + (long long)b * lq * h * d + sl.off;
      bb = kBias ? bias + ((long long)b * h + sl.hd) * lq * lk : nullptr;
    }
    uint4 qr[RL];
#pragma unroll
    for (int i = 0; i < RL; ++i)  // rows past the last repeat it and store nothing
      qr[i] = load8_raw(qb + min(r0 + sub + i * (32 / lanes), lq - 1) * q.ld, 0, sl.n, wide);
#pragma unroll
    for (int i = 0; i < RL; ++i) {
      const int row = r0 + sub + i * (32 / lanes);
      float qf[8];
      unpack8(qr[i], qf);
#pragma unroll
      for (int c = 0; c < 8; ++c) qf[c] *= scale;
      float s[KR], mx = -CUDART_INF_F;
#pragma unroll
      for (int j = 0; j < KR; ++j) {
        float sc = head_dot8<QP8>(qf, kf[j]);
        if (kBias && j < lk) sc += bb[(long long)min(row, lq - 1) * lk + j];
        s[j] = sc + madd[j];
        mx = fmaxf(mx, s[j]);
      }
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < KR; ++j) {
        s[j] = exp_neg(s[j] - mx);
        sum += s[j];
      }
      const float inv = 1.f / sum;
      float o[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int j = 0; j < KR; ++j) {
        const float p = s[j] * inv;
#pragma unroll
        for (int c = 0; c < 8; ++c) o[c] = fmaf(p, vf[j][c], o[c]);
      }
      if (row < lq) store_slot8(ob + (long long)row * h * d, o, 1.f, sl.n, owide);
    }
  }
}

// With `report` (8 ints), nothing is launched: blocks, warps of a block,
// query rows (of a lane: "from"; of an item: "to"), keys a lane loads at a
// time ("from") or holds ("to"), items a warp takes ("to"; 0 for "from"),
// bytes of static shared memory, registers per thread, resident blocks an SM
// (CUDA's occupancy calculator; "to" deals its items for the launch bounds').
template <int QP8, int KR, bool kBias>
cudaError_t launch_to_bf16(HeadsT<bf16> q, HeadsT<bf16> k, HeadsT<bf16> v, const float* mask,
                           const float* bias, bf16* out, int b, int lq, int lk, int h, int d,
                           int chunks, bool wide, cudaStream_t stream, int* report) {
  constexpr int RL = to_lane_rows(KR);
  int dev = 0, sms = 0;
  cudaError_t err;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return err;
  const int rows = RL * (32 / row_lanes(h, QP8));
  const long long items = (long long)b * chunks * ((lq + rows - 1) / rows);
  const long long warps = (long long)sms * kToBlocksPerSm * kToWarps;
  const int per_warp = (int)((items + warps - 1) / warps);
  const int grid = (int)((items + (long long)per_warp * kToWarps - 1) / (per_warp * kToWarps));
  auto kernel = fused_to_bf16_kernel<QP8, KR, kBias>;
  if (report) {
    cudaFuncAttributes attr;
    if ((err = cudaFuncGetAttributes(&attr, kernel)) != cudaSuccess) return err;
    int resident = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&resident, kernel, 32 * kToWarps, 0);
    if (err != cudaSuccess) return err;
    const int r[8] = {grid, kToWarps, rows, KR, per_warp, (int)attr.sharedSizeBytes,
                      attr.numRegs, resident};
    for (int i = 0; i < 8; ++i) report[i] = r[i];
    return cudaSuccess;
  }
  fused_to_bf16_kernel<QP8, KR, kBias><<<grid, 32 * kToWarps, 0, stream>>>(
      q, k, v, mask, bias, out, b, lq, lk, h, d, chunks, 1.f / sqrtf((float)d), per_warp, wide);
  return cudaGetLastError();
}

template <int QP8, bool kBias>
cudaError_t launch_from_bf16(HeadsT<bf16> q, HeadsT<bf16> k, HeadsT<bf16> v, const float* mask,
                             const float* bias, bf16* out, int b, int lq, int lk, int h, int d,
                             int chunks, bool wide, cudaStream_t stream, int* report) {
  auto kernel = fused_from_bf16_kernel<QP8, kBias>;
  if (report) {
    cudaFuncAttributes attr;
    cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
    if (err != cudaSuccess) return err;
    int resident = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&resident, kernel, 32 * kFromWarps, 0);
    if (err != cudaSuccess) return err;
    const int r[8] = {b * chunks, kFromWarps, kFromRows, kFromKeys, 0, (int)attr.sharedSizeBytes,
                      attr.numRegs, resident};
    for (int i = 0; i < 8; ++i) report[i] = r[i];
    return cudaSuccess;
  }
  fused_from_bf16_kernel<QP8, kBias><<<b * chunks, 32 * kFromWarps, 0, stream>>>(
      q, k, v, mask, bias, out, lq, lk, h, d, chunks, 1.f / sqrtf((float)d), wide);
  return cudaGetLastError();
}

template <int QP8, bool kBias>
cudaError_t launch_fused_bf16_b(HeadsT<bf16> q, HeadsT<bf16> k, HeadsT<bf16> v, const float* mask,
                                const float* bias, bf16* out, int b, int lq, int lk, int h, int d,
                                cudaStream_t stream, int* report) {
  const int chunks = (h * QP8 + 31) / 32;
  // 16-byte loads where every slot starts on 16 bytes
  const bool wide = d % 8 == 0 && q.bs % 8 == 0 && q.ld % 8 == 0 && k.bs % 8 == 0 &&
                    k.ld % 8 == 0 && v.bs % 8 == 0 && v.ld % 8 == 0 &&
                    reinterpret_cast<uintptr_t>(q.p) % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(k.p) % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(v.p) % 16 == 0;
  if (lk <= 4)
    return launch_to_bf16<QP8, 4, kBias>(q, k, v, mask, bias, out, b, lq, lk, h, d, chunks, wide,
                                         stream, report);
  if (lk <= kFusedRegKeys)
    return launch_to_bf16<QP8, kFusedRegKeys, kBias>(q, k, v, mask, bias, out, b, lq, lk, h, d,
                                                     chunks, wide, stream, report);
  return launch_from_bf16<QP8, kBias>(q, k, v, mask, bias, out, b, lq, lk, h, d, chunks, wide,
                                      stream, report);
}

template <int QP8>
cudaError_t launch_fused_bf16_qp(HeadsT<bf16> q, HeadsT<bf16> k, HeadsT<bf16> v, const float* mask,
                                 const float* bias, bf16* out, int b, int lq, int lk, int h,
                                 int d, cudaStream_t stream, int* report) {
  if (bias != nullptr)
    return launch_fused_bf16_b<QP8, true>(q, k, v, mask, bias, out, b, lq, lk, h, d, stream,
                                          report);
  return launch_fused_bf16_b<QP8, false>(q, k, v, mask, bias, out, b, lq, lk, h, d, stream,
                                         report);
}

cudaError_t launch_fused_bf16(HeadsT<bf16> q, HeadsT<bf16> k, HeadsT<bf16> v, const float* mask,
                              const float* bias, bf16* out, int b, int lq, int lk, int h, int d,
                              cudaStream_t stream, int* report) {
  if (b <= 0 || h <= 0 || lq <= 0 || lq > kMaxFusedLen || lk <= 0 || lk > kMaxFusedLen ||
      d <= 0 || d > kMaxHeadDim)
    return cudaErrorInvalidValue;
  if (d <= 8)
    return launch_fused_bf16_qp<1>(q, k, v, mask, bias, out, b, lq, lk, h, d, stream, report);
  if (d <= 16)
    return launch_fused_bf16_qp<2>(q, k, v, mask, bias, out, b, lq, lk, h, d, stream, report);
  if (d <= 32)
    return launch_fused_bf16_qp<4>(q, k, v, mask, bias, out, b, lq, lk, h, d, stream, report);
  return launch_fused_bf16_qp<8>(q, k, v, mask, bias, out, b, lq, lk, h, d, stream, report);
}

}  // namespace

// Both take the same arguments (the packed one wants lq == lk) and return the
// launch's cudaError_t (0 on success). The Python wrappers
// (particle_fm_tpu_torch/ops/short_attention.py) checked devices, types and
// shapes. `mask` (B, Lk) and `bias` (B, H, Lq, Lk) are contiguous or null;
// `out` is contiguous (B, Lq, H, D).

extern "C" int packed_short_attention_f32(
    const float* q, const float* k, const float* v, const float* mask, const float* bias,
    float* out, int b, int lq, int lk, int h, int d,
    long long q_bs, long long q_ld, long long k_bs, long long k_ld,
    long long v_bs, long long v_ld, void* stream_ptr) {
  if (lk != lq) return (int)cudaErrorInvalidValue;
  return (int)launch_packed_d(heads(q, q_bs, q_ld, d), heads(k, k_bs, k_ld, d),
                              heads(v, v_bs, v_ld, d), mask, bias, out, b, lq, h, d,
                              static_cast<cudaStream_t>(stream_ptr), bias != nullptr, nullptr);
}

// What the packed kernel's launcher gives a block for sets of `l` particles at
// head dim `d`, with or without a bias, into `report`: blocks per (set, head),
// warps, keys staged, bytes of shared memory, registers per thread, TF32
// products per float32 product. Launches nothing.
extern "C" int packed_short_attention_geometry(int l, int d, int biased, int* report) {
  const Heads none{};
  return (int)launch_packed_d(none, none, none, nullptr, nullptr, nullptr, 1, l, 1, d, nullptr,
                              biased != 0, report);
}

extern "C" const char* attention_mma_instruction() { return MMA_TF32_INSTRUCTION; }

// The bfloat16 packed kernel: q, k, v and the output in bfloat16, the mask
// and the bias in float32; arguments as packed_short_attention_f32's. Head dims
// up to 16 run padded to 16.
extern "C" int packed_short_attention_bf16(
    const __nv_bfloat16* q, const __nv_bfloat16* k, const __nv_bfloat16* v, const float* mask,
    const float* bias, __nv_bfloat16* out, int b, int lq, int lk, int h, int d,
    long long q_bs, long long q_ld, long long k_bs, long long k_ld,
    long long v_bs, long long v_ld, void* stream_ptr) {
  if (lk != lq) return (int)cudaErrorInvalidValue;
  return (int)launch_packed_bf16_d(heads(q, q_bs, q_ld, d), heads(k, k_bs, k_ld, d),
                                   heads(v, v_bs, v_ld, d), mask, bias, out, b, lq, h, d,
                                   static_cast<cudaStream_t>(stream_ptr), nullptr);
}

// What the bfloat16 packed kernel's launcher gives B sets of `l` particles at
// H heads of `d`, with or without a bias, into `report` (8 ints, as
// launch_packed_bf16 lists them). Launches nothing.
extern "C" int packed_short_attention_bf16_geometry(int b, int l, int h, int d, int biased,
                                                    int* report) {
  const HeadsT<bf16> none{};
  const float one = 0.f;
  return (int)launch_packed_bf16_d(none, none, none, nullptr, biased ? &one : nullptr, nullptr,
                                   b, l, h, d, nullptr, report);
}

extern "C" const char* attention_mma_bf16_instruction() { return MMA_BF16_INSTRUCTION; }


extern "C" int fused_short_attention_f32(
    const float* q, const float* k, const float* v, const float* mask, const float* bias,
    float* out, int b, int lq, int lk, int h, int d,
    long long q_bs, long long q_ld, long long k_bs, long long k_ld,
    long long v_bs, long long v_ld, void* stream_ptr) {
  return fused_entry(q, k, v, mask, bias, out, b, lq, lk, h, d, q_bs, q_ld, k_bs, k_ld, v_bs,
                     v_ld, stream_ptr);
}

// The bfloat16 fused kernels ("from" above 8 keys, "to" up to 8): q, k, v
// and the output in bfloat16, float32 arithmetic on their values, which is
// what the Pallas kernel computes on bfloat16 inputs (it upcasts q, k and v
// and keeps P in float32: short_attention.py:47-65).
extern "C" int fused_short_attention_bf16(
    const __nv_bfloat16* q, const __nv_bfloat16* k, const __nv_bfloat16* v, const float* mask,
    const float* bias, __nv_bfloat16* out, int b, int lq, int lk, int h, int d,
    long long q_bs, long long q_ld, long long k_bs, long long k_ld,
    long long v_bs, long long v_ld, void* stream_ptr) {
  return (int)launch_fused_bf16(heads(q, q_bs, q_ld, d), heads(k, k_bs, k_ld, d),
                                heads(v, v_bs, v_ld, d), mask, bias, out, b, lq, lk, h, d,
                                static_cast<cudaStream_t>(stream_ptr), nullptr);
}

// What the bfloat16 fused kernels' launcher gives these shapes, with or
// without a bias, into `report` (8 ints, as launch_to_bf16 lists them; the
// kernel is "from" when lk > 8). Launches nothing.
extern "C" int fused_short_attention_bf16_geometry(int b, int lq, int lk, int h, int d,
                                                   int biased, int* report) {
  const HeadsT<bf16> none{};
  const float one = 0.f;
  return (int)launch_fused_bf16(none, none, none, nullptr, biased ? &one : nullptr, nullptr, b, lq,
                                lk, h, d, nullptr, report);
}
