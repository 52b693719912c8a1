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
template <int QP, int KR>
__global__ void __launch_bounds__(32 * kFewWarps)
fused_few_keys_kernel(Heads q, Heads k, Heads v, const float* __restrict__ mask,
                      const float* __restrict__ bias, float* __restrict__ out, int n_sets,
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
  const float *qb = nullptr, *bb = nullptr;
  float* ob = nullptr;
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
template <int QP>
__global__ void __launch_bounds__(32 * kManyWarps, 5)
fused_many_keys_kernel(Heads q, Heads k, Heads v, const float* __restrict__ mask,
                       const float* __restrict__ bias, float* __restrict__ out,
                       int lq, int lk, int h, int d, int chunks, float scale) {
  constexpr int R = kFusedRows;
  __shared__ float4 part_o[kManyWarps][R][32];
  __shared__ float2 part_ml[kManyWarps][R][32];
  const int b = blockIdx.x / chunks, warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const Slot<QP> sl(blockIdx.x % chunks, h, d);
  const float* qb = q.p + b * q.bs + sl.off;
  const float* kb = k.p + b * k.bs + sl.off;
  const float* vb = v.p + b * v.bs + sl.off;
  const float* mb = mask ? mask + (long long)b * lk : nullptr;
  const float* bb = bias ? bias + ((long long)b * h + sl.hd) * lq * lk : nullptr;
  float* ob = out + (long long)b * lq * h * d + sl.off;
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

template <int QP, int KR>
cudaError_t launch_few_keys(Heads q, Heads k, Heads v, const float* mask, const float* bias,
                            float* out, int b, int lq, int lk, int h, int d, int chunks,
                            float scale, cudaStream_t stream) {
  constexpr int RB = KR <= 4 ? 4 : 2;
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fused_few_keys_kernel<QP, KR>,
                                                      32 * kFewWarps, 0);
  if (err != cudaSuccess) return err;
  const long long items = (long long)b * chunks * ((lq + RB - 1) / RB);
  const long long warps = (long long)sms * max(per_sm, 1) * kFewWarps;
  const int per_warp = (int)((items + warps - 1) / warps);
  const int grid = (int)((items + (long long)per_warp * kFewWarps - 1) / (per_warp * kFewWarps));
  fused_few_keys_kernel<QP, KR><<<grid, 32 * kFewWarps, 0, stream>>>(
      q, k, v, mask, bias, out, b, lq, lk, h, d, chunks, scale, per_warp);
  return cudaGetLastError();
}

// QP: lanes a head spans (1, 2, 4, 8 or 16 for head dims up to 4, 8, 16, 32, 64)
template <int QP>
cudaError_t launch_fused(Heads q, Heads k, Heads v, const float* mask, const float* bias,
                         float* out, int b, int lq, int lk, int h, int d, cudaStream_t stream) {
  const int chunks = (h * QP + 31) / 32;
  const float scale = 1.f / sqrtf((float)d);
  if (lk <= 4)
    return launch_few_keys<QP, 4>(q, k, v, mask, bias, out, b, lq, lk, h, d, chunks, scale,
                                  stream);
  if (lk <= kFusedRegKeys)
    return launch_few_keys<QP, kFusedRegKeys>(q, k, v, mask, bias, out, b, lq, lk, h, d, chunks,
                                              scale, stream);
  fused_many_keys_kernel<QP><<<b * chunks, 32 * kManyWarps, 0, stream>>>(
      q, k, v, mask, bias, out, lq, lk, h, d, chunks, scale);
  return cudaGetLastError();
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

extern "C" int fused_short_attention_f32(
    const float* q, const float* k, const float* v, const float* mask, const float* bias,
    float* out, int b, int lq, int lk, int h, int d,
    long long q_bs, long long q_ld, long long k_bs, long long k_ld,
    long long v_bs, long long v_ld, void* stream_ptr) {
  if (b <= 0 || h <= 0 || lq <= 0 || lq > kMaxFusedLen || lk <= 0 || lk > kMaxFusedLen ||
      d <= 0 || d > kMaxHeadDim)
    return (int)cudaErrorInvalidValue;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const Heads qh = heads(q, q_bs, q_ld, d), kh = heads(k, k_bs, k_ld, d),
              vh = heads(v, v_bs, v_ld, d);
  if (d <= 4) return (int)launch_fused<1>(qh, kh, vh, mask, bias, out, b, lq, lk, h, d, stream);
  if (d <= 8) return (int)launch_fused<2>(qh, kh, vh, mask, bias, out, b, lq, lk, h, d, stream);
  if (d <= 16) return (int)launch_fused<4>(qh, kh, vh, mask, bias, out, b, lq, lk, h, d, stream);
  if (d <= 32) return (int)launch_fused<8>(qh, kh, vh, mask, bias, out, b, lq, lk, h, d, stream);
  return (int)launch_fused<16>(qh, kh, vh, mask, bias, out, b, lq, lk, h, d, stream);
}
