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
// bytes, so it needs many loads in flight, not arithmetic. One block per
// (set, head) stages the head's K and V in shared memory (row stride D+4
// floats: 16-byte loads of neighbouring rows fall on different banks). A
// group of G lanes owns one query row, G = 4, 8, 16 or 32 by Lk, so with 4
// keys a warp works on 8 query rows at once and with 150 keys a warp splits
// them 5 to a lane. A lane keeps its scores in registers (at most 16: Lk <=
// 512), the maximum, the sum and the output are reduced over the group with
// shuffles.

#include "attention_mma.cuh"

namespace {

constexpr int kMaxPackedLen = 256;
constexpr int kMaxFusedLen = 512;
constexpr int kMaxHeadDim = 64;
constexpr int kFusedThreads = 128;

template <int DP>
__device__ __forceinline__ void load_row(float (&r)[DP], const float* row, int d, bool vec) {
#pragma unroll
  for (int c = 0; c < DP; c += 4) {
    const float4 val = load4(row, c, d, vec);
    r[c + 0] = val.x; r[c + 1] = val.y; r[c + 2] = val.z; r[c + 3] = val.w;
  }
}

template <int DP>
__device__ __forceinline__ float dot_row(const float (&q)[DP], const float* krow) {
  float acc = 0.f;
#pragma unroll
  for (int c = 0; c < DP; c += 4) {
    const float4 kk = *reinterpret_cast<const float4*>(krow + c);
    acc = fmaf(q[c + 0], kk.x, acc);
    acc = fmaf(q[c + 1], kk.y, acc);
    acc = fmaf(q[c + 2], kk.z, acc);
    acc = fmaf(q[c + 3], kk.w, acc);
  }
  return acc;
}

template <int DP>
__device__ __forceinline__ void axpy_row(float (&o)[DP], float p, const float* vrow) {
#pragma unroll
  for (int c = 0; c < DP; c += 4) {
    const float4 vv = *reinterpret_cast<const float4*>(vrow + c);
    o[c + 0] = fmaf(p, vv.x, o[c + 0]);
    o[c + 1] = fmaf(p, vv.y, o[c + 1]);
    o[c + 2] = fmaf(p, vv.z, o[c + 2]);
    o[c + 3] = fmaf(p, vv.w, o[c + 3]);
  }
}

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
// fused: block = (set, head), group of G lanes = query row
// ---------------------------------------------------------------------------

template <int G>
__device__ __forceinline__ float group_max(float x) {
#pragma unroll
  for (int off = G / 2; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

template <int G>
__device__ __forceinline__ float group_sum(float x) {
#pragma unroll
  for (int off = G / 2; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

template <int DP, int G>
__global__ void __launch_bounds__(kFusedThreads)
fused_attention_kernel(Heads q, Heads k, Heads v, const float* __restrict__ mask,
                       const float* __restrict__ bias, float* __restrict__ out,
                       int lq, int lk, int h, int d, float scale) {
  constexpr int KPL = G == 32 ? kMaxFusedLen / 32 : 1;  // keys a lane holds
  constexpr int ST = DP + 4;
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  float* ks = sm;
  float* vs = ks + lk * ST;
  float* madd = vs + lk * ST;
  const int b = blockIdx.x / h, hd = blockIdx.x % h;

  stage_head<DP>(ks, ST, k.p + b * k.bs + hd * d, k.ld, lk, lk, d, k.vec);
  stage_head<DP>(vs, ST, v.p + b * v.bs + hd * d, v.ld, lk, lk, d, v.vec);
  for (int j = threadIdx.x; j < lk; j += blockDim.x)
    madd[j] = mask ? (mask[(long long)b * lk + j] - 1.f) * kNeg : 0.f;
  __syncthreads();

  const int gl = threadIdx.x % G, grp = threadIdx.x / G;
  constexpr int kGroups = kFusedThreads / G;
  for (int r0 = 0; r0 < lq; r0 += kGroups) {
    // a group past the last row repeats the last row and stores nothing, so
    // every lane of a warp takes part in the shuffles
    const bool store = r0 + grp < lq;
    const int row = store ? r0 + grp : lq - 1;
    float qr[DP];
    load_row<DP>(qr, q.p + b * q.bs + row * q.ld + hd * d, d, q.vec);
#pragma unroll
    for (int c = 0; c < DP; ++c) qr[c] *= scale;
    const float* brow = bias ? bias + (((long long)b * h + hd) * lq + row) * lk : nullptr;

    float s[KPL];
    float m = -CUDART_INF_F;
#pragma unroll
    for (int i = 0; i < KPL; ++i) {
      const int j = gl + G * i;
      float sc = -CUDART_INF_F;
      if (j < lk) {
        sc = dot_row<DP>(qr, ks + j * ST);
        if (brow != nullptr) sc += brow[j];
        sc += madd[j];
      }
      s[i] = sc;
      m = fmaxf(m, sc);
    }
    m = group_max<G>(m);
    float sum = 0.f;
#pragma unroll
    for (int i = 0; i < KPL; ++i) {
      s[i] = exp_neg(s[i] - m);
      sum += s[i];
    }
    sum = group_sum<G>(sum);

    float o[DP];
#pragma unroll
    for (int c = 0; c < DP; ++c) o[c] = 0.f;
#pragma unroll
    for (int i = 0; i < KPL; ++i) {
      const int j = gl + G * i;
      if (j < lk) axpy_row<DP>(o, s[i] / sum, vs + j * ST);
    }
#pragma unroll
    for (int c = 0; c < DP; ++c) o[c] = group_sum<G>(o[c]);

    if (!store) continue;
    float* orow = out + (((long long)b * lq + row) * h + hd) * d;
    if (d % 4 == 0) {
      // every lane holds the whole row; lane gl writes the float4s gl, gl+G, ...
#pragma unroll
      for (int c4 = 0; c4 < DP / 4; ++c4)
        if (c4 % G == gl && 4 * c4 < d)
          *reinterpret_cast<float4*>(orow + 4 * c4) =
              make_float4(o[4 * c4], o[4 * c4 + 1], o[4 * c4 + 2], o[4 * c4 + 3]);
    } else if (gl == 0) {
#pragma unroll
      for (int c = 0; c < DP; ++c)
        if (c < d) orow[c] = o[c];
    }
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

template <int DP, int G>
cudaError_t launch_fused(Heads q, Heads k, Heads v, const float* mask, const float* bias,
                         float* out, int b, int lq, int lk, int h, int d, cudaStream_t stream) {
  const size_t smem = sizeof(float) * ((size_t)2 * lk * (DP + 4) + lk);
  if (smem > (size_t)kMaxSmem) return cudaErrorInvalidValue;
  cudaError_t err = allow_smem(fused_attention_kernel<DP, G>, smem);
  if (err != cudaSuccess) return err;
  fused_attention_kernel<DP, G><<<b * h, kFusedThreads, smem, stream>>>(
      q, k, v, mask, bias, out, lq, lk, h, d, 1.f / sqrtf((float)d));
  return cudaGetLastError();
}

template <int DP>
cudaError_t launch_fused_dp(Heads q, Heads k, Heads v, const float* mask, const float* bias,
                            float* out, int b, int lq, int lk, int h, int d,
                            cudaStream_t stream) {
  if (lk <= 4) return launch_fused<DP, 4>(q, k, v, mask, bias, out, b, lq, lk, h, d, stream);
  if (lk <= 8) return launch_fused<DP, 8>(q, k, v, mask, bias, out, b, lq, lk, h, d, stream);
  if (lk <= 16) return launch_fused<DP, 16>(q, k, v, mask, bias, out, b, lq, lk, h, d, stream);
  return launch_fused<DP, 32>(q, k, v, mask, bias, out, b, lq, lk, h, d, stream);
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

extern "C" const char* attention_mma_instruction() { return ATTENTION_MMA_INSTRUCTION; }

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
  if (d <= 8) return (int)launch_fused_dp<8>(qh, kh, vh, mask, bias, out, b, lq, lk, h, d, stream);
  if (d <= 16)
    return (int)launch_fused_dp<16>(qh, kh, vh, mask, bias, out, b, lq, lk, h, d, stream);
  if (d <= 32)
    return (int)launch_fused_dp<32>(qh, kh, vh, mask, bias, out, b, lq, lk, h, d, stream);
  return (int)launch_fused_dp<64>(qh, kh, vh, mask, bias, out, b, lq, lk, h, d, stream);
}
