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
// Bounds on an H100 SXM (67 TFLOP/s float32 on the CUDA cores, 3.35 TB/s):
//   packed, PC-Droid transformer shape (B=640, L=150, H=16, D=16): q, k, v and
//     the output are 393 MB, 0.12 ms; the two products are 4*B*H*L*L*D =
//     14.7 GFLOP, 0.22 ms. Bound by operations.
//   fused, cross-attention shapes (B=640, H=16, D=8; Lq=4, Lk=150 and Lq=150,
//     Lk=4): about 100 MB and 0.2 GFLOP each. Bound by bytes.
//
// Design of the packed kernel: one block per (set, head), so 640 sets x 16
// heads give the 132 SMs 10,240 blocks. The head's K and V rows (2 x 9.6 KB
// at L=150, D=16) are staged in shared memory once. One thread owns one query
// row: q and the output accumulator stay in registers, the thread walks over
// the keys 8 at a time (8 scores in registers, one running-maximum update and
// one rescale of the accumulator per 8 keys, then 8 exponentials and the PV
// multiply-adds). All threads of a warp read the same K or V row at a time, a
// shared-memory broadcast, so a 16-byte load feeds 4 multiply-adds in each of
// 32 threads and the FMA pipes, not shared memory, set the pace.
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

#include "attention_common.cuh"

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
// packed: block = (set, head), thread = query row
// ---------------------------------------------------------------------------

constexpr int kChunk = 8;  // keys whose scores a thread holds at a time

template <int DP>
__global__ void __launch_bounds__(kMaxPackedLen)
packed_attention_kernel(Heads q, Heads k, Heads v, const float* __restrict__ mask,
                        const float* __restrict__ bias, float* __restrict__ out,
                        int l, int h, int d, float scale) {
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  const int lp = (l + kChunk - 1) / kChunk * kChunk;
  float* ks = sm;
  float* vs = ks + lp * DP;
  float* madd = vs + lp * DP;
  const int b = blockIdx.x / h, hd = blockIdx.x % h;

  stage_head<DP>(ks, DP, k.p + b * k.bs + hd * d, k.ld, l, lp, d, k.vec);
  stage_head<DP>(vs, DP, v.p + b * v.bs + hd * d, v.ld, l, lp, d, v.vec);
  for (int j = threadIdx.x; j < lp; j += blockDim.x) {
    float a = -CUDART_INF_F;  // keys past the set's end take no weight
    if (j < l) a = mask ? (mask[(long long)b * l + j] - 1.f) * kNeg : 0.f;
    madd[j] = a;
  }
  __syncthreads();

  const int row = threadIdx.x;
  if (row >= l) return;
  float qr[DP];
  load_row<DP>(qr, q.p + b * q.bs + row * q.ld + hd * d, d, q.vec);
  const float* brow = bias ? bias + (((long long)b * h + hd) * l + row) * l : nullptr;

  float o[DP];
#pragma unroll
  for (int c = 0; c < DP; ++c) o[c] = 0.f;
  float m = -CUDART_INF_F, sum = 0.f;

  for (int j0 = 0; j0 < lp; j0 += kChunk) {
    float s[kChunk];
    float cm = -CUDART_INF_F;
#pragma unroll
    for (int c = 0; c < kChunk; ++c) {
      const int j = j0 + c;
      float sc = dot_row<DP>(qr, ks + j * DP) * scale + madd[j];
      if (brow != nullptr && j < l) sc += brow[j];
      s[c] = sc;
      cm = fmaxf(cm, sc);
    }
    // every chunk starts on a key of the set, so cm is finite
    const float mn = fmaxf(m, cm);
    const float corr = exp_neg(m - mn);  // 0 at the first chunk (m = -inf)
    sum *= corr;
#pragma unroll
    for (int c = 0; c < DP; ++c) o[c] *= corr;
#pragma unroll
    for (int c = 0; c < kChunk; ++c) {
      const float p = exp_neg(s[c] - mn);
      sum += p;
      axpy_row<DP>(o, p, vs + (j0 + c) * DP);
    }
    m = mn;
  }

  const float inv = 1.f / sum;
  float* orow = out + (((long long)b * l + row) * h + hd) * d;
  if (d % 4 == 0) {
#pragma unroll
    for (int c = 0; c < DP; c += 4)
      if (c < d)
        *reinterpret_cast<float4*>(orow + c) =
            make_float4(o[c] * inv, o[c + 1] * inv, o[c + 2] * inv, o[c + 3] * inv);
  } else {
#pragma unroll
    for (int c = 0; c < DP; ++c)
      if (c < d) orow[c] = o[c] * inv;
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

template <int DP>
cudaError_t launch_packed(Heads q, Heads k, Heads v, const float* mask, const float* bias,
                          float* out, int b, int l, int h, int d, cudaStream_t stream) {
  const int lp = (l + kChunk - 1) / kChunk * kChunk;
  const size_t smem = sizeof(float) * ((size_t)2 * lp * DP + lp);
  cudaError_t err = allow_smem(packed_attention_kernel<DP>, smem);
  if (err != cudaSuccess) return err;
  const int threads = (l + 31) / 32 * 32;
  packed_attention_kernel<DP><<<b * h, threads, smem, stream>>>(
      q, k, v, mask, bias, out, l, h, d, 1.f / sqrtf((float)d));
  return cudaGetLastError();
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
  const int l = lq;
  if (b <= 0 || h <= 0 || lk != lq || l <= 0 || l > kMaxPackedLen || d <= 0 || d > kMaxHeadDim)
    return (int)cudaErrorInvalidValue;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const Heads qh = heads(q, q_bs, q_ld, d), kh = heads(k, k_bs, k_ld, d),
              vh = heads(v, v_bs, v_ld, d);
  if (d <= 8) return (int)launch_packed<8>(qh, kh, vh, mask, bias, out, b, l, h, d, stream);
  if (d <= 16) return (int)launch_packed<16>(qh, kh, vh, mask, bias, out, b, l, h, d, stream);
  if (d <= 32) return (int)launch_packed<32>(qh, kh, vh, mask, bias, out, b, l, h, d, stream);
  return (int)launch_packed<64>(qh, kh, vh, mask, bias, out, b, l, h, d, stream);
}

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
