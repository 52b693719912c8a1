// Blockwise (flash) masked attention for sets of any length, forward only,
// float32, sm_90a. Replaces `flash_masked_attention` (-> `_kernel`) of
// particle_fm_tpu/ops/pallas/flash_attention.py:
//
//   s = (q * scale) . k + (mask - 1) * 1e9          scale = 1 / sqrt(D)
//   over the keys in order, with a running maximum m (from -1e9), a running
//   sum l and an accumulator acc that are rescaled whenever m grows:
//     p = exp(s - m),  l += sum p,  acc += p . v
//   o = acc / max(l, 1e-30)
//
// The (Lq, Lk) scores never exist in memory. No bias. q (B, Lq, H, D) and
// k/v (B, Lk, H, D) are read where they lie (heads packed in the last two
// axes; the distances between rows and between sets are arguments, so the
// slices of a fused QKV projection or a (B, N, hidden) projection output split
// into heads need no copy); the output is a contiguous (B, Lq, H, D). The
// ragged edges of Lq and Lk are handled here, nothing is padded: a set whose
// keys are all masked spreads its weight over exactly its Lk keys.
//
// What differs from the TPU kernel. There one program keeps a whole head's K
// and V on chip (3 MB each at Lk=6000, D=128); a block here has 227 KB, so K
// and V are streamed through shared memory in tiles of 16 KB each, and the
// tile loop is the softmax's chunk loop. A group of G lanes owns one query
// row and splits the head dim: lane g keeps the float4s g, g+G, ... of the
// scaled q row and of the accumulator in registers (16 floats each at the
// usual G), the partial dot products are summed over the group with
// shuffles, and every lane of the group carries the same m and l. All lanes
// read the same staged K or V row at a time, neighbouring lanes neighbouring
// float4s, so shared memory is read without bank conflicts. A lane takes 8
// keys at a time: 8 scores in registers, one update of the maximum and one
// rescale of the accumulator per 8 keys.
//
// Two shapes are served. The PC-Droid transformer on 279-particle sets
// (B=256, Lq=Lk=279, H=16, D=16) is bound by operations (20.4 GFLOP in the
// two products, 0.32 ms at 67 TFLOP/s float32 against 0.09 ms for its 293
// MB): G=1, one thread per query row as in the packed kernel, 93 rows per
// block, three blocks per (set, head). MDMA's class token on calorimeter
// showers (B=32, Lq=1, Lk=6000, H=2, D=128) is bound by bytes (393 MB of K
// and V, 0.12 ms at 3.35 TB/s) and has only 64 (set, head) pairs for 132 SMs.
// There one warp owns the row (G=32) and the keys are split over `splits`
// blocks per pair; each writes its partial (m, l, acc) to scratch memory and
// a second small kernel merges them:
//   M = max m_s,  o = sum acc_s e^(m_s - M) / max(sum l_s e^(m_s - M), 1e-30)
// The wrapper chooses `splits` (1: no scratch, no merge) and allocates the
// scratch. With at most 4 query rows nothing is shared between rows, so this
// variant does not stage: a lane loads its float4 of 8 K rows and 8 V rows
// straight from device memory, 16 loads in flight before the first is used
// (staged through shared memory by a single warp the loads go one after
// another, and the kernel takes 3.6 times as long at MDMA's shape).

#include "attention_common.cuh"

namespace {

constexpr int kThreads = 128;       // most threads of a block
constexpr int kSub = 8;             // keys whose scores a lane holds at a time
constexpr int kTileFloats = 4096;   // floats of K, and of V, staged at a time (16 KB each)
constexpr float kMinSum = 1e-30f;

__device__ __forceinline__ void store4(float* row, int c, int d, float4 val) {
  if (d % 4 == 0) {
    if (c < d) *reinterpret_cast<float4*>(row + c) = val;
  } else {
    if (c + 0 < d) row[c + 0] = val.x;
    if (c + 1 < d) row[c + 1] = val.y;
    if (c + 2 < d) row[c + 2] = val.z;
    if (c + 3 < d) row[c + 3] = val.w;
  }
}

// One step of the streaming softmax over 8 keys for one lane. `kload(c, i)`
// and `vload(c, i)` give the lane's i-th float4 of the step's c-th K and V
// row, `madd(c)` the key's additive mask (-inf past the range's end; the first
// key of a step is always inside it, so the step's maximum is finite).
template <int F4, int G, typename KLoad, typename VLoad, typename MAdd>
__device__ __forceinline__ void softmax_step(const float (&qr)[4 * F4], float (&o)[4 * F4],
                                             float& m, float& l, KLoad kload, VLoad vload,
                                             MAdd madd) {
  float s[kSub];
  float cm = -CUDART_INF_F;
#pragma unroll
  for (int c = 0; c < kSub; ++c) {
    float acc = 0.f;
#pragma unroll
    for (int i = 0; i < F4; ++i) {
      const float4 kk = kload(c, i);
      acc = fmaf(qr[4 * i + 0], kk.x, acc);
      acc = fmaf(qr[4 * i + 1], kk.y, acc);
      acc = fmaf(qr[4 * i + 2], kk.z, acc);
      acc = fmaf(qr[4 * i + 3], kk.w, acc);
    }
#pragma unroll
    for (int off = G / 2; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
    acc += madd(c);
    s[c] = acc;
    cm = fmaxf(cm, acc);
  }
  const float mn = fmaxf(m, cm);
  const float corr = exp_neg(m - mn);
  l *= corr;
#pragma unroll
  for (int c = 0; c < 4 * F4; ++c) o[c] *= corr;
#pragma unroll
  for (int c = 0; c < kSub; ++c) {
    const float p = exp_neg(s[c] - mn);
    l += p;
#pragma unroll
    for (int i = 0; i < F4; ++i) {
      const float4 vv = vload(c, i);
      o[4 * i + 0] = fmaf(p, vv.x, o[4 * i + 0]);
      o[4 * i + 1] = fmaf(p, vv.y, o[4 * i + 1]);
      o[4 * i + 2] = fmaf(p, vv.z, o[4 * i + 2]);
      o[4 * i + 3] = fmaf(p, vv.w, o[4 * i + 3]);
    }
  }
  m = mn;
}

// Grid: x = (set, head), y = tile of `rows` query rows, z = split of the keys.
// Block: `rows` groups of G lanes, rounded up to whole warps. `part` is null
// when the keys are not split; else (splits, B, Lq, H, D) partial accumulators
// followed by (splits, B, Lq, H, 2) pairs (m, l). kDirect: K and V rows are
// read straight from device memory, not staged (no shared memory is used).
template <int DP, int G, bool kDirect>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(Heads q, Heads k, Heads v, const float* __restrict__ mask,
                       float* __restrict__ out, float* __restrict__ part,
                       int lq, int lk, int h, int d, int rows, int keys_per_split, float scale) {
  constexpr int KC = kTileFloats / DP;  // keys of a tile
  constexpr int F4 = DP / 4 / G;        // float4s of a row that one lane owns
  extern __shared__ float4 smem4[];
  float* ks = reinterpret_cast<float*>(smem4);
  float* vs = ks + KC * DP;
  float* madd = vs + KC * DP;

  const int b = blockIdx.x / h, hd = blockIdx.x % h;
  const int gl = threadIdx.x % G, slot = threadIdx.x / G;
  // a group past the tile's or the set's last row repeats the last row and
  // stores nothing, so every lane takes part in the shuffles and barriers
  const int row_raw = blockIdx.y * rows + slot;
  const bool store = slot < rows && row_raw < lq;
  const int row = min(row_raw, lq - 1);
  const int kbeg = blockIdx.z * keys_per_split;
  const int kend = min(lk, kbeg + keys_per_split);

  float qr[4 * F4], o[4 * F4];
  const float* qrow = q.p + b * q.bs + row * q.ld + hd * d;
#pragma unroll
  for (int i = 0; i < F4; ++i) {
    const float4 val = load4(qrow, 4 * (gl + G * i), d, q.vec);
    qr[4 * i + 0] = val.x * scale; qr[4 * i + 1] = val.y * scale;
    qr[4 * i + 2] = val.z * scale; qr[4 * i + 3] = val.w * scale;
    o[4 * i + 0] = 0.f; o[4 * i + 1] = 0.f; o[4 * i + 2] = 0.f; o[4 * i + 3] = 0.f;
  }
  float m = -kNeg, l = 0.f;

  const float* kbase = k.p + b * k.bs + hd * d;
  const float* vbase = v.p + b * v.bs + hd * d;
  if constexpr (kDirect) {
    for (int j0 = kbeg; j0 < kend; j0 += kSub) {
      float4 kk[kSub][F4], vv[kSub][F4];
      float a[kSub];
#pragma unroll
      for (int c = 0; c < kSub; ++c) {
        const int key = min(j0 + c, kend - 1);  // past the end: a row to read, no weight
#pragma unroll
        for (int i = 0; i < F4; ++i) {
          kk[c][i] = load4(kbase + key * k.ld, 4 * (gl + G * i), d, k.vec);
          vv[c][i] = load4(vbase + key * v.ld, 4 * (gl + G * i), d, v.vec);
        }
        a[c] = -CUDART_INF_F;
        if (j0 + c < kend) a[c] = mask ? (mask[(long long)b * lk + key] - 1.f) * kNeg : 0.f;
      }
      softmax_step<F4, G>(
          qr, o, m, l, [&](int c, int i) { return kk[c][i]; },
          [&](int c, int i) { return vv[c][i]; }, [&](int c) { return a[c]; });
    }
  } else {
    for (int c0 = kbeg; c0 < kend; c0 += KC) {
      const int n = min(KC, kend - c0);
      const int np = (n + kSub - 1) / kSub * kSub;  // <= KC: KC is a multiple of kSub
      __syncthreads();  // the previous tile has been used
      stage_head<DP>(ks, DP, kbase + c0 * k.ld, k.ld, n, np, d, k.vec);
      stage_head<DP>(vs, DP, vbase + c0 * v.ld, v.ld, n, np, d, v.vec);
      for (int j = threadIdx.x; j < np; j += blockDim.x) {
        float a = -CUDART_INF_F;  // keys past the range's end take no weight
        if (j < n) a = mask ? (mask[(long long)b * lk + c0 + j] - 1.f) * kNeg : 0.f;
        madd[j] = a;
      }
      __syncthreads();
      for (int j0 = 0; j0 < np; j0 += kSub) {
        const float* krows = ks + j0 * DP + 4 * gl;
        const float* vrows = vs + j0 * DP + 4 * gl;
        softmax_step<F4, G>(
            qr, o, m, l,
            [&](int c, int i) { return *reinterpret_cast<const float4*>(krows + c * DP + 4 * G * i); },
            [&](int c, int i) { return *reinterpret_cast<const float4*>(vrows + c * DP + 4 * G * i); },
            [&](int c) { return madd[j0 + c]; });
      }
    }
  }

  if (!store) return;
  const long long rowid = ((long long)b * lq + row) * h + hd;
  float* orow = out + rowid * d;
  float f = 1.f / fmaxf(l, kMinSum);
  if (part != nullptr) {  // partial result of this split, not normalised
    const long long n_rows = (long long)gridDim.x * lq;
    orow = part + ((long long)blockIdx.z * n_rows + rowid) * d;
    f = 1.f;
    if (gl == 0) {
      float* ml = part + (long long)gridDim.z * n_rows * d + ((long long)blockIdx.z * n_rows + rowid) * 2;
      ml[0] = m;
      ml[1] = l;
    }
  }
#pragma unroll
  for (int i = 0; i < F4; ++i)
    store4(orow, 4 * (gl + G * i), d,
           make_float4(o[4 * i] * f, o[4 * i + 1] * f, o[4 * i + 2] * f, o[4 * i + 3] * f));
}

// One thread per output element: the splits' partial results into one.
__global__ void flash_merge_kernel(const float* __restrict__ part, float* __restrict__ out,
                                   long long n_rows, int d, int splits) {
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n_rows * d) return;
  const long long r = e / d;
  const float* ml = part + (long long)splits * n_rows * d;
  float mx = -CUDART_INF_F;
  for (int s = 0; s < splits; ++s) mx = fmaxf(mx, ml[(s * n_rows + r) * 2]);
  float l = 0.f, acc = 0.f;
  for (int s = 0; s < splits; ++s) {
    const float w = exp_neg(ml[(s * n_rows + r) * 2] - mx);
    l = fmaf(ml[(s * n_rows + r) * 2 + 1], w, l);
    acc = fmaf(part[s * n_rows * d + e], w, acc);
  }
  out[e] = acc / fmaxf(l, kMinSum);
}

template <int DP, int G, bool kDirect>
cudaError_t launch_flash(Heads q, Heads k, Heads v, const float* mask, float* out, float* part,
                         int b, int lq, int lk, int h, int d, int splits, cudaStream_t stream) {
  constexpr int KC = kTileFloats / DP;
  const size_t smem = kDirect ? 0 : sizeof(float) * ((size_t)2 * KC * DP + KC);
  cudaError_t err = allow_smem(flash_attention_kernel<DP, G, kDirect>, smem);
  if (err != cudaSuccess) return err;
  // tiles of equal size: 279 rows at 128 a block are 3 tiles of 93
  const int max_rows = kThreads / G;
  const int tiles = (lq + max_rows - 1) / max_rows;
  const int rows = (lq + tiles - 1) / tiles;
  const int threads = (rows * G + 31) / 32 * 32;
  // no split is empty: count them again from the keys each one takes
  const int keys_per_split = (lk + splits - 1) / splits;
  const int n_splits = (lk + keys_per_split - 1) / keys_per_split;
  if (tiles > 65535 || n_splits > 65535 || (n_splits > 1 && part == nullptr))
    return cudaErrorInvalidValue;
  const dim3 grid(b * h, tiles, n_splits);
  flash_attention_kernel<DP, G, kDirect><<<grid, threads, smem, stream>>>(
      q, k, v, mask, out, n_splits > 1 ? part : nullptr, lq, lk, h, d, rows, keys_per_split,
      1.f / sqrtf((float)d));
  err = cudaGetLastError();
  if (err != cudaSuccess || n_splits == 1) return err;
  const long long n_rows = (long long)b * lq * h;
  const int merge_threads = 256;
  const long long merge_blocks = (n_rows * d + merge_threads - 1) / merge_threads;
  if (merge_blocks > 2147483647LL) return cudaErrorInvalidValue;
  flash_merge_kernel<<<(unsigned)merge_blocks, merge_threads, 0, stream>>>(part, out, n_rows, d,
                                                                          n_splits);
  return cudaGetLastError();
}

// G lanes to a query row: few when there are rows enough to fill a block
// (16 floats of q and of the accumulator per lane), the whole head dim spread
// over the lanes, and no staging, when there are at most 4 query rows (a class
// token).
template <int DP, int G, int GW>
cudaError_t launch_flash_dp(Heads q, Heads k, Heads v, const float* mask, float* out,
                            float* part, int b, int lq, int lk, int h, int d, int splits,
                            cudaStream_t stream) {
  if (lq <= 4)
    return launch_flash<DP, GW, true>(q, k, v, mask, out, part, b, lq, lk, h, d, splits, stream);
  return launch_flash<DP, G, false>(q, k, v, mask, out, part, b, lq, lk, h, d, splits, stream);
}

}  // namespace

// Returns the launch's cudaError_t (0 on success). The Python wrapper
// (particle_fm_tpu_torch/ops/flash_attention.py) checked devices, types and
// shapes. `mask` (B, Lk) is contiguous or null; `out` is contiguous
// (B, Lq, H, D); `scratch` holds splits * B * Lq * H * (D + 2) floats, or is
// null when splits == 1.
extern "C" int flash_masked_attention_f32(
    const float* q, const float* k, const float* v, const float* mask, float* out,
    float* scratch, int b, int lq, int lk, int h, int d, int splits,
    long long q_bs, long long q_ld, long long k_bs, long long k_ld,
    long long v_bs, long long v_ld, void* stream_ptr) {
  if (b <= 0 || h <= 0 || lq <= 0 || lk <= 0 || d <= 0 || d > 128 || splits <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const Heads qh = heads(q, q_bs, q_ld, d), kh = heads(k, k_bs, k_ld, d),
              vh = heads(v, v_bs, v_ld, d);
  if (d <= 8)
    return (int)launch_flash_dp<8, 1, 2>(qh, kh, vh, mask, out, scratch, b, lq, lk, h, d, splits, stream);
  if (d <= 16)
    return (int)launch_flash_dp<16, 1, 4>(qh, kh, vh, mask, out, scratch, b, lq, lk, h, d, splits, stream);
  if (d <= 32)
    return (int)launch_flash_dp<32, 2, 8>(qh, kh, vh, mask, out, scratch, b, lq, lk, h, d, splits, stream);
  if (d <= 64)
    return (int)launch_flash_dp<64, 4, 16>(qh, kh, vh, mask, out, scratch, b, lq, lk, h, d, splits, stream);
  return (int)launch_flash_dp<128, 8, 32>(qh, kh, vh, mask, out, scratch, b, lq, lk, h, d, splits, stream);
}
