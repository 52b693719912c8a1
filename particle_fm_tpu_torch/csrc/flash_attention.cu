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
// and V are streamed through shared memory in tiles of about 16 KB each, and
// the tile loop is the softmax's chunk loop. Three variants, chosen by shape
// in the launcher:
//
// More than 4 query rows, head dim <= 64: the tensor cores. A block takes up
// to 128 query rows, a warp a tile of 16 of them, and runs the tile step of
// attention_mma.cuh over each staged tile of keys, 8 keys at a time: Q's
// fragments and the accumulator in registers, both products through mma.sync
// in split-precision TF32 (three TF32 products per float32 product), the
// softmax on the accumulator's registers. The query tiles of a set are of
// equal size (279 rows: 3 blocks of 6 warps), and rows past the set's end
// inside the last tile repeat the last row and are not stored.
//
// More than 4 query rows, head dim 128: the CUDA cores. Q's fragments, head
// and remainder, and the accumulator would take 192 registers a thread, so
// this shape (on no served path) keeps the lane-group design: 8 lanes own one
// query row and split the head dim, lane g keeps the float4s g, g+8, ... of
// the scaled q row and of the accumulator in registers, the partial dot
// products are summed over the group with shuffles, a lane takes 8 keys at a
// time.
//
// At most 4 query rows (a class token): nothing is shared between rows, so
// this variant does not stage. One warp owns the row (the whole head dim
// spread over its lanes), a lane loads its float4 of 8 K rows and 8 V rows
// straight from device memory, 16 loads in flight before the first is used
// (staged through shared memory by a single warp the loads go one after
// another, and the kernel takes 3.6 times as long at MDMA's shape).
//
// Two shapes are served, counted as chip_smoke.py counts them on an H100 SXM
// (3.35 TB/s; TF32 on the tensor cores 495 TFLOP/s dense; float32 on the CUDA
// cores 67 TFLOP/s). The PC-Droid transformer on 279-particle sets (B=256,
// Lq=Lk=279, H=16, D=16): 293 MB, 0.087 ms; the two products are
// 4*B*H*Lq*Lk*D = 20.4 GFLOP, issued three times in TF32, 0.124 ms, plus 5
// operations per score (1.6 GFLOP) on the CUDA cores, 0.024 ms: bound by
// tensor operations, 0.148 ms. MDMA's class token on calorimeter showers
// (B=32, Lq=1, Lk=6000, H=2, D=128) is bound by bytes (394 MB of K and V,
// 0.118 ms) and has only 64 (set, head) pairs for 132 SMs, so the keys are
// split over `splits` blocks per pair; each writes its partial (m, l, acc) to
// scratch memory and a second small kernel merges them:
//   M = max m_s,  o = sum acc_s e^(m_s - M) / max(sum l_s e^(m_s - M), 1e-30)
// The wrapper chooses `splits` (1: no scratch, no merge) and allocates the
// scratch; every variant takes a split.
//
// bfloat16 (`flash_masked_attention_bf16`): the Pallas kernel upcasts q, k and
// v and keeps P in float32 (flash_attention.py:31-54), so the bfloat16 kernel
// computes that function. At most 4 query rows: flash_token_bf16_kernel, at
// the end of this file with its own note. More than 4 rows at head dim 128
// run the staged CUDA-core variant on bfloat16 loads and float32 arithmetic.
// More than 4 query rows at head dims up to 64: flash_mma_bf16_kernel, whose
// served shape is path D (lhco/jets_transformer: B=256, Lq=Lk=279, 16 heads
// of 16, q, k and v slices of one (B, L, 768) projection, 30-279 real keys):
//   * One block per (set, head, split) takes all of the set's query tiles:
//     a warp per tile of 16 rows, 6 warps a block, the tiles in passes (279
//     rows: 3 passes). K and V of the head are staged once per block, by
//     cp.async in 16-byte pieces (a head is 32 bytes of a 1,536-byte row),
//     in tiles of fb_tile_keys keys: path D's whole head (288 keys at head
//     dim 16, 42.6 KB with the float32 V below) is one tile, staged before
//     the first pass, with no loop and no barrier between the steps. Longer
//     sets (the tests' 558 and 1,500 keys) stream their tiles through a ring
//     of two stages, the copies of tile i + 1 in flight while tile i is used.
//     Q's fragments of a warp's first tile are loaded before the mask is read,
//     and those of its next pass's tile while it computes this one.
//   * It stops at the set's last real key. The block reads its mask row once;
//     when a key has a mask of exactly 1, the keys after the last key with a
//     nonzero mask score about 1e9 below the running maximum, so exp gives
//     exactly 0 for them and the rescale exactly 1: they are neither staged
//     nor stepped over, and the output is the same bit for bit. Otherwise (a
//     set whose keys are all masked, masks with fractional values only) all
//     Lk keys count. Keys past the extent, rounded up to the step of 16,
//     take a mask of -inf.
//   * Q . K^T as bfloat16 products on mma.sync.m16n8k16 (exact: a bfloat16
//     product is exact in float32), the scale applied to S (at head dim 16 a
//     power of two: the Pallas kernel's scaled q agrees bit for bit). Steps of
//     32 keys up to head dim 32 (16 at 64): one update of the maxima and one
//     rescale of O per step.
//   * P . V with P in float32 as two TF32 products, P's head and remainder
//     (the dropped part, the remainder's last bits, is 2^-21 of P), on
//     m16n8k8; P goes from the accumulator's C layout to the A operand without
//     an exchange. V is staged once per block as float32 laid out as the B
//     fragments read it (exact: a bfloat16 has 8 bits of mantissa), so a step
//     reads one float4 per 16 columns and 8 keys and converts nothing. (P in
//     three exact bfloat16 pieces on m16n8k16, V read by ldmatrix.trans, was
//     the other choice: 5.5 operations a score to split P against 3, for a
//     quarter fewer tensor operations; it measured 6% slower.)
// Times, alternatives and knock-outs (scripts/attention_bf16_variants.py):
// PERF.md. 3 or 5 blocks an SM and steps of 16 keys measured slower than
// this; so did (design calls) two tiles of 16 rows a warp, and two or four
// heads a block with the next head's K and V copied while these were used.
// What bounds it at path D (H100 SXM): the bytes are 147 MB, 0.044 ms at
// 3.35 TB/s; over the keys the data needs (each set's extent) Q . K^T and
// P . V (twice in TF32) come to about 0.042 ms, and the exponentials, one an
// SFU operation (16 a clock an SM), to a floor of about 0.045 ms.

#include <type_traits>

#include "attention_mma.cuh"

namespace {

constexpr int kThreads = 128;       // most threads of a block of the CUDA-core variants
constexpr int kRowsPerBlock = 128;  // most query rows of a block of the tensor-core variant
constexpr int kSub = 8;             // keys whose scores a lane holds at a time
constexpr int kTileFloats = 4096;   // floats of K, and of V, staged at a time (16 KB each)
constexpr float kMinSum = 1e-30f;

// Keys of a staged tile of the tensor-core variant: about 16 KB of K, and of V
__host__ __device__ constexpr int flash_mma_tile_keys(int dp) {
  return dp <= 16 ? 256 : kTileFloats / dp;
}

__device__ __forceinline__ void put(float* p, float v) { *p = v; }

// The direct variant's loads (float32), kept as loaded until their step uses
// them, so that every load of a step is in flight before the first is used.
__device__ __forceinline__ float4 raw4_load(const float* row, int c, int d, bool vec) {
  return load4(row, c, d, vec);
}
__device__ __forceinline__ void put(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

// One step of the streaming softmax over 8 keys for one lane. `kload(c, i)`
// and `vload(c, i)` give the lane's i-th float4 of the step's c-th K and V
// row, `madd(c)` the key's additive mask (-inf past the range's end; the first
// key of a step is always inside it, so the step's maximum is finite).
template <int F4, int G, int KS = kSub, typename KLoad, typename VLoad, typename MAdd>
__device__ __forceinline__ void softmax_step(const float (&qr)[4 * F4], float (&o)[4 * F4],
                                             float& m, float& l, KLoad kload, VLoad vload,
                                             MAdd madd) {
  float s[KS];
  float cm = -CUDART_INF_F;
#pragma unroll
  for (int c = 0; c < KS; ++c) {
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
  for (int c = 0; c < KS; ++c) {
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
template <typename T, int DP, int G, bool kDirect>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(HeadsT<T> q, HeadsT<T> k, HeadsT<T> v, const float* __restrict__ mask,
                       T* __restrict__ out, float* __restrict__ part,
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
  const T* qrow = q.p + b * q.bs + row * q.ld + hd * d;
#pragma unroll
  for (int i = 0; i < F4; ++i) {
    const float4 val = load4(qrow, 4 * (gl + G * i), d, q.vec);
    qr[4 * i + 0] = val.x * scale; qr[4 * i + 1] = val.y * scale;
    qr[4 * i + 2] = val.z * scale; qr[4 * i + 3] = val.w * scale;
    o[4 * i + 0] = 0.f; o[4 * i + 1] = 0.f; o[4 * i + 2] = 0.f; o[4 * i + 3] = 0.f;
  }
  float m = -kNeg, l = 0.f;

  const T* kbase = k.p + b * k.bs + hd * d;
  const T* vbase = v.p + b * v.bs + hd * d;
  if constexpr (kDirect) {
    constexpr int KS = kSub;
    for (int j0 = kbeg; j0 < kend; j0 += KS) {
      float4 kk[KS][F4], vv[KS][F4];
      float a[KS];
#pragma unroll
      for (int c = 0; c < KS; ++c) {
        const int key = min(j0 + c, kend - 1);  // past the end: a row to read, no weight
#pragma unroll
        for (int i = 0; i < F4; ++i) {
          kk[c][i] = raw4_load(kbase + key * k.ld, 4 * (gl + G * i), d, k.vec);
          vv[c][i] = raw4_load(vbase + key * v.ld, 4 * (gl + G * i), d, v.vec);
        }
        a[c] = -CUDART_INF_F;
        if (j0 + c < kend) a[c] = mask ? (mask[(long long)b * lk + key] - 1.f) * kNeg : 0.f;
      }
      softmax_step<F4, G, KS>(
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
  if (part != nullptr) {  // partial result of this split, not normalised
    const long long n_rows = (long long)gridDim.x * lq;
    float* prow = part + ((long long)blockIdx.z * n_rows + rowid) * d;
    if (gl == 0) {
      float* ml = part + (long long)gridDim.z * n_rows * d + ((long long)blockIdx.z * n_rows + rowid) * 2;
      ml[0] = m;
      ml[1] = l;
    }
#pragma unroll
    for (int i = 0; i < F4; ++i)
      store4(prow, 4 * (gl + G * i), d,
             make_float4(o[4 * i], o[4 * i + 1], o[4 * i + 2], o[4 * i + 3]), d % 4 == 0);
    return;
  }
  T* orow = out + rowid * d;
  const float f = 1.f / fmaxf(l, kMinSum);
#pragma unroll
  for (int i = 0; i < F4; ++i)
    store4(orow, 4 * (gl + G * i), d,
           make_float4(o[4 * i] * f, o[4 * i + 1] * f, o[4 * i + 2] * f, o[4 * i + 3] * f),
           d % 4 == 0);
}

// The tensor-core variant. Grid as above; block: one warp per tile of 16
// query rows, `blockDim.x / 32` tiles to a block. A warp past the set's last
// row repeats that row and stores nothing, so every warp takes part in the
// barriers. The scale is applied to the accumulated score, not to q.
template <int DP>
__global__ void __launch_bounds__(32 * kRowsPerBlock / kMmaRows)
flash_mma_kernel(Heads q, Heads k, Heads v, const float* __restrict__ mask,
                 float* __restrict__ out, float* __restrict__ part,
                 int lq, int lk, int h, int d, int keys_per_split, float scale) {
  constexpr int ST = DP + 4, KC = flash_mma_tile_keys(DP);
  extern __shared__ float4 smem4[];
  float* ks = reinterpret_cast<float*>(smem4);
  float* vs = ks + KC * ST;
  float* madd = vs + KC * ST;

  const int b = blockIdx.x / h, hd = blockIdx.x % h;
  const int g = (threadIdx.x & 31) >> 2;
  const int row0 = (blockIdx.y * (blockDim.x >> 5) + (threadIdx.x >> 5)) * kMmaRows;
  const int kbeg = blockIdx.z * keys_per_split;
  const int kend = min(lk, kbeg + keys_per_split);

  MmaTile<DP> t;
  mma_tile_init(t, q.p + b * q.bs + hd * d, q.ld, row0, lq - 1, d, -kNeg);

  const float* kbase = k.p + b * k.bs + hd * d;
  const float* vbase = v.p + b * v.bs + hd * d;
  for (int c0 = kbeg; c0 < kend; c0 += KC) {
    const int n = min(KC, kend - c0);
    const int np = (n + kMmaKeys - 1) / kMmaKeys * kMmaKeys;  // <= KC, a multiple of 8
    __syncthreads();  // the previous tile has been used
    stage_head<DP>(ks, ST, kbase + c0 * k.ld, k.ld, n, np, d, k.vec);
    stage_head<DP>(vs, ST, vbase + c0 * v.ld, v.ld, n, np, d, v.vec);
    stage_mask(madd, mask ? mask + (long long)b * lk + c0 : nullptr, n, np);
    __syncthreads();
    mma_softmax_keys(t, ks, vs, madd, np, scale, NoBias{});
  }

  const long long n_rows = (long long)gridDim.x * lq;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const float sum = mma_row_sum(t, half);  // every lane shuffles
    const int row = row0 + 8 * half + g;
    if (row >= lq) continue;
    const long long rowid = ((long long)b * lq + row) * h + hd;
    if (part == nullptr) {
      mma_store_row(t, half, 1.f / fmaxf(sum, kMinSum), out + rowid * d, d);
    } else {  // partial result of this split, not normalised
      const long long slot = (long long)blockIdx.z * n_rows + rowid;
      mma_store_row(t, half, 1.f, part + slot * d, d);
      if ((threadIdx.x & 3) == 0) {
        float* ml = part + (long long)gridDim.z * n_rows * d + slot * 2;
        ml[0] = t.m[half];
        ml[1] = sum;
      }
    }
  }
}

// One thread per output element: the splits' partial results into one.
template <typename T>
__global__ void flash_merge_kernel(const float* __restrict__ part, T* __restrict__ out,
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
  put(out + e, acc / fmaxf(l, kMinSum));
}

// The merge of the splits' partial results, where the keys were split.
template <typename T>
cudaError_t launch_merge(cudaError_t err, const float* part, T* out, int b, int lq, int h,
                         int d, int n_splits, cudaStream_t stream) {
  if (err != cudaSuccess || n_splits == 1) return err;
  const long long n_rows = (long long)b * lq * h;
  const int merge_threads = 256;
  const long long merge_blocks = (n_rows * d + merge_threads - 1) / merge_threads;
  if (merge_blocks > 2147483647LL) return cudaErrorInvalidValue;
  flash_merge_kernel<T><<<(unsigned)merge_blocks, merge_threads, 0, stream>>>(part, out, n_rows,
                                                                             d, n_splits);
  return cudaGetLastError();
}

// No split is empty: they are counted again from the keys each one takes.
struct Splits {
  int keys_per_split, n;
};

Splits count_splits(int lk, int splits) {
  const int keys_per_split = (lk + splits - 1) / splits;
  return Splits{keys_per_split, (lk + keys_per_split - 1) / keys_per_split};
}

template <typename T, int DP, int G, bool kDirect>
cudaError_t launch_flash(HeadsT<T> q, HeadsT<T> k, HeadsT<T> v, const float* mask, T* out,
                         float* part, int b, int lq, int lk, int h, int d, int splits,
                         cudaStream_t stream) {
  constexpr int KC = kTileFloats / DP;
  const size_t smem = kDirect ? 0 : sizeof(float) * ((size_t)2 * KC * DP + KC);
  cudaError_t err = allow_smem(flash_attention_kernel<T, DP, G, kDirect>, smem);
  if (err != cudaSuccess) return err;
  // tiles of equal size
  const int max_rows = kThreads / G;
  const int tiles = (lq + max_rows - 1) / max_rows;
  const int rows = (lq + tiles - 1) / tiles;
  const int threads = (rows * G + 31) / 32 * 32;
  const Splits sp = count_splits(lk, splits);
  if (tiles > 65535 || sp.n > 65535 || (sp.n > 1 && part == nullptr))
    return cudaErrorInvalidValue;
  const dim3 grid(b * h, tiles, sp.n);
  flash_attention_kernel<T, DP, G, kDirect><<<grid, threads, smem, stream>>>(
      q, k, v, mask, out, sp.n > 1 ? part : nullptr, lq, lk, h, d, rows, sp.keys_per_split,
      1.f / sqrtf((float)d));
  return launch_merge(cudaGetLastError(), part, out, b, lq, h, d, sp.n, stream);
}

// With `report`, nothing is launched: the block's geometry goes there instead
// (mma_report).
template <int DP>
cudaError_t launch_flash_mma(Heads q, Heads k, Heads v, const float* mask, float* out,
                             float* part, int b, int lq, int lk, int h, int d, int splits,
                             cudaStream_t stream, int* report) {
  constexpr int KC = flash_mma_tile_keys(DP);
  const size_t smem = sizeof(float) * ((size_t)2 * KC * (DP + 4) + KC);
  // blocks of equal size: 279 rows are 18 tiles of 16, 3 blocks of 6 warps
  const int tiles = (lq + kMmaRows - 1) / kMmaRows;
  const int blocks = (tiles + kRowsPerBlock / kMmaRows - 1) / (kRowsPerBlock / kMmaRows);
  const int warps = (tiles + blocks - 1) / blocks;
  if (report) return mma_report(flash_mma_kernel<DP>, blocks, warps, KC, smem, report);
  cudaError_t err = allow_smem(flash_mma_kernel<DP>, smem);
  if (err != cudaSuccess) return err;
  const Splits sp = count_splits(lk, splits);
  if (blocks > 65535 || sp.n > 65535 || (sp.n > 1 && part == nullptr))
    return cudaErrorInvalidValue;
  const dim3 grid(b * h, blocks, sp.n);
  flash_mma_kernel<DP><<<grid, 32 * warps, smem, stream>>>(
      q, k, v, mask, out, sp.n > 1 ? part : nullptr, lq, lk, h, d, sp.keys_per_split,
      1.f / sqrtf((float)d));
  return launch_merge(cudaGetLastError(), part, out, b, lq, h, d, sp.n, stream);
}

// ---------------------------------------------------------------------------
// bfloat16, more than 4 query rows, head dims up to 64: flash_mma_bf16_kernel
// ---------------------------------------------------------------------------
//
// The design is in the note at the top of this file.

constexpr int kFbWarps = 6;         // most warps of a block, a tile of 16 query rows each
constexpr int kFbBlocksPerSm = 4;   // resident blocks an SM (launch bounds)
constexpr int kFbPvProducts = 2;    // TF32 products of P . V: P's head and remainder

// Keys of a staged tile: path D's 279 keys at head dim 16 fit one.
__host__ __device__ constexpr int fb_tile_keys(int dp) {
  return dp <= 16 ? 288 : dp <= 32 ? 256 : 128;
}
// Keys of a softmax step (they share one update of the maxima and one rescale)
__host__ __device__ constexpr int fb_step_keys(int dp) { return dp <= 32 ? 32 : 16; }

// Bytes of shared memory of a block: V as float32 in the B fragments' layout
// and the additive mask, once; then per stage K at a row stride of DP + 8 and
// V as copied, both bfloat16.
__host__ __device__ constexpr size_t fb_smem(int dp, int stages) {
  return 4 * ((size_t)fb_tile_keys(dp) * dp + fb_tile_keys(dp)) +
         2 * (size_t)stages * fb_tile_keys(dp) * (2 * dp + 8);
}

// One step of the streaming softmax over the NT staged tiles of 8 keys from
// key0 on, for a warp's 16 query rows (the step's first key is a key of the
// range, so its maximum is finite): S as bfloat16 products (mma_scores_bf16,
// 16 keys a call, scale and mask on the accumulator), one update of the rows'
// maxima and one rescale, p = exp(s - m) split into a TF32 head and remainder
// (split_tf32), and O += P . V as two TF32 products per tile of 8 keys. C's
// (row, key 2t | 2t+1) is A's (row, column t | t+4), so P goes from the
// accumulator to the A operand without an exchange; V's B fragments come
// from `vf`, one float4 per 16 columns.
template <int DP, int NT>
__device__ __forceinline__ void flash_bf16_step(MmaTileBf16<DP>& t, const bf16* ks,
                                                const float* vf, const float* madd, int key0,
                                                float scale) {
  const int lane = threadIdx.x & 31;
  float s[NT / 2][2][4];
#pragma unroll
  for (int i = 0; i < NT / 2; ++i)
    mma_scores_bf16(s[i], t, ks, madd, key0 + 16 * i, scale, NoBias{});
  float mx[2] = {-CUDART_INF_F, -CUDART_INF_F};
#pragma unroll
  for (int kt = 0; kt < NT; ++kt)
#pragma unroll
    for (int i = 0; i < 4; ++i) mx[i >> 1] = fmaxf(mx[i >> 1], s[kt >> 1][kt & 1][i]);
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
  const float4* vrow = reinterpret_cast<const float4*>(vf) + (key0 / 8) * (DP / 16) * 32 + lane;
#pragma unroll
  for (int kt = 0; kt < NT; ++kt) {
    uint32_t p_hi[4], p_lo[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float p = exp2_neg((s[kt >> 1][kt & 1][i] - t.m[i >> 1]) * kLog2e);
      t.l[i >> 1] += p;
      const int a = (i >> 1) + 2 * (i & 1);  // c0 c1 c2 c3 -> a0 a2 a1 a3
      const Tf32 x = split_tf32(p);
      p_hi[a] = x.hi;
      p_lo[a] = x.lo;
    }
#pragma unroll
    for (int c = 0; c < DP / 16; ++c) {
      const float4 w = vrow[(kt * (DP / 16) + c) * 32];
      const uint32_t b[4] = {__float_as_uint(w.x), __float_as_uint(w.y), __float_as_uint(w.z),
                             __float_as_uint(w.w)};
      mma_tf32(t.o[2 * c], p_lo, b[0], b[1]);
      mma_tf32(t.o[2 * c + 1], p_lo, b[2], b[3]);
      mma_tf32(t.o[2 * c], p_hi, b[0], b[1]);
      mma_tf32(t.o[2 * c + 1], p_hi, b[2], b[3]);
    }
  }
}

// Q's bfloat16 A fragments for rows row0 .. row0 + 15 of one head (rows past
// last_row repeat it; columns from d on are zero), in mma_bf16.cuh's A
// layout. `pairs`: two neighbouring values are one aligned 32-bit load,
// so the registers are loaded here and used only where the tile starts.
template <int DP>
__device__ __forceinline__ void load_q_bf16(uint32_t (&r)[DP / 16][4], const bf16* qhead,
                                            long long ld, int row0, int last_row, int d,
                                            bool pairs) {
  const int g = (threadIdx.x & 31) >> 2, tt = threadIdx.x & 3;
  const bf16 zero = __float2bfloat16_rn(0.f);
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const bf16* qrow = qhead + min(row0 + 8 * half + g, last_row) * ld;
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int col = 16 * kk + 8 * c + 2 * tt;
        r[kk][half + 2 * c] =
            pairs ? (col < d ? *reinterpret_cast<const uint32_t*>(qrow + col) : 0u)
                  : pack_raw_bf16(col < d ? qrow[col] : zero, col + 1 < d ? qrow[col + 1] : zero);
      }
  }
}

// The staged keys 0 .. n_p - 1 (n_p a multiple of 16): steps of
// fb_step_keys, then one of 16.
template <int DP>
__device__ __forceinline__ void flash_bf16_keys(MmaTileBf16<DP>& t, const bf16* ks,
                                                const float* vf, const float* madd, int n_p,
                                                float scale) {
  constexpr int KS = fb_step_keys(DP);
  int key0 = 0;
  for (; key0 + KS <= n_p; key0 += KS) flash_bf16_step<DP, KS / 8>(t, ks, vf, madd, key0, scale);
  if constexpr (KS > kBfKeys) {
    if (key0 < n_p) flash_bf16_step<DP, kBfKeys / 8>(t, ks, vf, madd, key0, scale);
  }
}

// Grid: x = (set, head), z = split of the keys; block: one warp per tile of
// 16 query rows, the block's warps taking the set's tiles in passes (a warp
// past the last tile idles in the last pass; rows past the set's end inside
// its last tile repeat the last row and are not stored). `part` as
// flash_mma_kernel's. `stages`: 1 when a split's keys fit one staged tile,
// else 2 (a ring). `wide`: K and V rows may be copied in 16-byte pieces.
template <int DP>
__global__ void __launch_bounds__(32 * kFbWarps, kFbBlocksPerSm)
flash_mma_bf16_kernel(HeadsT<bf16> q, HeadsT<bf16> k, HeadsT<bf16> v,
                      const float* __restrict__ mask, bf16* __restrict__ out,
                      float* __restrict__ part, int lq, int lk, int h, int d, int keys_per_split,
                      int stages, float scale, bool wide) {
  constexpr int ST = DP + 8, KC = fb_tile_keys(DP), Q8 = DP / 8;
  static_assert(KC % fb_step_keys(DP) == 0, "a staged tile is a whole number of steps");
  extern __shared__ float4 smem4[];
  float* vf = reinterpret_cast<float*>(smem4);
  float* madd = vf + KC * DP;
  bf16* ks0 = reinterpret_cast<bf16*>(madd + KC);
  bf16* vr0 = ks0 + stages * KC * ST;
  __shared__ int sm_last;

  const int b = blockIdx.x / h, hd = blockIdx.x % h;
  const int tid = threadIdx.x, nthreads = blockDim.x, warp = tid >> 5;
  const float* mrow = mask ? mask + (long long)b * lk : nullptr;
  // Q of the warp's first tile, in flight while the mask is read and K and V staged
  const bf16* qhead = q.p + b * q.bs + hd * d;
  const bool qpairs = d % 2 == 0 && ((reinterpret_cast<uintptr_t>(q.p) |
                                      static_cast<uintptr_t>((q.ld | q.bs) * 2)) & 3) == 0;
  uint32_t qn[DP / 16][4];
  load_q_bf16<DP>(qn, qhead, q.ld, min(warp * kMmaRows, lq - 1), lq - 1, d, qpairs);

  const int kbeg = blockIdx.z * keys_per_split;
  const int kend = min(min(lk, kbeg + keys_per_split), real_key_extent(mrow, lk, &sm_last));
  const int tiles = kend > kbeg ? (kend - kbeg + KC - 1) / KC : 0;  // 0: nothing to add
  const bf16* kbase = k.p + b * k.bs + hd * d;
  const bf16* vbase = v.p + b * v.bs + hd * d;
  auto keys_of = [&](int i) { return min(KC, kend - kbeg - i * KC); };
  auto padded = [](int n) { return (n + kBfKeys - 1) / kBfKeys * kBfKeys; };

  // Tile i of the split's keys into stage `slot`: K and V as they lie, rows
  // past the keys and columns past d zero.
  auto stage = [&](int i, int slot) {
    const int c0 = kbeg + i * KC, n = keys_of(i), np = padded(n);
    bf16* ks = ks0 + slot * KC * ST;
    bf16* vr = vr0 + slot * KC * DP;
    if (wide) {
      for (int e = tid; e < np * Q8; e += nthreads) {
        const int r = e / Q8, c = (e % Q8) * 8;
        const bool in = r < n && c < d;
        cp_async16(ks + r * ST + c, kbase + (in ? (c0 + r) * k.ld + c : 0), in);
        cp_async16(vr + r * DP + c, vbase + (in ? (c0 + r) * v.ld + c : 0), in);
      }
      cp_async_commit();
    } else {
      const bf16 zero = __float2bfloat16_rn(0.f);
      for (int e = tid; e < np * DP; e += nthreads) {
        const int r = e / DP, c = e % DP;
        const bool in = r < n && c < d;
        ks[r * ST + c] = in ? kbase[(c0 + r) * k.ld + c] : zero;
        vr[r * DP + c] = in ? vbase[(c0 + r) * v.ld + c] : zero;
      }
    }
  };
  // V of tile i (in stage `slot`) into `vf` as float32 in the B fragments'
  // layout: the float4 (tile of 8 keys j, 16 columns c, lane 4g + t) holds V
  // at (8j + 2t, 16c + g), (8j + 2t + 1, 16c + g), (8j + 2t, 16c + 8 + g),
  // (8j + 2t + 1, 16c + 8 + g); and the tile's additive mask into `madd`.
  auto convert = [&](int i, int slot) {
    const int c0 = kbeg + i * KC, n = keys_of(i), np = padded(n);
    const bf16* vr = vr0 + slot * KC * DP;
    for (int e = tid; e < np * Q8; e += nthreads) {
      const int r = e / Q8, nn = e % Q8;  // key r, columns 8 nn .. 8 nn + 7
      float f[8];
      unpack8(*reinterpret_cast<const uint4*>(vr + r * DP + 8 * nn), f);
      float* dst = vf + (((r >> 3) * (DP / 16) + (nn >> 1)) * 32 + ((r & 7) >> 1)) * 4 +
                   2 * (nn & 1) + (r & 1);
#pragma unroll
      for (int g = 0; g < 8; ++g) dst[16 * g] = f[g];
    }
    stage_mask(madd, mrow ? mrow + c0 : nullptr, n, np);
  };

  if (tiles == 1) {  // staged once for every pass
    stage(0, 0);
    cp_async_wait_all();
    __syncthreads();
    convert(0, 0);
    __syncthreads();
  }
  const int g = (tid & 31) >> 2;
  const long long n_rows = (long long)gridDim.x * lq;
  for (int row0 = warp * kMmaRows; row0 - warp * kMmaRows < lq; row0 += nthreads / 2) {
    const bool active = row0 < lq;  // warp-uniform
    MmaTileBf16<DP> t;
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk)
#pragma unroll
      for (int i = 0; i < 4; ++i) t.q[kk][i] = qn[kk][i];
#pragma unroll
    for (int n = 0; n < DP / 8; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) t.o[n][i] = 0.f;
    t.m[0] = t.m[1] = -kNeg;
    t.l[0] = t.l[1] = 0.f;
    const int next = row0 + nthreads / 2;  // the next pass's Q, in flight during this one
    if (next - warp * kMmaRows < lq)
      load_q_bf16<DP>(qn, qhead, q.ld, min(next, lq - 1), lq - 1, d, qpairs);
    if (tiles == 1) {
      if (active) flash_bf16_keys(t, ks0, vf, madd, padded(keys_of(0)), scale);
    } else if (tiles > 1) {  // the ring: tile i + 1 is copied while tile i is used
      stage(0, 0);
      for (int i = 0; i < tiles; ++i) {
        cp_async_wait_all();
        __syncthreads();  // tile i is in; every warp is done with tile i - 1
        if (i + 1 < tiles) stage(i + 1, (i + 1) & 1);
        convert(i, i & 1);
        __syncthreads();
        if (active)
          flash_bf16_keys(t, ks0 + (i & 1) * KC * ST, vf, madd, padded(keys_of(i)), scale);
      }
      __syncthreads();  // the next pass stages into slot 0
    }
    if (!active) continue;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      float sum = t.l[half];  // over the four lanes that share the row; every lane shuffles
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      const int row = row0 + 8 * half + g;
      if (row >= lq) continue;
      const long long rowid = ((long long)b * lq + row) * h + hd;
      if (part == nullptr) {
        mma_store_row_bf16(t, half, 1.f / fmaxf(sum, kMinSum), out + rowid * d, d);
      } else {  // partial result of this split, not normalised
        const long long slot = (long long)blockIdx.z * n_rows + rowid;
        mma_store_row_bf16(t, half, 1.f, part + slot * d, d);
        if ((tid & 3) == 0) {
          float* ml = part + (long long)gridDim.z * n_rows * d + slot * 2;
          ml[0] = t.m[half];
          ml[1] = sum;
        }
      }
    }
  }
}

// With `report` (8 ints), nothing is launched: blocks, warps of a block,
// passes (the query tiles each warp takes in turn), keys of a staged tile,
// stages, bytes of shared memory, registers per thread, TF32 products of
// P . V.
template <int DP>
cudaError_t launch_flash_mma_bf16(HeadsT<bf16> q, HeadsT<bf16> k, HeadsT<bf16> v,
                                  const float* mask, bf16* out, float* part, int b, int lq, int lk,
                                  int h, int d, int splits, cudaStream_t stream, int* report) {
  constexpr int KC = fb_tile_keys(DP);
  const Splits sp = count_splits(lk, splits);
  const int stages = sp.keys_per_split <= KC ? 1 : 2;
  const size_t smem = fb_smem(DP, stages);
  const int row_tiles = (lq + kMmaRows - 1) / kMmaRows;
  const int passes = (row_tiles + kFbWarps - 1) / kFbWarps;
  const int warps = (row_tiles + passes - 1) / passes;
  if (report) {
    cudaFuncAttributes attr;
    const cudaError_t err = cudaFuncGetAttributes(&attr, flash_mma_bf16_kernel<DP>);
    if (err != cudaSuccess) return err;
    const int r[8] = {b * h * sp.n, warps, passes, KC, stages, (int)smem, attr.numRegs,
                      kFbPvProducts};
    for (int i = 0; i < 8; ++i) report[i] = r[i];
    return cudaSuccess;
  }
  cudaError_t err = allow_smem(flash_mma_bf16_kernel<DP>, smem);
  if (err != cudaSuccess) return err;
  if (sp.n > 65535 || (sp.n > 1 && part == nullptr)) return cudaErrorInvalidValue;
  const bool wide = d % 8 == 0 && k.bs % 8 == 0 && k.ld % 8 == 0 && v.bs % 8 == 0 &&
                    v.ld % 8 == 0 && reinterpret_cast<uintptr_t>(k.p) % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(v.p) % 16 == 0;
  const dim3 grid(b * h, 1, sp.n);
  flash_mma_bf16_kernel<DP><<<grid, 32 * warps, smem, stream>>>(
      q, k, v, mask, out, sp.n > 1 ? part : nullptr, lq, lk, h, d, sp.keys_per_split, stages,
      1.f / sqrtf((float)d), wide);
  return launch_merge(cudaGetLastError(), part, out, b, lq, h, d, sp.n, stream);
}

// The tensor-core variant of each type: TF32 in float32, bfloat16 products in
// bfloat16 (head dims up to 16 padded to 16).
template <int DP>
cudaError_t launch_flash_mma_t(Heads q, Heads k, Heads v, const float* mask, float* out,
                               float* part, int b, int lq, int lk, int h, int d, int splits,
                               cudaStream_t stream, int* report) {
  return launch_flash_mma<DP>(q, k, v, mask, out, part, b, lq, lk, h, d, splits, stream, report);
}

template <int DP>
cudaError_t launch_flash_mma_t(HeadsT<bf16> q, HeadsT<bf16> k, HeadsT<bf16> v, const float* mask,
                               bf16* out, float* part, int b, int lq, int lk, int h, int d,
                               int splits, cudaStream_t stream, int* report) {
  return launch_flash_mma_bf16<bf16_head_dim(DP)>(q, k, v, mask, out, part, b, lq, lk, h, d,
                                                   splits, stream, report);
}

// The variant by shape: at most 4 query rows (a class token) read K and V
// directly, the whole head dim spread over GW lanes; more rows go to the
// tensor cores up to head dim 64, and at head dim 128 to 8 lanes a row (16
// floats of q and of the accumulator per lane). `report` is for the
// tensor-core variants only.
template <typename T, int DP, int GW>
cudaError_t launch_flash_dp(HeadsT<T> q, HeadsT<T> k, HeadsT<T> v, const float* mask, T* out,
                            float* part, int b, int lq, int lk, int h, int d, int splits,
                            cudaStream_t stream, int* report) {
  if (report && (lq <= 4 || DP > 64)) return cudaErrorInvalidValue;
  if (lq <= 4) {  // bfloat16 class tokens take flash_token_bf16_kernel (below)
    if constexpr (std::is_same<T, float>::value)
      return launch_flash<T, DP, GW, true>(q, k, v, mask, out, part, b, lq, lk, h, d, splits,
                                           stream);
    else
      return cudaErrorInvalidValue;
  }
  if constexpr (DP <= 64)
    return launch_flash_mma_t<DP>(q, k, v, mask, out, part, b, lq, lk, h, d, splits, stream,
                                  report);
  else
    return launch_flash<T, DP, 8, false>(q, k, v, mask, out, part, b, lq, lk, h, d, splits,
                                         stream);
}

template <typename T>
cudaError_t launch_flash_d(HeadsT<T> q, HeadsT<T> k, HeadsT<T> v, const float* mask, T* out,
                           float* part, int b, int lq, int lk, int h, int d, int splits,
                           cudaStream_t stream, int* report) {
  if (b <= 0 || h <= 0 || lq <= 0 || lk <= 0 || d <= 0 || d > 128 || splits <= 0)
    return cudaErrorInvalidValue;
  if (d <= 8)
    return launch_flash_dp<T, 8, 2>(q, k, v, mask, out, part, b, lq, lk, h, d, splits, stream,
                                    report);
  if (d <= 16)
    return launch_flash_dp<T, 16, 4>(q, k, v, mask, out, part, b, lq, lk, h, d, splits, stream,
                                     report);
  if (d <= 32)
    return launch_flash_dp<T, 32, 8>(q, k, v, mask, out, part, b, lq, lk, h, d, splits, stream,
                                     report);
  if (d <= 64)
    return launch_flash_dp<T, 64, 16>(q, k, v, mask, out, part, b, lq, lk, h, d, splits, stream,
                                      report);
  return launch_flash_dp<T, 128, 32>(q, k, v, mask, out, part, b, lq, lk, h, d, splits, stream,
                                     report);
}

// ---------------------------------------------------------------------------
// bfloat16 class tokens: flash_token_bf16_kernel
// ---------------------------------------------------------------------------
//
// At most 4 query rows in bfloat16 (MDMA's class token: path C, B=32, Lq=1,
// Lk=6000, 2 heads of 128). The work is reading K and V once (197 MB at
// path C, 0.059 ms at 3.35 TB/s): bound by bytes, so the design keeps enough
// bytes in flight on every SM and does the rest in the same launch.
//   * A lane reads 16 bytes (8 values) of a K row and of a V row at a time;
//     a group of G = DP / 8 lanes covers a key's head dim (a half-warp at
//     head dim 128), so a warp load reads 32 / G keys. Each lane loads its
//     K and V pieces of 8 keys (at one query row; 8 / Lq at more) before
//     the first is used: 16 warps an SM keep 128 KB in flight. (Eight warps
//     a block, two blocks an SM, measured 2% faster than four and four and
//     than three blocks of 12 keys in flight: PERF.md.)
//   * Each lane group is a softmax stream of its own over the keys it
//     reads (running maximum from -1e9, running sum, accumulator of its 8
//     columns, q scaled first: the Pallas kernel's float32 arithmetic on the
//     upcast values); the groups of a warp, then the warps of the block, are
//     merged as the splits are: M = max m_i, l = sum l_i e^(m_i - M), acc =
//     sum acc_i e^(m_i - M).
//   * The keys of a (set, head) are cut into `splits` equal ranges, one per
//     block, so that the blocks fill the SMs' resident slots in whole waves
//     (ops/flash_attention.py::token_splits). A block writes its partial
//     (m, l, acc) to scratch, then takes a ticket from the (set, head)'s
//     counter after a __threadfence; the block that takes the last ticket
//     merges the splits, writes the output and sets the counter back to 0
//     for the next launch. One launch: no second merge kernel.
// Operands offset from 16 bytes, strides that are not multiples of 8
// elements, or head dims not a multiple of 8 take element loads (`wide`
// false) in the same layout.

constexpr int kTokWarps = 8;                 // warps of a block
constexpr int kTokThreads = 32 * kTokWarps;
constexpr int kTokBlocksPerSm = 2;           // resident blocks an SM (launch bounds)
constexpr int kTokMaxRows = 4;               // query rows (DIRECT_MAX_ROWS)
// keys a lane group loads before using them, for LQ query rows: 8 at one row
__host__ __device__ constexpr int tok_unroll(int lq) { return 8 / lq; }

// Grid: x = (set, head), y = split of the keys. `part` (splits, B, Lq, H, D)
// accumulators then (splits, B, Lq, H, 2) pairs (m, l), and `counters` (B H
// ints, zero), are used when splits > 1. LQ: 1, 2 or 4, at least lq.
template <int DP, int LQ>
__global__ void __launch_bounds__(kTokThreads, kTokBlocksPerSm)
flash_token_bf16_kernel(HeadsT<bf16> q, HeadsT<bf16> k, HeadsT<bf16> v,
                        const float* __restrict__ mask, bf16* __restrict__ out,
                        float* __restrict__ part, int* __restrict__ counters, int lq, int lk,
                        int h, int d, int keys_per_split, float scale, bool wide) {
  constexpr int G = DP / 8;   // lanes of a key
  constexpr int KW = 32 / G;  // keys of a warp load
  constexpr int kTokUnroll = tok_unroll(LQ);
  constexpr int KS = KW * kTokUnroll;
  __shared__ float sm_o[kTokWarps][LQ][DP];
  __shared__ float sm_ml[kTokWarps][LQ][2];
  __shared__ int sm_last;

  const int pair = blockIdx.x, b = pair / h, hd = pair % h;
  const int split = blockIdx.y, splits = gridDim.y;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int grp = lane / G, c = 8 * (lane % G);
  const int kbeg = split * keys_per_split;
  const int kend = min(lk, kbeg + keys_per_split);
  const int per_warp = (kend - kbeg + kTokWarps - 1) / kTokWarps;
  const int wbeg = kbeg + warp * per_warp, wend = min(kend, wbeg + per_warp);

  float qr[LQ][8], o[LQ][8], m[LQ], l[LQ];
#pragma unroll
  for (int r = 0; r < LQ; ++r) {
    float f[8];
    unpack8(load8_raw(q.p + b * q.bs + min(r, lq - 1) * q.ld + hd * d, c, d, wide), f);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      qr[r][i] = f[i] * scale;
      o[r][i] = 0.f;
    }
    m[r] = -kNeg;
    l[r] = 0.f;
  }

  const bf16* kb = k.p + b * k.bs + hd * d;
  const bf16* vb = v.p + b * v.bs + hd * d;
  for (int j0 = wbeg; j0 < wend; j0 += KS) {
    uint4 kk[kTokUnroll], vv[kTokUnroll];
    float a[kTokUnroll];
#pragma unroll
    for (int u = 0; u < kTokUnroll; ++u) {
      const int key = j0 + u * KW + grp;
      const int kc = min(key, wend - 1);  // past the range: a row to read, no weight
      kk[u] = load8_raw(kb + kc * k.ld, c, d, wide);
      vv[u] = load8_raw(vb + kc * v.ld, c, d, wide);
      a[u] = key < wend ? (mask ? (mask[(long long)b * lk + kc] - 1.f) * kNeg : 0.f)
                        : -CUDART_INF_F;
    }
#pragma unroll
    for (int r = 0; r < LQ; ++r) {
      if (r >= lq) break;
      float s[kTokUnroll];
      float cm = -CUDART_INF_F;
#pragma unroll
      for (int u = 0; u < kTokUnroll; ++u) {
        float kf[8];
        unpack8(kk[u], kf);
        float dot = 0.f;
#pragma unroll
        for (int i = 0; i < 8; ++i) dot = fmaf(qr[r][i], kf[i], dot);
#pragma unroll
        for (int off = G / 2; off > 0; off >>= 1) dot += __shfl_xor_sync(0xffffffffu, dot, off);
        s[u] = dot + a[u];
        cm = fmaxf(cm, s[u]);
      }
      const float mn = fmaxf(m[r], cm);
      const float corr = exp_neg(m[r] - mn);
      l[r] *= corr;
#pragma unroll
      for (int i = 0; i < 8; ++i) o[r][i] *= corr;
#pragma unroll
      for (int u = 0; u < kTokUnroll; ++u) {
        const float p = exp_neg(s[u] - mn);
        float vf[8];
        unpack8(vv[u], vf);
        l[r] += p;
#pragma unroll
        for (int i = 0; i < 8; ++i) o[r][i] = fmaf(p, vf[i], o[r][i]);
      }
      m[r] = mn;
    }
  }

  // the warp's streams into one: lanes that share a column range, across groups
#pragma unroll
  for (int r = 0; r < LQ; ++r) {
#pragma unroll
    for (int off = G; off < 32; off <<= 1) {
      float o2[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) o2[i] = __shfl_xor_sync(0xffffffffu, o[r][i], off);
      const float m2 = __shfl_xor_sync(0xffffffffu, m[r], off);
      const float l2 = __shfl_xor_sync(0xffffffffu, l[r], off);
      merge_stream(m[r], l[r], o[r], m2, l2, o2);
    }
    if (lane < G) {
#pragma unroll
      for (int i = 0; i < 8; ++i) sm_o[warp][r][c + i] = o[r][i];
      if (lane == 0) {
        sm_ml[warp][r][0] = m[r];
        sm_ml[warp][r][1] = l[r];
      }
    }
  }
  __syncthreads();

  // the block's warps into one, a thread per (row, column)
  const long long n_rows = (long long)gridDim.x * lq;  // (set, row, head) triples
  for (int e = threadIdx.x; e < lq * d; e += kTokThreads) {
    const int r = e / d, col = e % d;
    float mx = -CUDART_INF_F;
#pragma unroll
    for (int w = 0; w < kTokWarps; ++w) mx = fmaxf(mx, sm_ml[w][r][0]);
    float acc = 0.f, sum = 0.f;
#pragma unroll
    for (int w = 0; w < kTokWarps; ++w) {
      const float wt = exp_neg(sm_ml[w][r][0] - mx);
      sum = fmaf(sm_ml[w][r][1], wt, sum);
      acc = fmaf(sm_o[w][r][col], wt, acc);
    }
    const long long rowid = ((long long)b * lq + r) * h + hd;
    if (splits == 1) {
      out[rowid * d + col] = __float2bfloat16_rn(acc / fmaxf(sum, kMinSum));
    } else {
      const long long slot = (long long)split * n_rows + rowid;
      part[slot * d + col] = acc;
      if (col == 0) {
        float* ml = part + (long long)splits * n_rows * d + slot * 2;
        ml[0] = mx;
        ml[1] = sum;
      }
    }
  }
  if (splits == 1) return;

  // the last block of the (set, head) to finish merges the splits
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) sm_last = atomicAdd(counters + pair, 1) == splits - 1;
  __syncthreads();
  if (!sm_last) return;
  __threadfence();
  const float* ml = part + (long long)splits * n_rows * d;
  for (int e = threadIdx.x; e < lq * d; e += kTokThreads) {
    const int r = e / d, col = e % d;
    const long long rowid = ((long long)b * lq + r) * h + hd;
    float mx = -CUDART_INF_F;
    for (int s = 0; s < splits; ++s) mx = fmaxf(mx, __ldcg(ml + (s * n_rows + rowid) * 2));
    float acc = 0.f, sum = 0.f;
    for (int s = 0; s < splits; ++s) {
      const float wt = exp_neg(__ldcg(ml + (s * n_rows + rowid) * 2) - mx);
      sum = fmaf(__ldcg(ml + (s * n_rows + rowid) * 2 + 1), wt, sum);
      acc = fmaf(__ldcg(part + (s * n_rows + rowid) * d + col), wt, acc);
    }
    out[rowid * d + col] = __float2bfloat16_rn(acc / fmaxf(sum, kMinSum));
  }
  if (threadIdx.x == 0) counters[pair] = 0;  // ready for the next launch
}

// `report` (4 ints): blocks of the grid, warps of a block, resident blocks an
// SM at these launch bounds, registers per thread. Launches nothing then.
template <int DP, int LQ>
cudaError_t launch_token_bf16_lq(HeadsT<bf16> q, HeadsT<bf16> k, HeadsT<bf16> v,
                                 const float* mask, bf16* out, float* part, int* counters, int b,
                                 int lq, int lk, int h, int d, int splits, cudaStream_t stream,
                                 int* report) {
  const Splits sp = count_splits(lk, splits);
  if (sp.n > 65535) return cudaErrorInvalidValue;
  const dim3 grid(b * h, sp.n);
  if (report) {
    cudaFuncAttributes attr;
    cudaError_t err = cudaFuncGetAttributes(&attr, flash_token_bf16_kernel<DP, LQ>);
    if (err != cudaSuccess) return err;
    int resident = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&resident,
                                                        flash_token_bf16_kernel<DP, LQ>,
                                                        kTokThreads, 0);
    if (err != cudaSuccess) return err;
    report[0] = (int)(grid.x * grid.y);
    report[1] = kTokWarps;
    report[2] = resident;
    report[3] = attr.numRegs;
    return cudaSuccess;
  }
  if (sp.n > 1 && (part == nullptr || counters == nullptr)) return cudaErrorInvalidValue;
  // 16-byte loads where every row starts on 16 bytes
  const bool wide = d % 8 == 0 && q.bs % 8 == 0 && q.ld % 8 == 0 && k.bs % 8 == 0 &&
                    k.ld % 8 == 0 && v.bs % 8 == 0 && v.ld % 8 == 0 &&
                    reinterpret_cast<uintptr_t>(q.p) % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(k.p) % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(v.p) % 16 == 0;
  flash_token_bf16_kernel<DP, LQ><<<grid, kTokThreads, 0, stream>>>(
      q, k, v, mask, out, sp.n > 1 ? part : nullptr, counters, lq, lk, h, d, sp.keys_per_split,
      1.f / sqrtf((float)d), wide);
  return cudaGetLastError();
}

template <int DP>
cudaError_t launch_token_bf16_dp(HeadsT<bf16> q, HeadsT<bf16> k, HeadsT<bf16> v,
                                 const float* mask, bf16* out, float* part, int* counters, int b,
                                 int lq, int lk, int h, int d, int splits, cudaStream_t stream,
                                 int* report) {
  if (lq == 1)
    return launch_token_bf16_lq<DP, 1>(q, k, v, mask, out, part, counters, b, lq, lk, h, d,
                                       splits, stream, report);
  if (lq == 2)
    return launch_token_bf16_lq<DP, 2>(q, k, v, mask, out, part, counters, b, lq, lk, h, d,
                                       splits, stream, report);
  return launch_token_bf16_lq<DP, 4>(q, k, v, mask, out, part, counters, b, lq, lk, h, d, splits,
                                     stream, report);
}

cudaError_t launch_token_bf16(HeadsT<bf16> q, HeadsT<bf16> k, HeadsT<bf16> v, const float* mask,
                              bf16* out, float* part, int* counters, int b, int lq, int lk, int h,
                              int d, int splits, cudaStream_t stream, int* report) {
  if (b <= 0 || h <= 0 || lq <= 0 || lq > kTokMaxRows || lk <= 0 || d <= 0 || d > 128 ||
      splits <= 0)
    return cudaErrorInvalidValue;
  if (d <= 8)
    return launch_token_bf16_dp<8>(q, k, v, mask, out, part, counters, b, lq, lk, h, d, splits,
                                   stream, report);
  if (d <= 16)
    return launch_token_bf16_dp<16>(q, k, v, mask, out, part, counters, b, lq, lk, h, d, splits,
                                    stream, report);
  if (d <= 32)
    return launch_token_bf16_dp<32>(q, k, v, mask, out, part, counters, b, lq, lk, h, d, splits,
                                    stream, report);
  if (d <= 64)
    return launch_token_bf16_dp<64>(q, k, v, mask, out, part, counters, b, lq, lk, h, d, splits,
                                    stream, report);
  return launch_token_bf16_dp<128>(q, k, v, mask, out, part, counters, b, lq, lk, h, d, splits,
                                   stream, report);
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
  return (int)launch_flash_d(heads(q, q_bs, q_ld, d), heads(k, k_bs, k_ld, d),
                             heads(v, v_bs, v_ld, d), mask, out, scratch, b, lq, lk, h, d, splits,
                             static_cast<cudaStream_t>(stream_ptr), nullptr);
}

// What the launcher gives a block of the tensor-core variant for `lq` query
// rows (more than 4) at head dim `d` (at most 64), into `report`: blocks per
// (set, head, split), warps, keys of a staged tile, bytes of shared memory,
// registers per thread, TF32 products per float32 product. Launches nothing.
extern "C" int flash_masked_attention_geometry(int lq, int d, int* report) {
  const Heads none{};
  return (int)launch_flash_d<float>(none, none, none, nullptr, nullptr, nullptr, 1, lq, 1, 1, d, 1,
                             nullptr, report);
}

extern "C" const char* attention_mma_instruction() { return MMA_TF32_INSTRUCTION; }

// What the launcher gives the bfloat16 tensor-core variant (more than 4 query
// rows, head dims up to 64) for these shapes and `splits`, into `report` (8
// ints, as launch_flash_mma_bf16 lists them). Launches nothing.
extern "C" int flash_mma_bf16_geometry(int b, int lq, int lk, int h, int d, int splits,
                                       int* report) {
  const HeadsT<bf16> none{};
  return (int)launch_flash_d<bf16>(none, none, none, nullptr, nullptr, nullptr, b, lq, lk, h, d,
                                   splits, nullptr, report);
}

// The bfloat16 kernel: q, k, v and the output in bfloat16, the mask and the
// scratch in float32; arguments as flash_masked_attention_f32's, and
// `counters` (B * H ints, zero, left zero) when splits > 1. At most 4 query
// rows (class tokens) go to flash_token_bf16_kernel; more, at head dims up to
// 64, to the bfloat16 tensor-core variant; the rest run the float32
// arithmetic of the staged CUDA-core variant on bfloat16 loads and stores,
// which is what the Pallas kernel computes (it upcasts q, k and v).
extern "C" int flash_masked_attention_bf16(
    const bf16* q, const bf16* k, const bf16* v, const float* mask, bf16* out,
    float* scratch, int* counters, int b, int lq, int lk, int h, int d, int splits,
    long long q_bs, long long q_ld, long long k_bs, long long k_ld,
    long long v_bs, long long v_ld, void* stream_ptr) {
  const HeadsT<bf16> hq = heads(q, q_bs, q_ld, d), hk = heads(k, k_bs, k_ld, d),
                     hv = heads(v, v_bs, v_ld, d);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (lq <= kTokMaxRows)
    return (int)launch_token_bf16(hq, hk, hv, mask, out, scratch, counters, b, lq, lk, h, d,
                                  splits, stream, nullptr);
  return (int)launch_flash_d(hq, hk, hv, mask, out, scratch, b, lq, lk, h, d, splits, stream,
                             nullptr);
}

// What the launcher gives flash_token_bf16_kernel for these shapes, into
// `report` (4 ints: blocks, warps of a block, resident blocks an SM,
// registers per thread). Launches nothing.
extern "C" int flash_token_bf16_geometry(int b, int lq, int lk, int h, int d, int splits,
                                         int* report) {
  const HeadsT<bf16> none{};
  return (int)launch_token_bf16(none, none, none, nullptr, nullptr, nullptr, nullptr, b, lq, lk,
                                h, d, splits, nullptr, report);
}

extern "C" const char* attention_mma_bf16_instruction() { return MMA_BF16_INSTRUCTION; }
