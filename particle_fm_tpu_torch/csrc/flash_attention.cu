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
// computes that function. More than 4 query rows at head dims up to 64:
// flash_mma_bf16_kernel, K and V staged as bfloat16 (half the bytes of a
// float32 tile), Q . K^T as bfloat16 products on mma.sync.m16n8k16 (exact: a
// bfloat16 product is exact in float32), the scale applied to S (where the
// Pallas kernel scales q first: at head dim 16 the scale is a power of two and
// the two agree bit for bit), and P . V with P kept in float32, as two TF32
// products (P's head and remainder; V in bfloat16 is exact in TF32). Rounding
// P to bfloat16 for a bfloat16 P . V was the other choice; it would change the
// function. The other shapes (class tokens, head dim 128) run the CUDA-core
// variants on bfloat16 loads and float32 arithmetic; the direct one takes 16
// keys a step in bfloat16 (8-byte loads) to keep its bytes in flight. Bound at
// path D's shape (B=256, Lq=Lk=279, 16 heads of 16): 147 MB, 0.044 ms; Q . K^T
// 10.2 GFLOP in bfloat16, 0.010 ms, and P . V twice in TF32, 0.041 ms: bound
// by tensor operations, 0.075 ms with the 5 operations a score on the CUDA
// cores.

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

// The direct variant's loads, kept as loaded until their step uses them, so
// that every load of a step is in flight before the first is used: a float4
// of float32, or 8 bytes (4 values) of bfloat16, which take twice the keys
// a step (`kKeys`) for the same bytes in flight.
template <typename T>
struct Raw4;
template <>
struct Raw4<float> {
  using type = float4;
  static constexpr int kKeys = kSub;
};
template <>
struct Raw4<__nv_bfloat16> {
  using type = uint2;
  static constexpr int kKeys = 2 * kSub;
};

__device__ __forceinline__ float4 raw4_load(const float* row, int c, int d, bool vec) {
  return load4(row, c, d, vec);
}
__device__ __forceinline__ uint2 raw4_load(const __nv_bfloat16* row, int c, int d, bool vec) {
  uint2 r = make_uint2(0u, 0u);
  if (vec) {
    if (c < d) r = *reinterpret_cast<const uint2*>(row + c);
  } else {
    uint32_t e[4] = {0u, 0u, 0u, 0u};
#pragma unroll
    for (int q = 0; q < 4; ++q)
      if (c + q < d) e[q] = __bfloat16_as_ushort(row[c + q]);
    r.x = e[0] | (e[1] << 16);
    r.y = e[2] | (e[3] << 16);
  }
  return r;
}
__device__ __forceinline__ float4 as_float4(float4 v) { return v; }
__device__ __forceinline__ float4 as_float4(uint2 v) {
  const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v.x));
  const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v.y));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
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
    constexpr int KS = Raw4<T>::kKeys;
    for (int j0 = kbeg; j0 < kend; j0 += KS) {
      typename Raw4<T>::type kk[KS][F4], vv[KS][F4];
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
          qr, o, m, l, [&](int c, int i) { return as_float4(kk[c][i]); },
          [&](int c, int i) { return as_float4(vv[c][i]); }, [&](int c) { return a[c]; });
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

// The variant by shape: at most 4 query rows (a class token) read K and V
// directly, the whole head dim spread over GW lanes; more rows go to the
// tensor cores up to head dim 64, and at head dim 128 to 8 lanes a row (16
// floats of q and of the accumulator per lane). `report` is for the
// tensor-core variant only.
// The bfloat16 tensor-core variant (attention_mma.cuh: Q . K^T as bfloat16
// products, P in float32 through two TF32 products): blocks, warps and splits
// as launch_flash_mma's; K and V staged as bfloat16 at a row stride of DP + 8,
// tiles of the same number of keys.
template <int DP>
__global__ void __launch_bounds__(32 * kRowsPerBlock / kMmaRows)
flash_mma_bf16_kernel(HeadsT<bf16> q, HeadsT<bf16> k, HeadsT<bf16> v,
                      const float* __restrict__ mask, bf16* __restrict__ out,
                      float* __restrict__ part, int lq, int lk, int h, int d, int keys_per_split,
                      float scale) {
  constexpr int ST = DP + 8, KC = flash_mma_tile_keys(DP);
  static_assert(KC % kBfKeys == 0, "a staged tile is a whole number of steps");
  extern __shared__ float4 smem4[];
  bf16* ks = reinterpret_cast<bf16*>(smem4);
  bf16* vs = ks + KC * ST;
  float* madd = reinterpret_cast<float*>(vs + KC * ST);

  const int b = blockIdx.x / h, hd = blockIdx.x % h;
  const int g = (threadIdx.x & 31) >> 2;
  const int row0 = (blockIdx.y * (blockDim.x >> 5) + (threadIdx.x >> 5)) * kMmaRows;
  const int kbeg = blockIdx.z * keys_per_split;
  const int kend = min(lk, kbeg + keys_per_split);

  MmaTileBf16<DP> t;
  mma_tile_init_bf16(t, q.p + b * q.bs + hd * d, q.ld, row0, lq - 1, d, -kNeg);

  const bf16* kbase = k.p + b * k.bs + hd * d;
  const bf16* vbase = v.p + b * v.bs + hd * d;
  for (int c0 = kbeg; c0 < kend; c0 += KC) {
    const int n = min(KC, kend - c0);
    const int np = (n + kBfKeys - 1) / kBfKeys * kBfKeys;  // <= KC
    __syncthreads();  // the previous tile has been used
    stage_head_bf16<DP>(ks, kbase + c0 * k.ld, k.ld, n, np, d);
    stage_head_bf16<DP>(vs, vbase + c0 * v.ld, v.ld, n, np, d);
    stage_mask(madd, mask ? mask + (long long)b * lk + c0 : nullptr, n, np);
    __syncthreads();
    for (int key0 = 0; key0 < np; key0 += kBfKeys) flash_bf16_step(t, ks, vs, madd, key0, scale);
  }

  const long long n_rows = (long long)gridDim.x * lq;
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
      if ((threadIdx.x & 3) == 0) {
        float* ml = part + (long long)gridDim.z * n_rows * d + slot * 2;
        ml[0] = t.m[half];
        ml[1] = sum;
      }
    }
  }
}

template <int DP>
cudaError_t launch_flash_mma_bf16(HeadsT<bf16> q, HeadsT<bf16> k, HeadsT<bf16> v,
                                  const float* mask, bf16* out, float* part, int b, int lq, int lk,
                                  int h, int d, int splits, cudaStream_t stream) {
  constexpr int KC = flash_mma_tile_keys(DP);
  const size_t smem = sizeof(bf16) * (size_t)2 * KC * (DP + 8) + sizeof(float) * KC;
  const int tiles = (lq + kMmaRows - 1) / kMmaRows;
  const int blocks = (tiles + kRowsPerBlock / kMmaRows - 1) / (kRowsPerBlock / kMmaRows);
  const int warps = (tiles + blocks - 1) / blocks;
  cudaError_t err = allow_smem(flash_mma_bf16_kernel<DP>, smem);
  if (err != cudaSuccess) return err;
  const Splits sp = count_splits(lk, splits);
  if (blocks > 65535 || sp.n > 65535 || (sp.n > 1 && part == nullptr))
    return cudaErrorInvalidValue;
  const dim3 grid(b * h, blocks, sp.n);
  flash_mma_bf16_kernel<DP><<<grid, 32 * warps, smem, stream>>>(
      q, k, v, mask, out, sp.n > 1 ? part : nullptr, lq, lk, h, d, sp.keys_per_split,
      1.f / sqrtf((float)d));
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
  if (report) return cudaErrorInvalidValue;
  return launch_flash_mma_bf16<bf16_head_dim(DP)>(q, k, v, mask, out, part, b, lq, lk, h, d,
                                                   splits, stream);
}

template <typename T, int DP, int GW>
cudaError_t launch_flash_dp(HeadsT<T> q, HeadsT<T> k, HeadsT<T> v, const float* mask, T* out,
                            float* part, int b, int lq, int lk, int h, int d, int splits,
                            cudaStream_t stream, int* report) {
  if (report && (lq <= 4 || DP > 64)) return cudaErrorInvalidValue;
  if (lq <= 4)
    return launch_flash<T, DP, GW, true>(q, k, v, mask, out, part, b, lq, lk, h, d, splits,
                                         stream);
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

// The bfloat16 kernel: q, k, v and the output in bfloat16, the mask and the
// scratch in float32; arguments as flash_masked_attention_f32's. More than 4
// query rows at head dims up to 64 go to the bfloat16 tensor-core variant;
// the other shapes run the float32 arithmetic of the CUDA-core variants on
// bfloat16 loads and stores, which is what the Pallas kernel computes (it
// upcasts q, k and v).
extern "C" int flash_masked_attention_bf16(
    const bf16* q, const bf16* k, const bf16* v, const float* mask, bf16* out,
    float* scratch, int b, int lq, int lk, int h, int d, int splits,
    long long q_bs, long long q_ld, long long k_bs, long long k_ld,
    long long v_bs, long long v_ld, void* stream_ptr) {
  return (int)launch_flash_d(heads(q, q_bs, q_ld, d), heads(k, k_bs, k_ld, d),
                             heads(v, v_bs, v_ld, d), mask, out, scratch, b, lq, lk, h, d, splits,
                             static_cast<cudaStream_t>(stream_ptr), nullptr);
}

extern "C" const char* attention_mma_bf16_instruction() { return MMA_BF16_INSTRUCTION; }
