// One EPiC layer, forward only, float32, for sm_90a.
//
// Replaces the TPU kernel particle_fm_tpu/ops/pallas/epic_layer.py
// (`epic_layer_fused_fwd` -> `_kernel`). It computes, for each set b:
//   pooled mean and sum_scale * sum of x over the masked rows;
//   g1    = act(cat(t_g, mean, scaled_sum, g, cond) @ wg1 + bg1)
//   g_new = act(cat(t_g, g1, cond) @ wg2 + bg2 + g)
//   bias1 = cat(t_l, g_new, cond) @ w1s + b1,  bias2 = cat(t_l, cond) @ w2s + b2
//   x1    = act(x @ w1x + bias1),  out = act(x1 @ w2x + bias2 + x)
// with act = leaky_relu(0.01). Every row of the set is computed, padded rows
// included, so padded rows hold finite values (the next layer's pool
// multiplies them by 0, and NaN * 0 would poison the set). An empty set gives
// 0/0 in the mean, as the JAX layer does.
//
// Bound on an H100 SXM at the JetNet-150 flagship shape (B=640, N=150,
// H=128): the two H x H local matmuls are 4*B*N*H*H = 6.3 GFLOP, 94 us at the
// 67 TFLOP/s float32 rate of the CUDA cores; x in and out is 98 MB, 29 us at
// 3.35 TB/s. So the float32 layer is bound by operations, and the design
// aims at keeping the FMA pipes busy with the two local matmuls.
//
// Design: persistent blocks, as many as fit on the card (one per SM at
// H=128), each walking over sets blockIdx.x, blockIdx.x + gridDim.x, ...
// A block has two roles, so that the per-set work, which waits on memory,
// runs beside the matmuls, which wait on the FMA pipes:
//   * 8 producer warps compute, for the block's next set, the masked pool
//     (a pass over the set's rows), the two global MLPs (g_new is written
//     out) and the two per-set biases of the local matmuls. The small dot
//     products split the weight's rows over the warps and its columns over
//     the lanes, so each warp reads whole rows and keeps many loads in
//     flight. The biases go into one of two slots in shared memory.
//   * 8 consumer warps run the local path of the current set: its rows in
//     tiles of 64, staged in shared memory with the width padded to a
//     multiple of 4 (zeros). Warp w owns rows w, w+8, ... of the tile and
//     lane i owns columns 4i..4i+3 (+128 for H > 128), so a thread keeps
//     8 rows x 4 columns of accumulators in registers and, per 4 steps of k,
//     reads 8 float4 of x (one address per warp: broadcast) and 4 float4 of
//     weights for 128 multiply-adds. x1 stays in shared memory between the
//     two matmuls; the output is written once.
//   The two roles hand the bias slots over with named barriers (full: the
//   producers arrive, the consumers wait; empty: the other way round).
//   512 threads leave 128 registers a thread: no spills at H <= 128, a few
//   at H > 128.
//   The local weights w1x and w2x sit in shared memory when they fit
//   (H <= 136: 128 KB at H=128) and are read through the caches otherwise.
//   Where H is a multiple of 4, x is read as float4 (the wrapper checks that
//   x starts on 16 bytes). No tensor cores: the layer runs in float32 on the
//   CUDA cores.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;                     // consumer warps
constexpr int kThreads = kWarps * 32;
constexpr int kPWarps = 8;                    // producer warps
constexpr int kPThreads = kPWarps * 32;
constexpr int kBlock = kThreads + kPThreads;  // threads of a block
constexpr int kRowsPerWarp = 8;
constexpr int kRows = kWarps * kRowsPerWarp;  // rows of one set per tile
constexpr int kMaxSmem = 232448;              // bytes a block may use on sm_90
constexpr int kMaxWidth = 256;                // the largest H and L

// named barriers (0 is __syncthreads)
constexpr int kBarProducers = 1;
constexpr int kBarConsumers = 2;
constexpr int kBarFull = 3;   // + slot
constexpr int kBarEmpty = 5;  // + slot

__device__ __forceinline__ void bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(n) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id, int n) {
  asm volatile("bar.arrive %0, %1;" ::"r"(id), "r"(n) : "memory");
}

struct Params {
  const float* x;      // (B, N, H)
  const float* g;      // (B, L)
  const float* mask;   // (B, N)
  const float* sfeat;  // (B, S): [t_emb, cond]
  const float* wg1; const float* bg1;  // (tg+2H+L+C, H), (H)
  const float* wg2; const float* bg2;  // (tg+H+C, L), (L)
  const float* w1x; const float* w1s; const float* b1;  // (H, H), (tl+L+C, H), (H)
  const float* w2x; const float* w2s; const float* b2;  // (H, H), (tl+C, H), (H)
  float* xo;           // (B, N, H)
  float* go;           // (B, L)
  int n, h, l, s, tg, tl, c;
  float sum_scale;
};

__host__ __device__ constexpr int round4(int v) { return (v + 3) & ~3; }

__device__ __forceinline__ float act(float v) { return v >= 0.f ? v : 0.01f * v; }

// Shared-memory layout in floats; every region starts on 16 bytes.
struct Layout {
  int hp;              // H padded to a multiple of 4
  int k1, k2, k3, k4;  // widths of the four concatenated per-set inputs
  // consumers: weights, x tile, x1 tile; two slots of (bias1, bias2);
  // producers: pool partials, MLP inputs and outputs, dot partials, count
  int w, xs, x1s, bias, red, gin, g1, in2, gnew, s1, s2, part, cnt, total;
  __host__ __device__ Layout(int h, int l, int tg, int tl, int c, bool w_smem) {
    hp = round4(h);
    k1 = tg + 2 * h + l + c;
    k2 = tg + h + c;
    k3 = tl + l + c;
    k4 = tl + c;
    int o = 0;
    w = o;     o += w_smem ? 2 * hp * hp : 0;
    xs = o;    o += kRows * hp;
    x1s = o;   o += kRows * hp;
    bias = o;  o += 4 * hp;
    red = o;   o += kPWarps * hp;
    gin = o;   o += round4(k1);
    g1 = o;    o += hp;
    in2 = o;   o += round4(k2);
    gnew = o;  o += round4(l);
    s1 = o;    o += round4(k3);
    s2 = o;    o += round4(k4);
    part = o;  o += kPWarps * round4(h > l ? h : l);
    cnt = o;   o += 4;
    total = o;
  }
};

// epi(j, dot(in[0:k], w[:, j])) for j < m (w row-major (k, m), m <= 256), by
// the producer warps (t = producer thread). Warp q takes rows q, q + 8, ...
// of w and lane i its columns i, i + 32, ...; the warps' partial sums meet
// in `part` (kPWarps * m floats). The per-set MLPs are bound by the latency
// of reading w through L2, not by their few multiply-adds, so the loop keeps
// many loads in flight.
template <class Epi>
__device__ __forceinline__ void group_dot(const float* in, const float* __restrict__ w, int k,
                                          int m, float* part, int t, Epi epi) {
  const int warp = t / 32, lane = t % 32;
  float acc[kMaxWidth / 32];
#pragma unroll
  for (int q = 0; q < kMaxWidth / 32; ++q) acc[q] = 0.f;
#pragma unroll 4
  for (int i = warp; i < k; i += kPWarps) {
    const float a = in[i];
    const float* wr = w + (size_t)i * m;
#pragma unroll
    for (int q = 0; q < kMaxWidth / 32; ++q)
      if (lane + 32 * q < m) acc[q] = fmaf(a, __ldg(wr + lane + 32 * q), acc[q]);
  }
#pragma unroll
  for (int q = 0; q < kMaxWidth / 32; ++q)
    if (lane + 32 * q < m) part[warp * m + lane + 32 * q] = acc[q];
  bar_sync(kBarProducers, kPThreads);
  for (int j = t; j < m; j += kPThreads) {
    float s = 0.f;
    for (int q = 0; q < kPWarps; ++q) s += part[q * m + j];
    epi(j, s);
  }
  bar_sync(kBarProducers, kPThreads);  // the outputs are read, part reused next
}

// Producers: pool, per-set MLPs and the two biases of set b into bias slot
// (bias1, bias2) = (slot[0:hp], slot[hp:2hp]); t is the producer thread.
template <int CG>
__device__ __forceinline__ void produce_set(const Params& p, const Layout& lay, float* sm,
                                            float* slot, int b, int t) {
  const int warp = t / 32, lane = t % 32;
  const int n = p.n, h = p.h, l = p.l, tg = p.tg, tl = p.tl, c = p.c;
  const int hp = lay.hp;
  const float* x = p.x + (size_t)b * n * h;
  const float* m = p.mask + (size_t)b * n;
  const float* sf = p.sfeat + (size_t)b * p.s;
  const float* cond = sf + p.s - c;
  const float* g = p.g + (size_t)b * l;
  float* red = sm + lay.red;
  float* part = sm + lay.part;

  // pool: per-warp partial sums over rows warp, warp + 8, ...; lane owns
  // columns 4*lane + 128*j + q, q < 4
  float acc[4 * CG];
#pragma unroll
  for (int j = 0; j < 4 * CG; ++j) acc[j] = 0.f;
  const bool vec = h == hp;  // rows of x are whole float4s
#pragma unroll 4
  for (int row = warp; row < n; row += kPWarps) {
    const float mv = m[row];
    const float* xr = x + (size_t)row * h;
#pragma unroll
    for (int j = 0; j < CG; ++j) {
      const int col = 4 * lane + 128 * j;
      if (vec) {
        if (col < h) {
          const float4 v4 = __ldg(reinterpret_cast<const float4*>(xr + col));
          acc[4 * j + 0] = fmaf(v4.x, mv, acc[4 * j + 0]);
          acc[4 * j + 1] = fmaf(v4.y, mv, acc[4 * j + 1]);
          acc[4 * j + 2] = fmaf(v4.z, mv, acc[4 * j + 2]);
          acc[4 * j + 3] = fmaf(v4.w, mv, acc[4 * j + 3]);
        }
      } else {
#pragma unroll
        for (int q = 0; q < 4; ++q)
          if (col + q < h) acc[4 * j + q] = fmaf(__ldg(xr + col + q), mv, acc[4 * j + q]);
      }
    }
  }
#pragma unroll
  for (int j = 0; j < CG; ++j)
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int col = 4 * lane + 128 * j + q;
      if (col < h) red[warp * hp + col] = acc[4 * j + q];
    }
  if (warp == 0) {
    float cnt = 0.f;
    for (int row = lane; row < n; row += 32) cnt += m[row];
    for (int off = 16; off > 0; off /= 2) cnt += __shfl_xor_sync(0xffffffffu, cnt, off);
    if (lane == 0) sm[lay.cnt] = cnt;
  }
  bar_sync(kBarProducers, kPThreads);

  // global MLP 1 on cat(t_g, mean, scaled_sum, g, cond)
  float* gin = sm + lay.gin;
  for (int i = t; i < lay.k1; i += kPThreads) {
    float v;
    if (i < tg) {
      v = sf[i];
    } else if (i < tg + 2 * h) {
      const int col = (i - tg) % h;
      float s = 0.f;
      for (int q = 0; q < kPWarps; ++q) s += red[q * hp + col];
      v = i < tg + h ? s / sm[lay.cnt] : s * p.sum_scale;
    } else if (i < tg + 2 * h + l) {
      v = g[i - tg - 2 * h];
    } else {
      v = cond[i - tg - 2 * h - l];
    }
    gin[i] = v;
  }
  bar_sync(kBarProducers, kPThreads);
  float* g1 = sm + lay.g1;
  group_dot(gin, p.wg1, lay.k1, h, part, t, [&](int j, float v) { g1[j] = act(v + p.bg1[j]); });

  // global MLP 2 on cat(t_g, g1, cond), residual g
  float* in2 = sm + lay.in2;
  for (int i = t; i < lay.k2; i += kPThreads)
    in2[i] = i < tg ? sf[i] : (i < tg + h ? g1[i - tg] : cond[i - tg - h]);
  bar_sync(kBarProducers, kPThreads);
  float* gnew = sm + lay.gnew;
  group_dot(in2, p.wg2, lay.k2, l, part, t, [&](int j, float v) {
    const float gn = act(v + p.bg2[j] + g[j]);
    gnew[j] = gn;
    p.go[(size_t)b * l + j] = gn;
  });

  // per-set biases of the two local matmuls (their padded columns stay zero)
  float* s1 = sm + lay.s1;
  float* s2 = sm + lay.s2;
  for (int i = t; i < lay.k3; i += kPThreads)
    s1[i] = i < tl ? sf[i] : (i < tl + l ? gnew[i - tl] : cond[i - tl - l]);
  for (int i = t; i < lay.k4; i += kPThreads) s2[i] = i < tl ? sf[i] : cond[i - tl];
  bar_sync(kBarProducers, kPThreads);
  float* bias1 = slot;
  float* bias2 = slot + hp;
  group_dot(s1, p.w1s, lay.k3, h, part, t, [&](int j, float v) { bias1[j] = v + p.b1[j]; });
  group_dot(s2, p.w2s, lay.k4, h, part, t, [&](int j, float v) { bias2[j] = v + p.b2[j]; });
}

// acc[r][c] = sum_k a[row_r, k] * w[k, col_c] over the tile in shared memory,
// row_r = warp + 8r (rows >= `rows` skipped unless the tile is FULL),
// col_c = 4*lane + 128*(c/4) + c%4.
// `w` is (hp, hp) zero-padded in shared memory (WS) or (h, h) in global memory.
// A FULL tile has no branch between the rows, so the compiler can issue the
// shared-memory loads of later rows ahead of the multiply-adds of earlier ones.
template <int CG, bool WS, bool FULL>
__device__ __forceinline__ void tile_matmul(const float* a, const float* w, int h, int hp,
                                            int warp, int lane, int rows,
                                            float (&acc)[kRowsPerWarp][4 * CG]) {
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r)
#pragma unroll
    for (int q = 0; q < 4 * CG; ++q) acc[r][q] = 0.f;
  for (int k = 0; k < hp; k += 4) {
    float wv[4][4 * CG];
#pragma unroll
    for (int j = 0; j < CG; ++j) {
      const int col = 4 * lane + 128 * j;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        if (WS) {
          float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
          if (col < hp) v = *reinterpret_cast<const float4*>(w + (k + kk) * hp + col);
          wv[kk][4 * j + 0] = v.x;
          wv[kk][4 * j + 1] = v.y;
          wv[kk][4 * j + 2] = v.z;
          wv[kk][4 * j + 3] = v.w;
        } else {
#pragma unroll
          for (int q = 0; q < 4; ++q)
            wv[kk][4 * j + q] = (k + kk < h && col + q < h)
                                    ? __ldg(w + (size_t)(k + kk) * h + col + q) : 0.f;
        }
      }
    }
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      const int row = warp + kWarps * r;
      if (!FULL && row >= rows) break;  // warp-uniform
      const float4 av = *reinterpret_cast<const float4*>(a + row * hp + k);
#pragma unroll
      for (int q = 0; q < 4 * CG; ++q) {
        acc[r][q] = fmaf(av.x, wv[0][q], acc[r][q]);
        acc[r][q] = fmaf(av.y, wv[1][q], acc[r][q]);
        acc[r][q] = fmaf(av.z, wv[2][q], acc[r][q]);
        acc[r][q] = fmaf(av.w, wv[3][q], acc[r][q]);
      }
    }
  }
}

template <int CG, bool WS>
__device__ __forceinline__ void local_matmul(const float* a, const float* w, int h, int hp,
                                             int warp, int lane, int rows,
                                             float (&acc)[kRowsPerWarp][4 * CG]) {
  if (rows == kRows)
    tile_matmul<CG, WS, true>(a, w, h, hp, warp, lane, rows, acc);
  else
    tile_matmul<CG, WS, false>(a, w, h, hp, warp, lane, rows, acc);
}

// Consumers: the local path of set b, tile by tile of kRows rows, with the
// biases of `slot`; tid is the consumer thread.
template <int CG, bool WS>
__device__ __forceinline__ void consume_set(const Params& p, const Layout& lay, float* sm,
                                            const float* w1, const float* w2,
                                            const float* slot, int b, int tid) {
  const int warp = tid / 32, lane = tid % 32;
  const int n = p.n, h = p.h, hp = lay.hp;
  const bool vec = h == hp;
  const float* x = p.x + (size_t)b * n * h;
  const float* bias1 = slot;
  const float* bias2 = slot + hp;
  float* xs = sm + lay.xs;
  float* x1s = sm + lay.x1s;
  float* xo = p.xo + (size_t)b * n * h;
  for (int r0 = 0; r0 < n; r0 += kRows) {
    const int rows = min(kRows, n - r0);
    if (vec) {  // the tile is rows*h contiguous floats of x, then zeros
      const float4* src = reinterpret_cast<const float4*>(x + (size_t)r0 * h);
      float4* dst = reinterpret_cast<float4*>(xs);
      const int n4 = rows * h / 4;
#pragma unroll 8
      for (int i = tid; i < kRows * hp / 4; i += kThreads)
        dst[i] = i < n4 ? __ldg(src + i) : make_float4(0.f, 0.f, 0.f, 0.f);
    } else {
      for (int i = tid; i < kRows * hp; i += kThreads) {
        const int r = i / hp, col = i - r * hp;
        xs[i] = (r < rows && col < h) ? __ldg(x + (size_t)(r0 + r) * h + col) : 0.f;
      }
    }
    bar_sync(kBarConsumers, kThreads);

    float acc[kRowsPerWarp][4 * CG];
    local_matmul<CG, WS>(xs, w1, h, hp, warp, lane, rows, acc);
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      const int row = warp + kWarps * r;
#pragma unroll
      for (int q = 0; q < 4 * CG; ++q) {
        const int col = 4 * lane + 128 * (q / 4) + q % 4;
        if (col < hp) x1s[row * hp + col] = act(acc[r][q] + bias1[col]);
      }
    }
    bar_sync(kBarConsumers, kThreads);

    local_matmul<CG, WS>(x1s, w2, h, hp, warp, lane, rows, acc);
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      const int row = warp + kWarps * r;
      if (row >= rows) break;
#pragma unroll
      for (int q = 0; q < 4 * CG; ++q) {
        const int col = 4 * lane + 128 * (q / 4) + q % 4;
        if (col < h)
          xo[(size_t)(r0 + row) * h + col] = act(acc[r][q] + bias2[col] + xs[row * hp + col]);
      }
    }
    bar_sync(kBarConsumers, kThreads);  // xs and x1s are overwritten by the next tile
  }
}

// Persistent blocks: load the local weights once, then the producers and the
// consumers walk over the block's sets, handing the bias slots over.
template <int CG, bool WS>
__global__ void __launch_bounds__(kBlock, 1)
epic_layer_kernel(Params p, int n_sets) {
  extern __shared__ __align__(16) float sm[];
  const Layout lay(p.h, p.l, p.tg, p.tl, p.c, WS);
  const int h = p.h, hp = lay.hp;
  const float* w1 = p.w1x;
  const float* w2 = p.w2x;
  if (WS) {
    float* ws = sm + lay.w;
    for (int i = threadIdx.x; i < hp * hp; i += kBlock) {
      const int k = i / hp, col = i - k * hp;
      const bool in = k < h && col < h;
      ws[i] = in ? __ldg(p.w1x + k * h + col) : 0.f;
      ws[hp * hp + i] = in ? __ldg(p.w2x + k * h + col) : 0.f;
    }
    w1 = ws;
    w2 = ws + hp * hp;
  }
  for (int i = threadIdx.x; i < 4 * hp; i += kBlock) sm[lay.bias + i] = 0.f;
  __syncthreads();

  // this block's sets: blockIdx.x + k * gridDim.x for k < nk (grid <= n_sets)
  const int nk = (n_sets - 1 - blockIdx.x) / gridDim.x + 1;
  if (threadIdx.x >= kThreads) {
    const int t = threadIdx.x - kThreads;
    for (int k = 0; k < nk; ++k) {
      const int s = k & 1;
      if (k >= 2) bar_sync(kBarEmpty + s, kBlock);  // the consumers are done with slot s
      produce_set<CG>(p, lay, sm, sm + lay.bias + 2 * hp * s, blockIdx.x + k * gridDim.x, t);
      bar_arrive(kBarFull + s, kBlock);
    }
  } else {
    for (int k = 0; k < nk; ++k) {
      const int s = k & 1;
      bar_sync(kBarFull + s, kBlock);  // the producers have filled slot s
      consume_set<CG, WS>(p, lay, sm, w1, w2, sm + lay.bias + 2 * hp * s,
                          blockIdx.x + k * gridDim.x, threadIdx.x);
      if (k + 2 < nk) bar_arrive(kBarEmpty + s, kBlock);
    }
  }
}

template <int CG, bool WS>
cudaError_t launch(const Params& p, int b, size_t smem, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      epic_layer_kernel<CG, WS>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, epic_layer_kernel<CG, WS>,
                                                      kBlock, smem);
  if (err != cudaSuccess) return err;
  const int grid = per_sm > 0 ? min(b, sms * per_sm) : b;
  epic_layer_kernel<CG, WS><<<grid, kBlock, smem, stream>>>(p, b);
  return cudaGetLastError();
}

}  // namespace

// Returns the launch's cudaError_t (0 on success). Shapes were checked by
// the Python wrapper (particle_fm_tpu_torch/ops/epic_layer.py);
// 1 <= h <= 256 and 1 <= l <= 256.
extern "C" int epic_layer_fwd_f32(
    const float* x, const float* g, const float* mask, const float* sfeat,
    const float* wg1, const float* bg1, const float* wg2, const float* bg2,
    const float* w1x, const float* w1s, const float* b1,
    const float* w2x, const float* w2s, const float* b2,
    float* xo, float* go,
    int b, int n, int h, int l, int s, int tg, int tl, int c,
    float sum_scale, void* stream_ptr) {
  if (b <= 0 || n <= 0 || h <= 0 || h > kMaxWidth || l <= 0 || l > kMaxWidth)
    return (int)cudaErrorInvalidValue;
  const Params p{x, g, mask, sfeat, wg1, bg1, wg2, bg2, w1x, w1s, b1, w2x, w2s, b2,
                 xo, go, n, h, l, s, tg, tl, c, sum_scale};
  const bool two = round4(h) > 128;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const size_t smem_ws = sizeof(float) * (size_t)Layout(h, l, tg, tl, c, true).total;
  if (smem_ws <= (size_t)kMaxSmem)
    return (int)(two ? launch<2, true>(p, b, smem_ws, stream)
                     : launch<1, true>(p, b, smem_ws, stream));
  const size_t smem = sizeof(float) * (size_t)Layout(h, l, tg, tl, c, false).total;
  if (smem > (size_t)kMaxSmem) return (int)cudaErrorInvalidValue;
  return (int)(two ? launch<2, false>(p, b, smem, stream) : launch<1, false>(p, b, smem, stream));
}
