// One EPiC layer, forward only, for sm_90a: float32 (`epic_layer_fwd_f32`,
// below) and bfloat16 (`epic_layer_fwd_bf16`, at the end of this file, with
// its own design note).
//
// Replaces the TPU kernel particle_fm_tpu/ops/pallas/epic_layer.py
// (`epic_layer_fused_fwd` -> `_kernel`). It computes, for each set b:
//   pooled mean and sum_scale * sum of x over the masked rows;
//   g1    = act(cat(t_g, mean, scaled_sum, g, cond_g) @ wg1 + bg1)
//   g_new = act(cat(t_g, g1, cond_g) @ wg2 + bg2 + g)
//   bias1 = cat(t_l, g_new, cond_l) @ w1s + b1,  bias2 = cat(t_l, cond_l) @ w2s + b2
//   x1    = act(x @ w1x + bias1),  out = act(x1 @ w2x + bias2 + x)
// with act = leaky_relu(0.01). cond is the last C floats of the per-set
// features; it feeds the global MLPs when cg = C and the local biases when
// cl = C (cond_g, cond_l are then C wide, else empty). Every row of the set is
// computed, padded rows included, so padded rows hold finite values (the next
// layer's pool multiplies them by 0, and NaN * 0 would poison the set). An
// empty set gives 0/0 in the mean, as the JAX layer does.
//
// Bound on an H100 SXM at the JetNet-150 flagship shape (B=640, N=150,
// H=128): the two H x H local matmuls are 4*B*N*H*H = 6.29 GFLOP of the
// layer's 6.44. They run on the tensor cores in split-precision TF32
// (mma_tf32.cuh: three TF32 products per float32 product), 18.9 GFLOP of TF32
// issued, 38 us at 495 TFLOP/s; the rest, 0.15 GFLOP on the CUDA cores, 2 us;
// x in and out is 98 MB, 30 us at 3.35 TB/s. So the layer is bound by tensor
// operations, about 40 us.
//
// Design: persistent blocks, one per SM, each walking over sets blockIdx.x,
// blockIdx.x + gridDim.x, ... A block has two roles, so that the per-set work,
// which waits on memory, runs beside the matmuls:
//   * 4 producer warps compute, for the block's next set, the masked pool (a
//     pass over the set's rows), the two global MLPs (g_new is written out)
//     and the two per-set biases of the local matmuls. The small dot products
//     split the weight's rows over the warps and its columns over the lanes,
//     so each warp reads whole rows and keeps many loads in flight. The
//     biases go into one of two slots in shared memory.
//   * 16 consumer warps run the local path of the current set, in tiles of R
//     rows (64, or 32 where 64 do not fit), staged in shared memory with
//     cp.async at a row stride of HP+4 floats (HP: H padded with zeros to a
//     multiple of 32). The two matmuls run on mma.sync.m16n8k8 in
//     split-precision TF32. A warp owns an output tile of 16 rows by 32
//     columns (four n8 tiles); a round of warp tiles covers every 16-row block
//     of the tile by 16 / (R / 16) column blocks, and a warp whose rows lie past
//     the set's end sits the round out, so N=150 computes 160 rows; a set's
//     last tile of at most 32 rows takes tiles 16 columns wide, so that all
//     16 warps have work (N=150: its last 22 rows). Per step
//     of 8 along k a warp reads and splits its A fragment (x or x1) and its 4 B
//     fragments (weights) and issues 12 mma, product by product over the four
//     accumulators (mma_tf32.cuh). The step has no branch: one guard per
//     fragment had the compiler wrap every mma in a warp synchronisation of its
//     own, and the kernel ran at a third of this speed. x1 stays in shared
//     memory between the two matmuls. Once the first matmul of a tile is done,
//     the next tile's rows are copied into the x tile with cp.async while the
//     second runs; its residual x is read from global memory (the tile was
//     read microseconds before: L2) before its matmul starts.
//   The two roles hand the bias slots over with named barriers (full: the
//   producers arrive, the consumers wait; empty: the other way round).
//   Weights: where both fit beside the tiles (H <= 128, and a little above
//   with 32-row tiles), w1x and w2x are staged once per block, transposed
//   (column-major, row stride HP+4) so that the B fragment reads hit 32
//   different banks as the A reads do. Above that, the consumers stage them
//   together, in slices of 32 (or 16) rows of the round's columns, two in
//   turn with cp.async: each slice comes from L2 once for all the row blocks
//   of the tile. Read by every warp straight from L2, the fragments made the
//   layer bound by L2 (2.3 GB a layer at lhco/bigPC's shape).
// Shared memory (a block may use 232,448 bytes): at H=128 the transposed
// weights take 2 x 128 x 132 x 4 = 135 KB, the x and x1 tiles 2 x 64 x 132
// x 4 = 68 KB, the producers' scratch 6 KB. At H=300 (HP=320) the tiles take
// 166 KB and two slices 35 KB.
//
// Measured (NVIDIA H100 80GB HBM3, 700 W; scripts/epic_layer_variants.py
// times variants in turns; PERF.md has the numbers): the layer stays some
// seven times above its bound. With one TF32 product in place of three it
// takes 70% of the time: mma.sync issued from 4 warps an SM quarter costs
// some 12 cycles of the quarter each, and reading and splitting the fragments
// (3 integer and float operations per operand) is as much again.

#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_bf16.cuh"
#include "mma_tf32.cuh"

namespace {

constexpr int kWarps = 16;                    // consumer warps
constexpr int kThreads = kWarps * 32;
constexpr int kPWarps = 4;                    // producer warps
constexpr int kPThreads = kPWarps * 32;
constexpr int kBlock = kThreads + kPThreads;  // threads of a block
constexpr int kMaxSmem = 232448;              // bytes a block may use on sm_90
constexpr int kMaxWidth = 512;                // the largest H and L
constexpr int kMt = 1;                        // m16 tiles of a warp's output tile
constexpr int kNt = 4;                        // n8 tiles of a warp's output tile
constexpr int kWarpRows = 16 * kMt;
constexpr int kWarpCols = 8 * kNt;

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

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(d), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(d), "l"(src) : "memory");
}
// `bytes` of src (0 to 16), the rest of the 16 bytes zeros
__device__ __forceinline__ void cp_async16_fill(float* dst, const float* src, int bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(d), "l"(src), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async4_fill(float* dst, const float* src, int bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(d), "l"(src), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;"); }
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;" ::: "memory");
}

struct Params {
  const float* x;      // (B, N, H)
  const float* g;      // (B, L)
  const float* mask;   // (B, N)
  const float* sfeat;  // (B, S): [t_emb, cond]
  const float* wg1; const float* bg1;  // (tg+2H+L+cg, H), (H)
  const float* wg2; const float* bg2;  // (tg+H+cg, L), (L)
  const float* w1x; const float* w1s; const float* b1;  // (H, H), (tl+L+cl, H), (H)
  const float* w2x; const float* w2s; const float* b2;  // (H, H), (tl+cl, H), (H)
  float* xo;           // (B, N, H)
  float* go;           // (B, L)
  int n, h, l, s, tg, tl, cg, cl;
  float sum_scale;
};

__host__ __device__ constexpr int round4(int v) { return (v + 3) & ~3; }
__host__ __device__ constexpr int round32(int v) { return (v + 31) & ~31; }

__device__ __forceinline__ float act(float v) { return v >= 0.f ? v : 0.01f * v; }

// Shared-memory layout in floats; every region starts on 16 bytes.
struct Layout {
  int hp;              // H padded to a multiple of 32 (whole warp tiles)
  int st;              // row stride of the tiles and the staged weights: hp + 4
  int rows;            // rows of a tile: 64 or 32
  int round_cols;      // columns of the output a round of warp tiles covers
  int ks, ss;          // k rows of a staged slice of the weights, its row stride
  int k1, k2, k3, k4;  // widths of the four concatenated per-set inputs
  // consumers: weights (or two slices of them), x tile, x1 tile; two slots of
  // (bias1, bias2);
  // producers: pool partials, MLP inputs and outputs, dot partials, count
  int w, xs, x1s, bias, red, gin, g1, in2, gnew, s1, s2, part, cnt, total;
  __host__ __device__ Layout(int h, int l, int tg, int tl, int cg, int cl, bool w_smem,
                             int tile_rows, int slice_rows = 0) {
    hp = round32(h);
    st = hp + 4;
    rows = tile_rows;
    ks = slice_rows;
    k1 = tg + 2 * h + l + cg;
    k2 = tg + h + cg;
    k3 = tl + l + cl;
    k4 = tl + cl;
    // a round of warp tiles: every row block of the tile by kWarps / (rows / 16)
    // column blocks; without the weights in shared memory, two slices of
    // ks rows of the round's columns take their place (row stride
    // round_cols + 8: the B fragment reads hit 32 different banks)
    round_cols = kWarps / (rows / 16) * kWarpCols;
    ss = round_cols + 8;
    int o = 0;
    w = o;     o += w_smem ? 2 * hp * st : 2 * ks * ss;
    xs = o;    o += rows * st;
    x1s = o;   o += rows * st;
    bias = o;  o += 4 * hp;
    gin = o;   o += round4(k1);
    g1 = o;    o += hp;
    in2 = o;   o += round4(k2);
    gnew = o;  o += round4(l);
    s1 = o;    o += round4(k3);
    s2 = o;    o += round4(k4);
    // the pool's partials (red) are dead once the MLP input is built, and the
    // dot products' partials (part) take their place
    red = part = o;
    const int dots = round4(h > l ? h : l);
    o += kPWarps * (dots > hp ? dots : hp);
    cnt = o;   o += 4;
    total = o;
  }
  __host__ __device__ size_t bytes() const { return sizeof(float) * (size_t)total; }
};

// epi(j, dot(in[0:k], w[:, j])) for j < m (w row-major (k, m), m <= 512), by
// the producer warps (t = producer thread), in passes of 128 columns. Warp q
// takes rows q, q + 8, ... of w and lane i the columns i, i + 32, i + 64,
// i + 96 of the pass; the warps' partial sums meet in `part` (kPWarps * m
// floats). The per-set MLPs are bound by the latency of reading w through
// L2, not by their few multiply-adds, so the loop keeps many loads in flight.
template <class Epi>
__device__ __forceinline__ void group_dot(const float* in, const float* __restrict__ w, int k,
                                          int m, float* part, int t, Epi epi) {
  const int warp = t / 32, lane = t % 32;
  for (int c0 = lane; c0 < m; c0 += 128) {
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 4
    for (int i = warp; i < k; i += kPWarps) {
      const float a = in[i];
      const float* wr = w + (size_t)i * m + c0;
#pragma unroll
      for (int q = 0; q < 4; ++q)
        if (c0 + 32 * q < m) acc[q] = fmaf(a, __ldg(wr + 32 * q), acc[q]);
    }
#pragma unroll
    for (int q = 0; q < 4; ++q)
      if (c0 + 32 * q < m) part[warp * m + c0 + 32 * q] = acc[q];
  }
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
__device__ __forceinline__ void produce_set(const Params& p, const Layout& lay, float* sm,
                                            float* slot, int b, int t) {
  const int warp = t / 32, lane = t % 32;
  const int n = p.n, h = p.h, l = p.l, tg = p.tg, tl = p.tl;
  const int hp = lay.hp;
  const float* x = p.x + (size_t)b * n * h;
  const float* m = p.mask + (size_t)b * n;
  const float* sf = p.sfeat + (size_t)b * p.s;
  const float* cond_g = sf + p.s - p.cg;
  const float* cond_l = sf + p.s - p.cl;
  const float* g = p.g + (size_t)b * l;
  float* red = sm + lay.red;
  float* part = sm + lay.part;

  // pool: per-warp partial sums over rows warp, warp + 8, ..., in passes of
  // 128 columns; lane owns columns c0 + 4*lane .. c0 + 4*lane + 3
  const bool vec = h % 4 == 0;  // rows of x are whole float4s
  for (int c0 = 4 * lane; c0 < h; c0 += 128) {
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 4
    for (int row = warp; row < n; row += kPWarps) {
      const float mv = m[row];
      const float* xr = x + (size_t)row * h + c0;
      if (vec) {
        const float4 v4 = __ldg(reinterpret_cast<const float4*>(xr));
        acc[0] = fmaf(v4.x, mv, acc[0]);
        acc[1] = fmaf(v4.y, mv, acc[1]);
        acc[2] = fmaf(v4.z, mv, acc[2]);
        acc[3] = fmaf(v4.w, mv, acc[3]);
      } else {
#pragma unroll
        for (int q = 0; q < 4; ++q)
          if (c0 + q < h) acc[q] = fmaf(__ldg(xr + q), mv, acc[q]);
      }
    }
#pragma unroll
    for (int q = 0; q < 4; ++q)
      if (c0 + q < h) red[warp * hp + c0 + q] = acc[q];
  }
  if (warp == 0) {
    float cnt = 0.f;
    for (int row = lane; row < n; row += 32) cnt += m[row];
    for (int off = 16; off > 0; off /= 2) cnt += __shfl_xor_sync(0xffffffffu, cnt, off);
    if (lane == 0) sm[lay.cnt] = cnt;
  }
  bar_sync(kBarProducers, kPThreads);

  // global MLP 1 on cat(t_g, mean, scaled_sum, g, cond_g)
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
      v = cond_g[i - tg - 2 * h - l];
    }
    gin[i] = v;
  }
  bar_sync(kBarProducers, kPThreads);
  float* g1 = sm + lay.g1;
  group_dot(gin, p.wg1, lay.k1, h, part, t, [&](int j, float v) { g1[j] = act(v + p.bg1[j]); });

  // global MLP 2 on cat(t_g, g1, cond_g), residual g
  float* in2 = sm + lay.in2;
  for (int i = t; i < lay.k2; i += kPThreads)
    in2[i] = i < tg ? sf[i] : (i < tg + h ? g1[i - tg] : cond_g[i - tg - h]);
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
    s1[i] = i < tl ? sf[i] : (i < tl + l ? gnew[i - tl] : cond_l[i - tl - l]);
  for (int i = t; i < lay.k4; i += kPThreads) s2[i] = i < tl ? sf[i] : cond_l[i - tl];
  bar_sync(kBarProducers, kPThreads);
  float* bias1 = slot;
  float* bias2 = slot + hp;
  group_dot(s1, p.w1s, lay.k3, h, part, t, [&](int j, float v) { bias1[j] = v + p.b1[j]; });
  group_dot(s2, p.w2s, lay.k4, h, part, t, [&](int j, float v) { bias2[j] = v + p.b2[j]; });
}

// Rows r0 .. r0 + rows - 1 of set b into the x tile with cp.async (one
// group); columns from h on keep the zeros they were given at the start.
__device__ __forceinline__ void stage_tile(const Params& p, const Layout& lay, float* xs, int b,
                                           int r0, int tid) {
  const int h = p.h, st = lay.st;
  const int rows = min(lay.rows, p.n - r0);
  const float* src = p.x + ((size_t)b * p.n + r0) * h;
  if (h % 4 == 0) {
    const int q = h / 4;
    for (int i = tid; i < rows * q; i += kThreads) {
      const int r = i / q, c = i - r * q;
      cp_async16(xs + r * st + 4 * c, src + (size_t)r * h + 4 * c);
    }
  } else {
    for (int i = tid; i < rows * h; i += kThreads) {
      const int r = i / h, c = i - r * h;
      cp_async4(xs + r * st + c, src + (size_t)r * h + c);
    }
  }
  cp_async_commit();
}

// acc[mt][nt] = the warp's output tile, rows r0 + 16 mt .., columns
// n0 + 8 nt .., of a (tile in shared memory, row stride st) times w, the
// transposed weights in shared memory (row stride st, zero-padded), over
// k < hp, for NT n8 tiles. The fragments of the next step along k are read
// while this step's mma run. No branch: hp is a whole number of warp tiles.
template <int NT>
__device__ __forceinline__ void warp_matmul(const float* a, const float* w, int hp, int st,
                                            int r0, int n0, float (&acc)[kMt][NT][4]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int mt = 0; mt < kMt; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0.f;
  const float* arow = a + (r0 + g) * st + t;
  int ncol[NT];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) ncol[nt] = (n0 + 8 * nt + g) * st + t;
  // the fragments of step k0 as read: A (m16 tiles x 4), B (n8 tiles x 2)
  float ra[kMt][4], rb[NT][2];
  auto load = [&](int k0) {
#pragma unroll
    for (int mt = 0; mt < kMt; ++mt) {
      const float* ar = arow + 16 * mt * st + k0;
      ra[mt][0] = ar[0];
      ra[mt][1] = ar[8 * st];
      ra[mt][2] = ar[4];
      ra[mt][3] = ar[8 * st + 4];
    }
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      rb[nt][0] = w[ncol[nt] + k0];
      rb[nt][1] = w[ncol[nt] + k0 + 4];
    }
  };
  load(0);
  for (int k0 = 0; k0 < hp; k0 += 8) {
    uint32_t a_hi[kMt][4], a_lo[kMt][4];
    Tf32 b0[NT], b1[NT];
#pragma unroll
    for (int mt = 0; mt < kMt; ++mt)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const Tf32 x = split_tf32(ra[mt][i]);
        a_hi[mt][i] = x.hi;
        a_lo[mt][i] = x.lo;
      }
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      b0[nt] = split_tf32(rb[nt][0]);
      b1[nt] = split_tf32(rb[nt][1]);
    }
    load(min(k0 + 8, hp - 8));  // the next step's reads wait behind this step's mma
    mma_3xtf32_tile(acc, a_hi, a_lo, b0, b1);
  }
}

// Rows k0 .. k0 + ks - 1 and columns col0 .. col0 + round_cols - 1 of
// the (h, h) weights w into a slice in shared memory with cp.async (one
// group), zeros past h.
__device__ __forceinline__ void stage_slice(float* dst, const float* w, int h, const Layout& lay,
                                            int k0, int col0, int tid) {
  const int q = lay.round_cols / 4;
  if (h % 4 == 0 && (reinterpret_cast<uintptr_t>(w) & 15) == 0) {
    for (int i = tid; i < lay.ks * q; i += kThreads) {
      const int r = i / q, c = 4 * (i - r * q), k = k0 + r, col = col0 + c;
      const int bytes = k < h ? 4 * max(0, min(4, h - col)) : 0;
      cp_async16_fill(dst + r * lay.ss + c, bytes ? w + (size_t)k * h + col : w, bytes);
    }
  } else {
    for (int i = tid; i < lay.ks * 4 * q; i += kThreads) {
      const int r = i / (4 * q), c = i - r * 4 * q, k = k0 + r, col = col0 + c;
      const int bytes = k < h && col < h ? 4 : 0;
      cp_async4_fill(dst + r * lay.ss + c, bytes ? w + (size_t)k * h + col : w, bytes);
    }
  }
  cp_async_commit();
}

// warp_matmul with the weights read from global memory through slices of
// ks rows staged in shared memory, two in turn, by all the consumer
// warps together: every row block of the tile reads a slice that one copy
// brought from L2. Every consumer thread takes part; only `active` warps
// compute. col0: the round's first column; n0: the warp's.
template <int KS>
__device__ __forceinline__ void sliced_matmul(const float* a, const float* w, float* slices,
                                              int h, const Layout& lay, int col0, int r0, int n0,
                                              bool active, int tid,
                                              float (&acc)[kMt][kNt][4]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int st = lay.st, ss = lay.ss, n_slices = lay.hp / KS;
#pragma unroll
  for (int mt = 0; mt < kMt; ++mt)
#pragma unroll
    for (int nt = 0; nt < kNt; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0.f;
  const float* arow = a + (r0 + g) * st + t;
  stage_slice(slices, w, h, lay, 0, col0, tid);
  for (int sl = 0; sl < n_slices; ++sl) {
    cp_async_wait_all();
    bar_sync(kBarConsumers, kThreads);  // slice sl is whole; slice sl - 1 is read
    if (sl + 1 < n_slices)
      stage_slice(slices + ((sl + 1) & 1) * KS * ss, w, h, lay, (sl + 1) * KS, col0, tid);
    if (!active) continue;
    const float* bs = slices + (sl & 1) * KS * ss + t * ss + (n0 - col0) + g;
#pragma unroll
    for (int kk = 0; kk < KS; kk += 8) {  // a whole number of steps: no branch between the mma
      const int k0 = sl * KS + kk;
      uint32_t a_hi[kMt][4], a_lo[kMt][4];
      Tf32 b0[kNt], b1[kNt];
#pragma unroll
      for (int mt = 0; mt < kMt; ++mt) {
        const float* ar = arow + 16 * mt * st + k0;
        const float v[4] = {ar[0], ar[8 * st], ar[4], ar[8 * st + 4]};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const Tf32 x = split_tf32(v[i]);
          a_hi[mt][i] = x.hi;
          a_lo[mt][i] = x.lo;
        }
      }
#pragma unroll
      for (int nt = 0; nt < kNt; ++nt) {
        b0[nt] = split_tf32(bs[kk * ss + 8 * nt]);
        b1[nt] = split_tf32(bs[(kk + 4) * ss + 8 * nt]);
      }
      mma_3xtf32_tile(acc, a_hi, a_lo, b0, b1);
    }
  }
  bar_sync(kBarConsumers, kThreads);  // the slices are read: the next matmul stages into them
}

// One of the two local matmuls of the tile of `rows` rows from r0 of set b,
// with its epilogue: the first (SECOND false) reads the x tile and writes
// act(. + bias) into the x1 tile; the second reads the x1 tile and writes
// act(. + bias + x) to the output. Warp tiles of 16 rows by 8 NT columns, in
// rounds: every row block by kWarps / row_blocks column blocks. NT is 2 only
// for a tile of at most 32 rows (with the weights in shared memory): the 16
// warps then share its two row blocks in place of leaving half of them idle.
// Every consumer thread calls it.
template <bool WS, int KS, int NT, bool SECOND>
__device__ __forceinline__ void matmul_rounds(const Params& p, const Layout& lay, float* sm,
                                              const float* w, const float* bias, int b, int r0,
                                              int rows, int tid) {
  const int warp = tid / 32, lane = tid % 32, g = lane >> 2, t = lane & 3;
  const int h = p.h, hp = lay.hp, st = lay.st;
  constexpr int kCols = 8 * NT;
  const int row_blocks = NT == kNt ? lay.rows / kWarpRows : 2;
  const int cols_per_round = kWarps / row_blocks;
  const int rounds = (hp / kCols + cols_per_round - 1) / cols_per_round;
  const int rw = warp % row_blocks * kWarpRows;
  const float* a = sm + (SECOND ? lay.x1s : lay.xs);
  float* x1s = sm + lay.x1s;
  const float* x = p.x + ((size_t)b * p.n + r0) * h;
  float* xo = p.xo + ((size_t)b * p.n + r0) * h;
  for (int round = 0; round < rounds; ++round) {
    const int col0 = round * cols_per_round * kCols;
    const int n0 = col0 + warp / row_blocks * kCols;
    const bool active = n0 < hp && rw < rows;  // warp-uniform
    // the residual, read before the matmul so that its latency hides behind it
    float res[kMt][NT][4];
    if (SECOND) {
#pragma unroll
      for (int mt = 0; mt < kMt; ++mt)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int row = rw + 16 * mt + g + 8 * (i >> 1);
            const int col = n0 + 8 * nt + 2 * t + (i & 1);
            res[mt][nt][i] = active && row < rows && col < h ? __ldg(x + (size_t)row * h + col)
                                                            : 0.f;
          }
    }
    float acc[kMt][NT][4];
    if constexpr (WS) {
      if (!active) continue;
      warp_matmul<NT>(a, w, hp, st, rw, n0, acc);
    } else {
      sliced_matmul<KS>(a, w, sm + lay.w, h, lay, col0, rw, n0, active, tid, acc);
      if (!active) continue;
    }
#pragma unroll
    for (int mt = 0; mt < kMt; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int row = rw + 16 * mt + g + 8 * (i >> 1);
          const int col = n0 + 8 * nt + 2 * t + (i & 1);
          if (!SECOND)
            x1s[row * st + col] = col < h ? act(acc[mt][nt][i] + bias[col]) : 0.f;
          else if (row < rows && col < h)
            xo[(size_t)row * h + col] = act(acc[mt][nt][i] + bias[col] + res[mt][nt][i]);
        }
  }
}

// Consumers: the local path of set b, tile by tile, with the biases of
// `slot`; the set's first tile is already being copied into the x tile.
// `next`: the set whose first tile follows this set's last (-1: none).
template <bool WS, int KS>
__device__ __forceinline__ void consume_set(const Params& p, const Layout& lay, float* sm,
                                            const float* w1, const float* w2,
                                            const float* slot, int b, int next, int tid) {
  const int n = p.n, hp = lay.hp;
  const float* bias1 = slot;
  const float* bias2 = slot + hp;
  for (int r0 = 0; r0 < n; r0 += lay.rows) {
    const int rows = min(lay.rows, n - r0);
    const bool narrow = rows <= 2 * kWarpRows && lay.rows > 2 * kWarpRows;
    cp_async_wait_all();
    bar_sync(kBarConsumers, kThreads);  // the x tile holds rows r0 ..; x1s is free
    if constexpr (WS) {
      if (narrow)
        matmul_rounds<true, KS, 2, false>(p, lay, sm, w1, bias1, b, r0, rows, tid);
      else
        matmul_rounds<true, KS, kNt, false>(p, lay, sm, w1, bias1, b, r0, rows, tid);
    } else {
      matmul_rounds<false, KS, kNt, false>(p, lay, sm, w1, bias1, b, r0, rows, tid);
    }
    bar_sync(kBarConsumers, kThreads);  // x1s is whole; the x tile is free

    if (r0 + lay.rows < n)
      stage_tile(p, lay, sm + lay.xs, b, r0 + lay.rows, tid);
    else if (next >= 0)
      stage_tile(p, lay, sm + lay.xs, next, 0, tid);

    if constexpr (WS) {
      if (narrow)
        matmul_rounds<true, KS, 2, true>(p, lay, sm, w2, bias2, b, r0, rows, tid);
      else
        matmul_rounds<true, KS, kNt, true>(p, lay, sm, w2, bias2, b, r0, rows, tid);
    } else {
      matmul_rounds<false, KS, kNt, true>(p, lay, sm, w2, bias2, b, r0, rows, tid);
    }
  }
}

// Persistent blocks: stage the local weights once (WS), then the producers and
// the consumers walk over the block's sets, handing the bias slots over.
template <bool WS, int KS>
__global__ void __launch_bounds__(kBlock, 1)
epic_layer_kernel(Params p, int n_sets, int tile_rows) {
  extern __shared__ __align__(16) float sm[];
  const Layout lay(p.h, p.l, p.tg, p.tl, p.cg, p.cl, WS, tile_rows, KS);
  const int h = p.h, hp = lay.hp, st = lay.st;
  const float* w1 = p.w1x;
  const float* w2 = p.w2x;
  if (WS) {  // transposed: ws[col * st + k] = w[k, col]
    float* ws = sm + lay.w;
    for (int i = threadIdx.x; i < hp * hp; i += kBlock) {
      const int k = i / hp, col = i - k * hp;
      const bool in = k < h && col < h;
      ws[col * st + k] = in ? __ldg(p.w1x + k * h + col) : 0.f;
      ws[hp * st + col * st + k] = in ? __ldg(p.w2x + k * h + col) : 0.f;
    }
    w1 = ws;
    w2 = ws + hp * st;
  }
  // zeros in the tiles' padded columns and in the bias slots
  for (int i = threadIdx.x; i < 2 * lay.rows * st; i += kBlock) sm[lay.xs + i] = 0.f;
  for (int i = threadIdx.x; i < 4 * hp; i += kBlock) sm[lay.bias + i] = 0.f;
  __syncthreads();

  // this block's sets: blockIdx.x + k * gridDim.x for k < nk (grid <= n_sets)
  const int nk = (n_sets - 1 - blockIdx.x) / gridDim.x + 1;
  if (threadIdx.x >= kThreads) {
    const int t = threadIdx.x - kThreads;
    for (int k = 0; k < nk; ++k) {
      const int s = k & 1;
      if (k >= 2) bar_sync(kBarEmpty + s, kBlock);  // the consumers are done with slot s
      produce_set(p, lay, sm, sm + lay.bias + 2 * hp * s, blockIdx.x + k * gridDim.x, t);
      bar_arrive(kBarFull + s, kBlock);
    }
  } else {
    stage_tile(p, lay, sm + lay.xs, blockIdx.x, 0, threadIdx.x);
    for (int k = 0; k < nk; ++k) {
      const int s = k & 1;
      bar_sync(kBarFull + s, kBlock);  // the producers have filled slot s
      const int b = blockIdx.x + k * gridDim.x;
      consume_set<WS, KS>(p, lay, sm, w1, w2, sm + lay.bias + 2 * hp * s, b,
                      k + 1 < nk ? b + gridDim.x : -1, threadIdx.x);
      if (k + 2 < nk) bar_arrive(kBarEmpty + s, kBlock);
    }
  }
}

// Launch, or with `report` launch nothing and put there what the launch
// would be: blocks, warps, rows of a tile, bytes of shared memory, registers
// per thread, TF32 products per float32 product, weights in shared memory.
template <bool WS, int KS>
cudaError_t launch(const Params& p, int b, const Layout& lay, cudaStream_t stream, int* report) {
  const auto kernel = epic_layer_kernel<WS, KS>;
  const size_t smem = lay.bytes();
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kBlock, smem);
  if (err != cudaSuccess) return err;
  const int grid = per_sm > 0 ? min(b, sms * per_sm) : b;
  if (report) {
    cudaFuncAttributes attr;
    if ((err = cudaFuncGetAttributes(&attr, kernel)) != cudaSuccess) return err;
    const int r[7] = {grid, kBlock / 32, lay.rows, (int)smem, attr.numRegs, kMmaProducts, WS};
    for (int i = 0; i < 7; ++i) report[i] = r[i];
    return cudaSuccess;
  }
  kernel<<<grid, kBlock, smem, stream>>>(p, b, lay.rows);
  return cudaGetLastError();
}

// The first layout that fits a block: the weights in shared memory with
// 64-row tiles, else 32-row tiles; then slices of the weights, 32 rows deep
// with 64-row tiles, 32-row tiles, then 16 rows deep.
cudaError_t launch_any(const Params& p, int b, cudaStream_t stream, int* report) {
  if (b <= 0 || p.n <= 0 || p.h <= 0 || p.h > kMaxWidth || p.l <= 0 || p.l > kMaxWidth)
    return cudaErrorInvalidValue;
  constexpr int kChoices[6][3] = {{1, 64, 0}, {1, 32, 0}, {0, 64, 32}, {0, 32, 32},
                                  {0, 64, 16}, {0, 32, 16}};  // weights in smem, rows, slice rows
  for (const auto& c : kChoices) {
    const Layout lay(p.h, p.l, p.tg, p.tl, p.cg, p.cl, c[0] != 0, c[1], c[2]);
    if (lay.bytes() > (size_t)kMaxSmem) continue;
    if (c[0]) return launch<true, 0>(p, b, lay, stream, report);
    return c[2] == 32 ? launch<false, 32>(p, b, lay, stream, report)
                      : launch<false, 16>(p, b, lay, stream, report);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// Returns the launch's cudaError_t (0 on success). Shapes were checked by
// the Python wrapper (particle_fm_tpu_torch/ops/epic_layer.py);
// 1 <= h <= 512, 1 <= l <= 512, cg and cl each 0 or the width of cond.
extern "C" int epic_layer_fwd_f32(
    const float* x, const float* g, const float* mask, const float* sfeat,
    const float* wg1, const float* bg1, const float* wg2, const float* bg2,
    const float* w1x, const float* w1s, const float* b1,
    const float* w2x, const float* w2s, const float* b2,
    float* xo, float* go,
    int b, int n, int h, int l, int s, int tg, int tl, int cg, int cl,
    float sum_scale, void* stream_ptr) {
  const Params p{x, g, mask, sfeat, wg1, bg1, wg2, bg2, w1x, w1s, b1, w2x, w2s, b2,
                 xo, go, n, h, l, s, tg, tl, cg, cl, sum_scale};
  return (int)launch_any(p, b, static_cast<cudaStream_t>(stream_ptr), nullptr);
}

// What the launcher gives the kernel for b sets of n particles at these
// widths, into `report` (7 ints, as `launch` writes them). Launches nothing.
extern "C" int epic_layer_geometry(int b, int n, int h, int l, int s, int tg, int tl, int cg,
                                   int cl, int* report) {
  Params p{};
  p.n = n; p.h = h; p.l = l; p.s = s; p.tg = tg; p.tl = tl; p.cg = cg; p.cl = cl;
  return (int)launch_any(p, b, nullptr, report);
}

extern "C" const char* epic_layer_mma_instruction() { return MMA_TF32_INSTRUCTION; }

// ---------------------------------------------------------------------------
// bfloat16: epic_layer_fwd_bf16
// ---------------------------------------------------------------------------
//
// The bfloat16 instantiation of the same TPU kernel: x, g, the per-set
// features, the weights and the biases in bfloat16, the mask in float32, every
// product accumulated in float32, and the Pallas kernel's four roundings
// (particle_fm_tpu/ops/pallas/epic_layer.py:57-106): the pool, the global MLPs
// and the per-set biases in float32 on the bfloat16 values, g1 rounded before
// the second global MLP, g_new rounded (the output, and the input of bias1),
// x1 = act(x . w1x + bias1) rounded before the second local product, and the
// output act(x1 . w2x + bias2 + x) rounded once. Both local products run as
// bfloat16 products on wgmma (wgmma_bf16.cuh), exact as the Pallas kernel's
// bfloat16 `jnp.dot` with float32 accumulation is; the plain version
// (ops/epic_layer.py::epic_layer_reference) computes the same function.
//
// Bound on an H100 SXM: at the flagship (B=640, N=150, H=128) the two local
// products are 6.29 GFLOP, 6.4 us at 989 TFLOP/s, and x in and out 49 MB, 15
// us at 3.35 TB/s: bound by bytes. At jetclass_cond (path E: B=512, N=128,
// H=300) the products are 23.6 GFLOP, 24 us, and x in and out 79 MB, 23 us:
// bound by tensor operations, about 29 us with the per-set products.
//
// Design: three kernels, one after the other on the stream, and float32
// scratch of B (3H + 1) values between them (the wrapper allocates it). The
// kernels read the weights from an image laid out once where the layer's
// weights are folded (ImageLayout; ops/epic_layer.py::bf16_weight_image,
// nets/epic.py): every chunk or slice a block stages is one contiguous copy
// in 16-byte pieces, whatever H (rows of 600 bytes at H = 300 are 8-byte
// aligned only).
//   * epic_pool_bf16_kernel, a block a set: the masked sums and the count,
//     16-byte pieces of the rows (8 where H = 300), 8 pieces a thread issued
//     before the first is used, the row threads' sums meeting in shared
//     memory.
//   * epic_sets_bf16_kernel, a block for every kSetsPerBlock sets: the two
//     global MLPs and the two per-set biases on the tensor cores
//     (mma.sync.m16n8k16, the sets the rows of A). Their input is float32 (the
//     pooled mean and sum promote it), so it is split into three bfloat16
//     pieces whose sum is the input exactly; each piece's product with the
//     bfloat16 weight is exact in float32, so three products compute the
//     float32 product on the bfloat16 weights. The weights come through
//     shared memory in chunks of whole k16 steps (cp.async, two chunks ahead,
//     rows padded in the image to 16 bytes plus 16, read by ldmatrix without
//     bank conflicts),
//     each block from its own chunk on, so that the blocks do not all read one
//     chunk from L2 at once. g_new goes out, the biases (B, 2, H) to scratch.
//   * the local products on wgmma.mma_async.m64nNk16 (wgmma_bf16.cuh), B (a
//     weight, read as it lies: (in, out) is MN-major for B) from shared memory
//     in core matrices without swizzle, cut into slices of 32 rows of k by a
//     column block of N columns (H padded to 16: 128 at the flagship, 2
//     blocks of 152 at H = 300), the accumulator 64 x N in registers; the
//     slices lie in the weight image one after another, already in core
//     matrices.
//     Persistent blocks, one an SM, of two warpgroups, each on 64-row tiles of
//     the B*N rows (a tile may span sets; where N >= 64 a tile's rows are of
//     two sets at most, whose biases are staged in shared memory with the
//     tile, else each row reads its own from global memory).
//       - H <= 128, epic_local_regs_kernel: both weights staged once per
//         block (64 KB at the flagship); x staged row-major in shared memory,
//         the next tile's while this one is computed, and read into registers
//         as the A fragments of product 1 (ldmatrix), which also give the
//         residual; x1 = act(. + bias1) rounded straight from the accumulators
//         into the A fragments of product 2 (wgmma with A from registers): x1
//         never leaves the registers. The output is stored from the
//         accumulators.
//       - wider layers, epic_local_bf16_kernel: x and x1 tiles in shared
//         memory (core matrices, x in 8-byte cp.async pieces where its rows
//         are only 8-byte aligned: H = 300), the weights streamed through a ring of
//         kRing slices, kRing - 2 ahead, the warpgroups' tiles (128 rows)
//         taking each slice together (one barrier a slice), each block from
//         its own k slice on; x1 stays in shared memory between the products,
//         the residual x is read from global memory (L2). One warpgroup where
//         two would not fit (H above 400).
//     Padded rows and columns stay finite: x is zero past row m and column
//     h, the weights zero past h, so x1 and the output are 0 past column h
//     (the k of product 2), and a row past m (any finite value) is never
//     stored.
// Measured (NVIDIA H100 80GB HBM3, 700 W; PERF.md has the numbers and the
// variants tried, scripts/bf16_kernel_variants.py): the flagship layer takes
// some 0.09 ms and path E's 0.30, six and eleven times their bounds. The
// three kernels' launches, the pool reading x a second time, the per-set
// kernel's weight chunks and at H = 300 the block barrier of every slice
// are what remains.

#include "wgmma_bf16.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kSetThreads = 256;          // threads of a block of the per-set kernel
constexpr int kSetWarps = kSetThreads / 32;
constexpr int kSetsPerBlock = 4;          // sets of a per-set block, at most (rows of A: 16)
constexpr int kPoolUnroll = 8;            // pool pieces a thread has in flight
constexpr int kChunkBytes = 24576;        // bytes of a staged chunk of a per-set weight
constexpr int kChunkStages = 3;           // chunks staged at once, kChunkStages - 1 ahead
constexpr int kDotTiles = 8;              // n8 tiles of a per-set dot a warp holds at most
constexpr int kMaxWg = 2;                 // warpgroups of a local block
constexpr int kTileRows = 64;             // rows of a warpgroup's tile
constexpr int kSliceK = 32;               // k of a weight slice: two wgmmas
constexpr int kRing = 6;                  // slots of the streamed weights

struct ParamsBf16 {
  const bf16* x;       // (B, N, H)
  const bf16* g;       // (B, L)
  const float* mask;   // (B, N)
  const bf16* sfeat;   // (B, S): [t_emb, cond]
  const bf16* wg1; const bf16* bg1;  // (tg+2H+L+cg, H), (H)
  const bf16* wg2; const bf16* bg2;  // (tg+H+cg, L), (L)
  const bf16* w1x; const bf16* w1s; const bf16* b1;  // (H, H), (tl+L+cl, H), (H)
  const bf16* w2x; const bf16* w2s; const bf16* b2;  // (H, H), (tl+cl, H), (H)
  bf16* xo;            // (B, N, H)
  bf16* go;            // (B, L)
  float* bias;         // scratch: the biases (B, 2, H), then the pooled sums (B, H), counts (B)
  const bf16* wsl;     // the weight image (ImageLayout; ops/epic_layer.py::
                       // bf16_weight_image, laid out once where the weights are folded)
  int b, n, h, l, s, tg, tl, cg, cl;
  float sum_scale;
};

__device__ __forceinline__ float bf(const bf16* p, long long i) { return __bfloat162float(p[i]); }

// The widest piece, in bfloat16 values (8, 4, 2 or 1), that rows of h values
// starting at `src` allow.
__host__ __device__ __forceinline__ int piece_of(const void* src, int h) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(src);
  if (h % 8 == 0 && a % 16 == 0) return 8;
  if (h % 4 == 0 && a % 8 == 0) return 4;
  if (h % 2 == 0 && a % 4 == 0) return 2;
  return 1;
}

// `bytes` (16, 8 or 4) from src to shared memory, zeros where not `valid`
__device__ __forceinline__ void cp_async_piece(void* dst, const void* src, int bytes, int valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int n = valid ? bytes : 0;
  if (bytes == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(d), "l"(src), "r"(n)
                 : "memory");
  else if (bytes == 8)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;" ::"r"(d), "l"(src), "r"(n)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(d), "l"(src), "r"(n)
                 : "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}
// cp.async.wait_group with a count known at run time (0 .. kRing - 2)
__device__ __forceinline__ void cp_async_wait_n(int n) {
  switch (n) {
    case 0: cp_async_wait<0>(); break;
    case 1: cp_async_wait<1>(); break;
    case 2: cp_async_wait<2>(); break;
    case 3: cp_async_wait<3>(); break;
    case 4: cp_async_wait<4>(); break;
    default: cp_async_wait<5>(); break;
  }
}

// ------------------------------------------------------------ per-set kernel

// A per-set dot of k rows and m output columns: the row distance of its
// staged chunks of weight rows and of its results (m rounded up to 16, plus
// 8: 16-byte rows that ldmatrix reads without bank conflicts), the rows of a
// chunk (whole steps of 16), k rounded up to 16, the n8 tiles.
struct DotGeo {
  int ld, rows, kp, tiles;
  __host__ __device__ DotGeo(int m, int k) {
    ld = ((m + 15) & ~15) + 8;
    kp = (k + 15) & ~15;
    rows = (kChunkBytes / (2 * ld)) & ~15;
    if (rows > kp) rows = kp;
    tiles = (m + 7) / 8;
  }
};

// The parts of the weight image (ops/epic_layer.py::bf16_weight_image, laid
// out once where the weights are folded), offsets in bfloat16 values: the
// four per-set weights, each kp rows (zeros past k) at a row distance ld
// (DotGeo: rows on 16 bytes), so that a chunk of rows is one contiguous
// copy; then w1x and w2x as the local kernels' slices.
struct ImageLayout {
  size_t wg1, wg2, w1s, w2s, local;
  __host__ __device__ explicit ImageLayout(const ParamsBf16& p) {
    const int k1 = p.tg + 2 * p.h + p.l + p.cg, k2 = p.tg + p.h + p.cg;
    const int k3 = p.tl + p.l + p.cl, k4 = p.tl + p.cl;
    const DotGeo g1(p.h, k1), g2(p.l, k2), g3(p.h, k3), g4(p.h, k4);
    wg1 = 0;
    wg2 = wg1 + (size_t)g1.kp * g1.ld;
    w1s = wg2 + (size_t)g2.kp * g2.ld;
    w2s = w1s + (size_t)g3.kp * g3.ld;
    local = w2s + (size_t)g4.kp * g4.ld;
  }
};

// The per-set kernel's shared memory, in floats from its base: the inputs of
// the four dots (sets x k1, k2, k3, k4), the dots' results (sets x the
// widest DotGeo ld), then in bfloat16 the split inputs (3 pieces x (sets + 1)
// rows, the last one zeros for the rows of A past the sets, x the largest kp
// + 8) and the weight chunks.
struct SetsLayout {
  int k1, k2, k3, k4, kmax, in2, s1, s2, res, apc_floats, floats;
  __host__ __device__ SetsLayout(const ParamsBf16& p, int sets) {
    k1 = p.tg + 2 * p.h + p.l + p.cg;
    k2 = p.tg + p.h + p.cg;
    k3 = p.tl + p.l + p.cl;
    k4 = p.tl + p.cl;
    kmax = k1 > k2 ? k1 : k2;
    kmax = kmax > k3 ? kmax : k3;
    kmax = (kmax + 15) & ~15;
    in2 = sets * k1;
    s1 = in2 + sets * k2;
    s2 = s1 + sets * k3;
    res = (s2 + sets * k4 + 3) & ~3;
    const int wide = DotGeo(p.h > p.l ? p.h : p.l, 1).ld;
    apc_floats = 3 * (sets + 1) * (kmax + 8) / 2;
    floats = (res + sets * wide + 3) & ~3;
  }
  __host__ __device__ size_t bytes() const {
    return sizeof(float) * ((size_t)floats + apc_floats) + (size_t)kChunkStages * kChunkBytes;
  }
};

// Sets a block of the per-set kernel: kSetsPerBlock where its shared memory
// allows, else 2, 1. (Up to 16, the rows of one mma tile, would read each
// weight from L2 for more sets at once; 4 measured faster: more blocks share
// the work, PERF.md.)
inline int sets_per_block(const ParamsBf16& p) {
  int sets = kSetsPerBlock;
  while (sets > 1 && SetsLayout(p, sets).bytes() > (size_t)kMaxSmem) sets /= 2;
  return sets;
}

// P bfloat16 values of a row (P = 8, 4, 2, 1; the address aligned to them),
// as loaded: a volatile asm, so that the compiler issues every load of a
// batch before the first is used.
template <int P>
struct Raw;
template <> struct Raw<8> { uint32_t w[4]; };
template <> struct Raw<4> { uint32_t w[2]; };
template <> struct Raw<2> { uint32_t w[1]; };
template <> struct Raw<1> { uint32_t w[1]; };

template <int P>
__device__ __forceinline__ Raw<P> load_raw(const bf16* p) {
  Raw<P> r;
  if constexpr (P == 8)
    asm volatile("ld.global.nc.v4.u32 {%0, %1, %2, %3}, [%4];"
                 : "=r"(r.w[0]), "=r"(r.w[1]), "=r"(r.w[2]), "=r"(r.w[3]) : "l"(p));
  else if constexpr (P == 4)
    asm volatile("ld.global.nc.v2.u32 {%0, %1}, [%2];" : "=r"(r.w[0]), "=r"(r.w[1]) : "l"(p));
  else if constexpr (P == 2)
    asm volatile("ld.global.nc.u32 %0, [%1];" : "=r"(r.w[0]) : "l"(p));
  else
    asm volatile("ld.global.nc.u16 %0, [%1];" : "=r"(r.w[0]) : "l"(p));
  return r;
}

// Value i of a raw piece as a float.
template <int P>
__device__ __forceinline__ float raw_at(const Raw<P>& r, int i) {
  if constexpr (P == 1) return __uint_as_float(r.w[0] << 16);
  return __uint_as_float(i % 2 ? r.w[i / 2] & 0xffff0000u : r.w[i / 2] << 16);
}

// The masked sums of set blockIdx.x, in float32 on the bfloat16 values:
// pool[set][c] = sum over the rows of mask * x, pool_count[set] = sum of the
// mask. Thread t takes piece t % q (P values) of every (256 / q)-th row,
// kPoolUnroll rows in flight; the row threads' sums meet in shared memory.
template <int P>
__device__ __forceinline__ void pool_set(const ParamsBf16& p, float* pool, float* part) {
  const int set = blockIdx.x, n = p.n, h = p.h, q = h / P;
  const bf16* x = p.x + (size_t)set * n * h;
  const float* mask = p.mask + (size_t)set * n;
  for (int c0 = 0; c0 < q; c0 += kSetThreads) {
    const int qc = min(kSetThreads, q - c0), rt_n = kSetThreads / qc;
    const int c = c0 + threadIdx.x % qc, rt = threadIdx.x / qc;
    float acc[P];
#pragma unroll
    for (int i = 0; i < P; ++i) acc[i] = 0.f;
    if (rt < rt_n) {
      for (int r0 = rt; r0 < n; r0 += kPoolUnroll * rt_n) {
        Raw<P> v[kPoolUnroll];
        float mv[kPoolUnroll];
#pragma unroll
        for (int u = 0; u < kPoolUnroll; ++u) {
          const int r = min(r0 + u * rt_n, n - 1);
          v[u] = load_raw<P>(x + (size_t)r * h + c * P);
          mv[u] = r0 + u * rt_n < n ? mask[r] : 0.f;
        }
#pragma unroll
        for (int u = 0; u < kPoolUnroll; ++u)
#pragma unroll
          for (int i = 0; i < P; ++i) acc[i] = fmaf(raw_at<P>(v[u], i), mv[u], acc[i]);
      }
#pragma unroll
      for (int i = 0; i < P; ++i) part[rt * qc * P + (c - c0) * P + i] = acc[i];
    }
    __syncthreads();
    for (int e = threadIdx.x; e < qc * P; e += kSetThreads) {
      float sum = 0.f;
      for (int r = 0; r < rt_n; ++r) sum += part[r * qc * P + e];
      pool[(size_t)set * h + c0 * P + e] = sum;
    }
    __syncthreads();
  }
}

// The first kernel: the masked pool of one set a block.
__global__ void __launch_bounds__(kSetThreads) epic_pool_bf16_kernel(ParamsBf16 p, float* pool,
                                                                     float* count) {
  __shared__ float part[kSetThreads * 8];
  if (threadIdx.x < 32) {
    float c = 0.f;
    for (int r = threadIdx.x; r < p.n; r += 32) c += p.mask[(size_t)blockIdx.x * p.n + r];
    for (int off = 16; off > 0; off >>= 1) c += __shfl_xor_sync(0xffffffffu, c, off);
    if (threadIdx.x == 0) count[blockIdx.x] = c;
  }
  switch (piece_of(p.x, p.h)) {
    case 8: pool_set<8>(p, pool, part); break;
    case 4: pool_set<4>(p, pool, part); break;
    case 2: pool_set<2>(p, pool, part); break;
    default: pool_set<1>(p, pool, part); break;
  }
}

__device__ __forceinline__ void ldmatrix_x2_trans(uint32_t (&r)[2], const bf16* row) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(row));
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];"
               : "=r"(r[0]), "=r"(r[1]) : "r"(a));
}

// epi(s, j, dot(in[s][0:k], w[:, j])) for the block's sets s < ns <= sets and
// j < m (w bfloat16, k rows padded with zeros to DotGeo's kp at its row
// distance ld, as in the weight image; in[s], float32, at in + s * in_ld), on
// the tensor cores: the float32 inputs are split into three bfloat16 pieces,
// hi + mid + lo, whose sum is the input exactly, and each piece's product with
// the bfloat16 weight is exact in float32 (mma.sync.m16n8k16, the sets the
// rows of A). The weight rows come through shared memory
// in chunks (`wbuf`, kChunkStages of DotGeo(m, k).rows rows), with cp.async,
// kChunkStages - 1 chunks ahead of their use, each block from its own chunk
// on so that the blocks do not all read one chunk from L2 at once. Warp w
// takes the n8 tiles w, w + 8, ...
template <class Epi>
__device__ __forceinline__ void sets_dot(const float* in, int in_ld, const bf16* __restrict__ w,
                                         int k, int m, int sets, int ns, bf16* apc, float* res,
                                         bf16* wbuf, Epi epi) {
  const DotGeo geo(m, k);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane >> 2, t = lane & 3;
  const int as = geo.kp + 8, ar = sets + 1;  // row distance of a piece, rows of a piece
  for (int e = threadIdx.x; e < ar * geo.kp; e += kSetThreads) {
    const int r = e / geo.kp, c = e - r * geo.kp;
    const float x = r < ns && c < k ? in[r * in_ld + c] : 0.f;
    const bf16 hi = __float2bfloat16_rn(x);
    const float r1 = x - __bfloat162float(hi);
    const bf16 mid = __float2bfloat16_rn(r1);
    apc[r * as + c] = hi;
    apc[(ar + r) * as + c] = mid;
    apc[(2 * ar + r) * as + c] = __float2bfloat16_rn(r1 - __bfloat162float(mid));
  }
  const int arow = min(lane & 15, sets);  // rows of A past the sets read the zero row
  const int chunks = geo.kp > 0 ? (geo.kp + geo.rows - 1) / geo.rows : 0;  // k may be 0
  const int slot = geo.rows * geo.ld, rot = chunks > 0 ? blockIdx.x % chunks : 0;
  auto first_row = [&](int c) { return (c + rot) % chunks * geo.rows; };
  auto stage = [&](int c) {  // rows r0 .. of the image, one contiguous copy
    const int r0 = first_row(c), n16 = min(geo.rows, geo.kp - r0) * geo.ld / 8;
    const bf16* src = w + (size_t)r0 * geo.ld;
    bf16* dst = wbuf + (c % kChunkStages) * slot;
    for (int i = threadIdx.x; i < n16; i += blockDim.x)
      cp_async_piece(dst + 8 * i, src + 8 * i, 16, 1);
  };
  float acc[kDotTiles][4];
#pragma unroll
  for (int i = 0; i < kDotTiles; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
  for (int c = 0; c < kChunkStages - 1; ++c) {
    if (c < chunks) stage(c);
    cp_async_commit();
  }
  for (int c = 0; c < chunks; ++c) {
    cp_async_wait<kChunkStages - 2>();  // chunk c is in
    __syncthreads();  // ... for every thread; chunk c - 1 is used; the pieces are written
    if (c + kChunkStages - 1 < chunks) stage(c + kChunkStages - 1);
    cp_async_commit();
    const bf16* wb = wbuf + (c % kChunkStages) * slot;
    const int k0 = first_row(c), nr = min(geo.rows, geo.kp - k0);
    for (int kk = 0; kk < nr; kk += 16) {
      uint32_t a[3][4];
#pragma unroll
      for (int q = 0; q < 3; ++q)
        ldmatrix_x4(a[q], apc + (ar * q + arow) * as + k0 + kk + 8 * (lane >> 4));
#pragma unroll
      for (int i = 0; i < kDotTiles; ++i) {
        const int nt = warp + kSetWarps * i;
        if (nt >= geo.tiles) break;
        uint32_t b[2];
        ldmatrix_x2_trans(b, wb + (kk + (lane & 15)) * geo.ld + 8 * nt);
        mma_bf16(acc[i], a[2], b[0], b[1]);  // the small pieces first
        mma_bf16(acc[i], a[1], b[0], b[1]);
        mma_bf16(acc[i], a[0], b[0], b[1]);
      }
    }
  }
  cp_async_wait<0>();
#pragma unroll
  for (int i = 0; i < kDotTiles; ++i) {
    const int nt = warp + kSetWarps * i;
    if (nt >= geo.tiles) break;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = g + 8 * half;
      if (r < ns) {
        res[r * geo.ld + 8 * nt + 2 * t] = acc[i][2 * half];
        res[r * geo.ld + 8 * nt + 2 * t + 1] = acc[i][2 * half + 1];
      }
    }
  }
  __syncthreads();
  for (int e = threadIdx.x; e < ns * m; e += kSetThreads) {
    const int s = e / m, j = e % m;
    epi(s, j, res[s * geo.ld + j]);
  }
  __syncthreads();  // the outputs are written; the buffers are reused next
}

// The second kernel: the per-set part of sets blockIdx.x * sets ... (at most
// `sets`) from their pooled sums and counts.
__global__ void __launch_bounds__(kSetThreads) epic_sets_bf16_kernel(ParamsBf16 p, int sets,
                                                                     const float* pool,
                                                                     const float* count) {
  extern __shared__ float fsm[];
  const int tid = threadIdx.x;
  const int b0 = blockIdx.x * sets, ns = min(sets, p.b - b0);
  const int h = p.h, l = p.l, tg = p.tg, tl = p.tl, s_w = p.s;
  const SetsLayout lay(p, sets);
  const int k1 = lay.k1, k2 = lay.k2, k3 = lay.k3, k4 = lay.k4;
  float* gin = fsm;              // sets x k1: cat(t_g, mean, scaled_sum, g, cond_g)
  float* in2 = fsm + lay.in2;    // sets x k2: cat(t_g, g1, cond_g)
  float* s1 = fsm + lay.s1;      // sets x k3: cat(t_l, g_new, cond_l)
  float* s2 = fsm + lay.s2;      // sets x k4: cat(t_l, cond_l)
  float* res = fsm + lay.res;    // the dots' results
  bf16* apc = reinterpret_cast<bf16*>(fsm + lay.floats);                    // the split inputs
  bf16* wbuf = reinterpret_cast<bf16*>(fsm + lay.floats + lay.apc_floats);  // weight chunks
  for (int e = tid; e < ns * s_w; e += kSetThreads) {
    const int s = e / s_w, i = e % s_w;
    const float v = bf(p.sfeat, (long long)(b0 + s) * s_w + i);
    if (i < tg) gin[s * k1 + i] = in2[s * k2 + i] = v;
    if (i < tl) s1[s * k3 + i] = s2[s * k4 + i] = v;
    const int ig = i - (s_w - p.cg), il = i - (s_w - p.cl);
    if (ig >= 0) gin[s * k1 + tg + 2 * h + l + ig] = in2[s * k2 + tg + h + ig] = v;
    if (il >= 0) s1[s * k3 + tl + l + il] = s2[s * k4 + tl + il] = v;
  }
  for (int e = tid; e < ns * l; e += kSetThreads) {
    const int s = e / l, i = e % l;
    gin[s * k1 + tg + 2 * h + i] = bf(p.g, (long long)(b0 + s) * l + i);
  }
  for (int e = tid; e < ns * h; e += kSetThreads) {
    const int s = e / h, c = e % h;
    const float sum = pool[(size_t)(b0 + s) * h + c];
    gin[s * k1 + tg + c] = sum / count[b0 + s];
    gin[s * k1 + tg + h + c] = sum * p.sum_scale;
  }
  __syncthreads();

  const ImageLayout img(p);
  // global MLP 1; g1 rounded to bfloat16 as the second MLP's input
  sets_dot(gin, k1, p.wsl + img.wg1, k1, h, sets, ns, apc, res, wbuf, [&](int s, int j, float v) {
    in2[s * k2 + tg + j] = round_bf16(act(v + bf(p.bg1, j)));
  });
  // global MLP 2 with the residual g; g_new rounded once
  sets_dot(in2, k2, p.wsl + img.wg2, k2, l, sets, ns, apc, res, wbuf, [&](int s, int j, float v) {
    const long long gi = (long long)(b0 + s) * l + j;
    const bf16 gn = __float2bfloat16_rn(act(v + bf(p.bg2, j) + bf(p.g, gi)));
    p.go[gi] = gn;
    s1[s * k3 + tl + j] = __bfloat162float(gn);
  });
  // the per-set biases of the two local products, float32
  sets_dot(s1, k3, p.wsl + img.w1s, k3, h, sets, ns, apc, res, wbuf, [&](int s, int j, float v) {
    p.bias[(long long)(b0 + s) * 2 * h + j] = v + bf(p.b1, j);
  });
  sets_dot(s2, k4, p.wsl + img.w2s, k4, h, sets, ns, apc, res, wbuf, [&](int s, int j, float v) {
    p.bias[(long long)(b0 + s) * 2 * h + h + j] = v + bf(p.b2, j);
  });
}

size_t sets_smem_bytes(const ParamsBf16& p, int sets) { return SetsLayout(p, sets).bytes(); }

// ---------------------------------------------------------------- local kernel

// The local kernel's geometry at one width, the same on host and device.
// Where H <= 128 (`regs`) the x and x1 tiles live in registers (x staged in
// shared memory first, row-major) and both weights stay staged; wider layers
// stage x and x1 tiles in shared memory in core matrices and stream the
// weights.
struct LocalGeo {
  int hp;       // H rounded up to 16
  bool regs;    // the register kernel: hp <= 128
  int kp;       // k of the products: H rounded up to 32, or to the column block
  int nb;       // columns of an accumulator: one wgmma's N
  int ncb;      // column blocks, nb * ncb >= hp
  int tc;       // columns of an x or x1 tile in shared memory (regs: an x tile's row distance)
  int nks;      // k slices (32 rows of a weight) of a column block
  int slices;   // slices of the two weights
  int wgs;      // warpgroups of a block: 2, or 1 where two would not fit
  int slots;    // staged slices: all of them (regs), or kRing
  int bias_bufs;  // bias buffers of a warpgroup: 2 (the next tile's staged meanwhile) or 1
  __host__ __device__ explicit LocalGeo(int h) {
    hp = (h + 15) & ~15;
    regs = hp <= 128;
    nb = hp <= 64 ? 64 : (hp <= 128 || (hp > 152 && hp <= 256) || hp > 304) ? 128 : 152;
    ncb = (hp + nb - 1) / nb;
    kp = regs ? nb : (h + 31) & ~31;
    tc = regs ? nb + 8 : (kp > ncb * nb ? kp : ncb * nb);
    nks = kp / kSliceK;
    slices = 2 * ncb * nks;
    wgs = 2;
    slots = regs ? slices : kRing;
    bias_bufs = regs ? 2 : 1;
    if (bytes() > (size_t)kMaxSmem) wgs = 1;
  }
  __host__ __device__ size_t slice_bytes() const { return (size_t)kSliceK * nb * sizeof(bf16); }
  __host__ __device__ size_t tile_bytes() const { return (size_t)kTileRows * tc * sizeof(bf16); }
  // the biases (bias1, bias2) of two sets, the most a warpgroup's tile spans
  // where N >= 64
  __host__ __device__ size_t bias_bytes() const {
    return (size_t)2 * 2 * ncb * nb * sizeof(float);
  }
  // a warpgroup's tiles (regs: two x tiles; else the x and the x1 tile) and
  // biases, for every warpgroup
  __host__ __device__ size_t tiles_bytes() const {
    return wgs * (2 * tile_bytes() + bias_bufs * bias_bytes());
  }
  __host__ __device__ size_t bytes() const { return tiles_bytes() + slots * slice_bytes(); }
  // rows the block's warpgroups take at a time
  __host__ __device__ int unit_rows() const { return wgs * kTileRows; }
};

// A (rows x cols) block of a row-major bfloat16 matrix (row distance ld) into
// core matrices at `dst`: core matrix (r / 8, c / 8) at ((c / 8) (rows / 8) +
// r / 8) 128 bytes, row r % 8 of it 16 bytes at (r % 8) 16. Rows from
// `rows_in` and columns from `cols_in` on are zeros. Eight neighbouring
// threads fill one core matrix (128 contiguous bytes of shared memory), the
// next eight the next 8 columns of the same rows. cp.async in pieces of
// `piece` values (8, 4, 2), or element by element (1); by threads `tid` of
// `nthreads`.
template <int P>
__device__ __forceinline__ void stage_core_p(bf16* dst, const bf16* src, int ld, int rows,
                                             int cols, int rows_in, int cols_in, int tid,
                                             int nthreads) {
  // thread tid takes row r % 8 = tid % 8 of the core matrices tid / 8, tid / 8
  // + nthreads / 8, ... (column groups fastest), walked without a division
  const int cgs = cols / 8, rgs = rows / 8, step = nthreads >> 3;
  const int dq = step / cgs, dr = step % cgs, ri = tid & 7;
  int cg = (tid >> 3) % cgs, rg = (tid >> 3) / cgs;
  for (; rg < rgs; cg += dr, rg += dq) {
    if (cg >= cgs) {
      cg -= cgs;
      ++rg;
      if (rg >= rgs) break;
    }
    const int r = 8 * rg + ri, c = 8 * cg;
    bf16* d = dst + ((cg * rgs + rg) * 64 + ri * 8);
    const bf16* s = src + (r < rows_in ? (long long)r * ld : 0);
    if constexpr (P == 1) {  // odd widths: element by element
      uint32_t e[8];
#pragma unroll
      for (int k = 0; k < 8; ++k)
        e[k] = r < rows_in && c + k < cols_in ? __bfloat16_as_ushort(s[c + k]) : 0u;
      *reinterpret_cast<uint4*>(d) = make_uint4(e[0] | (e[1] << 16), e[2] | (e[3] << 16),
                                                e[4] | (e[5] << 16), e[6] | (e[7] << 16));
    } else {
#pragma unroll
      for (int k = 0; k < 8; k += P) {
        const int ok = r < rows_in && c + k < cols_in;
        cp_async_piece(d + k, ok ? s + c + k : src, 2 * P, ok);
      }
    }
  }
}

__device__ __forceinline__ void stage_core(bf16* dst, const bf16* src, int ld, int rows, int cols,
                                           int rows_in, int cols_in, int piece, int tid,
                                           int nthreads) {
  switch (piece) {
    case 8: stage_core_p<8>(dst, src, ld, rows, cols, rows_in, cols_in, tid, nthreads); break;
    case 4: stage_core_p<4>(dst, src, ld, rows, cols, rows_in, cols_in, tid, nthreads); break;
    case 2: stage_core_p<2>(dst, src, ld, rows, cols, rows_in, cols_in, tid, nthreads); break;
    default: stage_core_p<1>(dst, src, ld, rows, cols, rows_in, cols_in, tid, nthreads); break;
  }
}

// Slice j of the two weights (product j / (ncb nks), column block, k slice
// (j + rot) % nks) into `dst`: 32 rows of k by nb columns, as B (k rows, n
// columns), in core matrices. The slices lie in the weight image already in
// that layout, one after another: a contiguous copy in 16-byte pieces.
__device__ __forceinline__ void stage_slice(bf16* dst, const ParamsBf16& p, const LocalGeo& geo,
                                            int j, int rot, int tid, int nthreads) {
  const int slice = kSliceK * geo.nb, ks = (j % geo.nks + rot) % geo.nks;
  const bf16* src = p.wsl + ImageLayout(p).local + (size_t)(j - j % geo.nks + ks) * slice;
  for (int i = tid; i < slice / 8; i += nthreads) cp_async_piece(dst + 8 * i, src + 8 * i, 16, 1);
}

// Rows row0 .. row0 + 63 of x into a tile (tc columns, zeros from h on).
__device__ __forceinline__ void stage_x(bf16* dst, const ParamsBf16& p, const LocalGeo& geo,
                                        int row0, int piece, int tid, int nthreads) {
  const int m = p.b * p.n;
  stage_core(dst, p.x + (long long)(row0 < m ? row0 : 0) * p.h, p.h, kTileRows, geo.tc, m - row0,
             p.h, piece, tid, nthreads);
}

// Element (r, c) of a 64-row tile in core matrices.
__device__ __forceinline__ int tile_at(int r, int c) {
  return ((c / 8) * (kTileRows / 8) + r / 8) * 64 + (r % 8) * 8 + c % 8;
}

// wgmma descriptors: a 64-row tile at k step ks16 (LBO along k 8 core
// matrices, 1024 bytes; SBO 128), half q of a slice (32 rows of k: LBO 128,
// SBO 512)
__device__ __forceinline__ uint64_t tile_desc(const bf16* tile, int ks16) {
  return wgmma_desc(tile + ks16 * 2 * (kTileRows / 8) * 64, (kTileRows / 8) * 128, 128);
}
__device__ __forceinline__ uint64_t slice_desc(const bf16* slice, int q) {
  return wgmma_desc(slice + q * 2 * 64, 128, (kSliceK / 8) * 128);
}

// The two columns col, col + 1 of a float row that is h wide (values past h
// are any finite ones): one 8-byte load where h is even.
__device__ __forceinline__ float2 pair_at(const float* row, int col, int h) {
  if (h % 2 == 0) return *reinterpret_cast<const float2*>(row + min(col, h - 2));
  return make_float2(row[min(col, h - 1)], row[min(col + 1, h - 1)]);
}
__device__ __forceinline__ float2 pair_at(const bf16* row, int col, int h) {
  if (h % 2 == 0)
    return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(row + min(col, h - 2)));
  return make_float2(__bfloat162float(row[min(col, h - 1)]),
                     __bfloat162float(row[min(col + 1, h - 1)]));
}

// The biases (bias1, bias2) of the first two sets of the tile from row0 on
// into a warpgroup's `bsm`: [set][bias1, bias2][bw floats], zeros past h
// and past the last set; cp.async of 4 bytes, by the warpgroup's threads.
// Every row of a tile has its set there where N >= 64.
__device__ __forceinline__ void stage_biases(float* bsm, const ParamsBf16& p, const LocalGeo& geo,
                                             int row0) {
  const int s0 = row0 / p.n, bw = geo.ncb * geo.nb;
  for (int sv = 0; sv < 4; ++sv) {
    const int set = s0 + sv / 2;
    const float* src = p.bias + (size_t)set * 2 * p.h + (sv % 2) * p.h;
    for (int c = threadIdx.x & 127; c < bw; c += 128) {
      const int ok = set < p.b && c < p.h;
      cp_async_piece(bsm + sv * bw + c, ok ? src + c : p.bias, 4, ok);
    }
  }
}

// The biases (vec 0: bias1, 1: bias2) of the row of the tile from row0 on:
// in shared memory (kShared: N >= 64), else in global memory.
template <bool kShared>
__device__ __forceinline__ const float* bias_of(const ParamsBf16& p, const LocalGeo& geo,
                                                const float* bsm, int row0, int row, int vec) {
  const int m = p.b * p.n, set = (row < m ? row : m - 1) / p.n;
  if constexpr (kShared) return bsm + (2 * (set - row0 / p.n) + vec) * geo.ncb * geo.nb;
  return p.bias + (size_t)set * 2 * p.h + vec * p.h;
}

// Columns col, col + 1 of a row of biases (any finite values past h).
template <bool kShared>
__device__ __forceinline__ float2 bias_pair(const float* bs, int col, int h) {
  if constexpr (kShared) return *reinterpret_cast<const float2*>(bs + col);
  return pair_at(bs, col, h);
}

// Output values in the accumulators' layout (out[j][half]: row 16 w + g + 8
// half, columns col0 + 8 j + 2 t, + 1, rounded and packed) to global memory,
// rows below m and columns below h. Every value is computed before this, and
// kept so (an empty asm): a read of the accumulators on the divergent path of
// a store makes the compiler serialise the wgmmas.
template <int NB>
__device__ __forceinline__ void store_out(uint32_t (&out)[NB / 8][2], const ParamsBf16& p,
                                          int row0, int col0) {
  const int i = threadIdx.x & 127, w = i >> 5, g = (i & 31) >> 2, t = i & 3;
  const int m = p.b * p.n, h = p.h;
#pragma unroll
  for (int j = 0; j < NB / 8; ++j)
#pragma unroll
    for (int half = 0; half < 2; ++half) asm volatile("" : "+r"(out[j][half])::"memory");
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = row0 + 16 * w + g + 8 * half;
    if (row >= m) continue;
    bf16* orow = p.xo + (size_t)row * h;
#pragma unroll
    for (int j = 0; j < NB / 8; ++j) {
      const int col = col0 + 8 * j + 2 * t;
      const uint32_t v = out[j][half];
      if (col + 1 < h && h % 2 == 0) {
        *reinterpret_cast<uint32_t*>(orow + col) = v;
      } else {
        if (col < h) orow[col] = __ushort_as_bfloat16((unsigned short)(v & 0xffffu));
        if (col + 1 < h) orow[col + 1] = __ushort_as_bfloat16((unsigned short)(v >> 16));
      }
    }
  }
}

// The epilogue of product 1, column block cb: x1 = act(acc + bias1), rounded,
// into the warpgroup's x1 tile. Columns past h come out 0 (zero weights and
// biases: the k of product 2 past h), rows past m any finite value (never
// stored). Every accumulator is read on every thread without a branch: a read
// of the accumulators on a divergent path makes the compiler serialise the
// wgmmas.
template <int NB, bool kShared>
__device__ __forceinline__ void epilogue1(const float (&acc)[NB / 2], bf16* x1,
                                          const ParamsBf16& p, const LocalGeo& geo,
                                          const float* bsm, int row0, int cb) {
  const int i = threadIdx.x & 127, w = i >> 5, g = (i & 31) >> 2, t = i & 3;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int rl = 16 * w + g + 8 * half;
    const float* bs = bias_of<kShared>(p, geo, bsm, row0, row0 + rl, 0);
    bf16* xo = x1 + tile_at(rl, cb * NB + 2 * t);
#pragma unroll
    for (int j = 0; j < NB / 8; ++j) {
      const float2 b = bias_pair<kShared>(bs, cb * NB + 8 * j + 2 * t, p.h);
      *reinterpret_cast<uint32_t*>(xo + j * (kTileRows / 8) * 64) =
          pack_bf16(act(acc[4 * j + 2 * half] + b.x), act(acc[4 * j + 2 * half + 1] + b.y));
    }
  }
}

// The epilogue of product 2, column block cb: out = act(acc + bias2 + x),
// rounded once, x read from global memory (L2: the tile was read
// microseconds before) and the output stored for rows below m and columns
// below h, after every value is computed.
template <int NB, bool kShared>
__device__ __forceinline__ void epilogue2(const float (&acc)[NB / 2], const ParamsBf16& p,
                                          const LocalGeo& geo, const float* bsm, int row0,
                                          int cb) {
  const int i = threadIdx.x & 127, w = i >> 5, g = (i & 31) >> 2, t = i & 3;
  const int m = p.b * p.n, h = p.h;
  uint32_t out[NB / 8][2];
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = row0 + 16 * w + g + 8 * half;
    const float* bs = bias_of<kShared>(p, geo, bsm, row0, row, 1);
    const bf16* xr = p.x + (size_t)(row < m ? row : m - 1) * h;
#pragma unroll
    for (int j = 0; j < NB / 8; ++j) {
      const int col = cb * NB + 8 * j + 2 * t;
      const float2 b = bias_pair<kShared>(bs, col, h);
      const float2 r = pair_at(xr, col, h);
      out[j][half] = pack_bf16(act(acc[4 * j + 2 * half] + b.x + r.x),
                               act(acc[4 * j + 2 * half + 1] + b.y + r.y));
    }
  }
  store_out<NB>(out, p, row0, cb * NB);
}

__device__ __forceinline__ void wg_sync(int wg) {
  asm volatile("bar.sync %0, %1;" ::"r"(1 + wg), "r"(128) : "memory");
}

// The local path of layers wider than 128 (see the design note above),
// persistent: the warpgroups' x tiles in shared memory, staged together, the
// weights streamed through a ring of slices, each slice for all of them.
// kShared: N >= 64, so a tile's rows are of two sets at most, whose biases
// are staged.
template <int NB, bool kShared>
__global__ void __launch_bounds__(128 * kMaxWg, 1) epic_local_bf16_kernel(ParamsBf16 p) {
  extern __shared__ __align__(128) uint4 smem_bf16[];
  const LocalGeo geo(p.h);
  bf16* base = reinterpret_cast<bf16*>(smem_bf16);
  const int tid = threadIdx.x, wg = tid >> 7, nthreads = blockDim.x;
  const size_t tile = geo.tile_bytes() / sizeof(bf16), slice = geo.slice_bytes() / sizeof(bf16);
  bf16* xs = base + wg * 2 * tile;  // this warpgroup's x tile, then its x1 tile
  bf16* x1s = xs + tile;
  float* bsm = reinterpret_cast<float*>(base + geo.wgs * 2 * tile) +
               wg * geo.bias_bytes() / sizeof(float);  // its biases
  bf16* ws = reinterpret_cast<bf16*>(reinterpret_cast<float*>(base + geo.wgs * 2 * tile) +
                                     geo.wgs * geo.bias_bytes() / sizeof(float));  // the slices
  const int m = p.b * p.n;
  const int xpiece = piece_of(p.x, p.h);
  const int per = geo.ncb * geo.nks;  // slices of one product
  float acc[NB / 2];

  // x1's columns past the accumulators' stay zero (k of product 2 up to kp)
  for (int i = tid & 127; i < kTileRows * (geo.tc - geo.ncb * NB); i += 128) {
    const int r = i % kTileRows, c = geo.ncb * NB + i / kTileRows;
    x1s[tile_at(r, c)] = __float2bfloat16_rn(0.f);
  }

  // streamed weights: the warpgroups' tiles together, each slice for all of them
  const int units = (m + geo.unit_rows() - 1) / geo.unit_rows();
  const int my_units = (int)blockIdx.x < units ? (units - 1 - blockIdx.x) / gridDim.x + 1 : 0;
  const int total = my_units * 2 * per;     // slices this block runs
  const int ahead = min(kRing - 2, per);    // slices in flight before their use
  // each block walks k from its own slice (blockIdx.x % nks), so that the
  // blocks do not all read one slice from L2 at once
  const int rot = blockIdx.x % geo.nks;
  auto unit_row0 = [&](int u) { return (blockIdx.x + u * gridDim.x) * geo.unit_rows(); };
  auto stage_unit = [&](int u) {
    for (int i = 0; i < geo.wgs; ++i)
      stage_x(base + i * 2 * tile, p, geo, unit_row0(u) + i * kTileRows, xpiece, tid, nthreads);
  };
  if (my_units > 0) stage_unit(0);
  cp_async_commit();
  for (int j = 0; j < ahead; ++j) {
    if (j < total) stage_slice(ws + (j % kRing) * slice, p, geo, j % (2 * per), rot, tid, nthreads);
    cp_async_commit();
  }
  for (int s = 0, u = 0, j = 0; s < total; ++s) {
    const int prod = j / per, cb = (j % per) / geo.nks, ks = j % geo.nks;
    const int row0 = unit_row0(u) + wg * kTileRows;
    cp_async_wait_n(ahead - 1);  // slice s (and the x of its tiles) is in
    fence_proxy_async();
    __syncthreads();  // ... for every thread; slice s - 2's products are done
    if (kShared && j == 0) {  // a unit begins: its biases (the last unit's are read)
      stage_biases(bsm, p, geo, row0);
      cp_async_commit();
      cp_async_wait<0>();
      wg_sync(wg);
    }
    if (s + ahead < total)
      stage_slice(ws + ((s + ahead) % kRing) * slice, p, geo, (s + ahead) % (2 * per), rot, tid,
                  nthreads);
    if (j == per && u + 1 < my_units) stage_unit(u + 1);  // product 2 begins: x is read
    cp_async_commit();
    const bf16* a = prod == 0 ? xs : x1s;
    const bf16* w = ws + (s % kRing) * slice;
    const int kr = (ks + rot) % geo.nks;  // the slice's k
    wgmma_fence_operands(acc);
    wgmma_fence();
    Wgmma<NB>::mma(acc, tile_desc(a, 2 * kr), slice_desc(w, 0), ks);
    Wgmma<NB>::mma(acc, tile_desc(a, 2 * kr + 1), slice_desc(w, 1), 1);
    wgmma_commit();
    if (++j == 2 * per) j = 0;
    if (ks + 1 < geo.nks) {
      wgmma_wait<1>();
      wgmma_fence_operands(acc);
      continue;
    }
    wgmma_wait<0>();
    wgmma_fence_operands(acc);
    if (prod == 0) {
      epilogue1<NB, kShared>(acc, x1s, p, geo, bsm, row0, cb);
      fence_proxy_async();  // x1 is read after the next barrier
    } else {
      epilogue2<NB, kShared>(acc, p, geo, bsm, row0, cb);
      if (j == 0) ++u;
    }
  }
  cp_async_wait<0>();
}

// Rows row0 .. row0 + 63 of x into a row-major tile (row distance ld, nb
// columns: zeros past row m and column h), cp.async in pieces of `piece`
// values (element by element for 1), by the warpgroup's threads.
__device__ __forceinline__ void stage_x_rows(bf16* dst, int ld, const ParamsBf16& p,
                                             const LocalGeo& geo, int row0, int piece) {
  const int m = p.b * p.n, h = p.h, q = geo.nb / piece;
  const bf16* src = p.x + (size_t)(row0 < m ? row0 : 0) * h;
  for (int e = threadIdx.x & 127; e < kTileRows * q; e += 128) {
    const int r = e / q, c = (e - r * q) * piece, ok = row0 + r < m && c < h;
    const bf16* s = ok ? src + (size_t)r * h + c : p.x;
    if (piece == 1)
      dst[r * ld + c] = ok ? *s : __float2bfloat16_rn(0.f);
    else
      cp_async_piece(dst + r * ld + c, s, 2 * piece, ok);
  }
}

template <int KS>
__device__ __forceinline__ void fence_frags(uint32_t (&frag)[KS][4]) {
#pragma unroll
  for (int kk = 0; kk < KS; ++kk)
#pragma unroll
    for (int q = 0; q < 4; ++q) asm volatile("" : "+r"(frag[kk][q])::"memory");
}

__device__ __forceinline__ float2 unpack_bf16(uint32_t v) {
  return make_float2(__uint_as_float(v << 16), __uint_as_float(v & 0xffff0000u));
}

// The local path of layers up to 128 wide (see the design note above),
// persistent: two warpgroups on their own 64-row tiles; x and x1 as A
// fragments in registers (wgmma with A from registers), x read into them from
// a row-major tile in shared memory (ldmatrix), both weights staged once per
// block, the next tile's x and biases staged while this tile is computed.
template <int NB, bool kShared>
__global__ void __launch_bounds__(128 * kMaxWg, 1) epic_local_regs_kernel(ParamsBf16 p) {
  constexpr int KS = NB / 16;  // k16 steps of a product: k padded to the column block
  extern __shared__ __align__(128) uint4 smem_bf16[];
  const LocalGeo geo(p.h);
  const int tid = threadIdx.x, wg = tid >> 7;
  const int i = tid & 127, w = i >> 5, g = (i & 31) >> 2, t = i & 3, lane = tid & 31;
  const size_t slice = geo.slice_bytes() / sizeof(bf16), bias = geo.bias_bytes() / sizeof(float);
  const size_t tile = geo.tile_bytes() / sizeof(bf16);
  bf16* ws = reinterpret_cast<bf16*>(smem_bf16);  // the slices of both weights
  bf16* xs = ws + geo.slices * slice + wg * 2 * tile;  // its two x tiles
  float* bsm = reinterpret_cast<float*>(ws + geo.slices * slice + geo.wgs * 2 * tile) +
               wg * 2 * bias;  // its biases, one buffer for each x tile
  const int m = p.b * p.n, h = p.h, ld = geo.tc;
  const int xpiece = piece_of(p.x, h);
  const int tiles = (m + kTileRows - 1) / kTileRows, stride = gridDim.x * geo.wgs;
  int tt = blockIdx.x * geo.wgs + wg, cur = 0;
  for (int j = 0; j < geo.slices; ++j)
    stage_slice(ws + j * slice, p, geo, j, 0, tid, blockDim.x);
  if (tt < tiles) {
    stage_x_rows(xs, ld, p, geo, tt * kTileRows, xpiece);
    if (kShared) stage_biases(bsm, p, geo, tt * kTileRows);
  }
  cp_async_commit();
  cp_async_wait<0>();
  fence_proxy_async();
  __syncthreads();
  uint32_t xa[KS][4], x1[KS][4];
  float acc[NB / 2];
  for (; tt < tiles; tt += stride, cur ^= 1) {
    const int row0 = tt * kTileRows;
    const float* bt = bsm + cur * bias;
    const bf16* xt = xs + cur * tile + (16 * w + (lane & 15)) * ld + 8 * (lane >> 4);
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) ldmatrix_x4(xa[kk], xt + 16 * kk);
    if (tt + stride < tiles) {
      stage_x_rows(xs + (cur ^ 1) * tile, ld, p, geo, (tt + stride) * kTileRows, xpiece);
      if (kShared) stage_biases(bsm + (cur ^ 1) * bias, p, geo, (tt + stride) * kTileRows);
    }
    cp_async_commit();

    // product 1: acc = x . w1x
    wgmma_fence_operands(acc);
    fence_frags<KS>(xa);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KS; ++kk)
      WgmmaRS<NB>::mma(acc, xa[kk], slice_desc(ws + (kk / 2) * slice, kk % 2), kk);
    wgmma_commit();
    wgmma_wait<0>();
    wgmma_fence_operands(acc);
    fence_frags<KS>(xa);

    // x1 = act(acc + bias1), rounded, as the A fragments of product 2
    const float* b10 = bias_of<kShared>(p, geo, bt, row0, row0 + 16 * w + g, 0);
    const float* b11 = bias_of<kShared>(p, geo, bt, row0, row0 + 16 * w + g + 8, 0);
#pragma unroll
    for (int kk = 0; kk < KS; ++kk)
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
        const int j = 2 * kk + jj, col = 8 * j + 2 * t;
        const float2 b0 = bias_pair<kShared>(b10, col, h), b1 = bias_pair<kShared>(b11, col, h);
        x1[kk][2 * jj] = pack_bf16(act(acc[4 * j] + b0.x), act(acc[4 * j + 1] + b0.y));
        x1[kk][2 * jj + 1] =
            pack_bf16(act(acc[4 * j + 2] + b1.x), act(acc[4 * j + 3] + b1.y));
      }

    // product 2: acc = x1 . w2x
    fence_frags<KS>(x1);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KS; ++kk)
      WgmmaRS<NB>::mma(acc, x1[kk], slice_desc(ws + (geo.nks + kk / 2) * slice, kk % 2), kk);
    wgmma_commit();
    wgmma_wait<0>();
    wgmma_fence_operands(acc);
    fence_frags<KS>(x1);

    // out = act(acc + bias2 + x), rounded once; x from the fragments
    const float* b20 = bias_of<kShared>(p, geo, bt, row0, row0 + 16 * w + g, 1);
    const float* b21 = bias_of<kShared>(p, geo, bt, row0, row0 + 16 * w + g + 8, 1);
    uint32_t out[NB / 8][2];
#pragma unroll
    for (int kk = 0; kk < KS; ++kk)
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
        const int j = 2 * kk + jj, col = 8 * j + 2 * t;
        const float2 b0 = bias_pair<kShared>(b20, col, h), b1 = bias_pair<kShared>(b21, col, h);
        const float2 r0 = unpack_bf16(xa[kk][2 * jj]), r1 = unpack_bf16(xa[kk][2 * jj + 1]);
        out[j][0] = pack_bf16(act(acc[4 * j] + b0.x + r0.x), act(acc[4 * j + 1] + b0.y + r0.y));
        out[j][1] =
            pack_bf16(act(acc[4 * j + 2] + b1.x + r1.x), act(acc[4 * j + 3] + b1.y + r1.y));
      }
    store_out<NB>(out, p, row0, 0);
    cp_async_wait<0>();
    wg_sync(wg);  // the next tile's x and biases are in for every thread; this tile's are read
  }
}

int device_sms() {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
      sms = 0;
  }
  return sms;
}

// The local kernel `kernel` (the register one where geo.regs, else the
// streamed one), or with `report` what it would be given.
cudaError_t launch_local(void (*kernel)(ParamsBf16), int nb, const ParamsBf16& p,
                         const LocalGeo& geo, int sms, cudaStream_t stream, int* report) {
  const long long m = (long long)p.b * p.n;
  const long long units = (m + geo.unit_rows() - 1) / geo.unit_rows();
  const int blocks = (int)(units < sms ? units : sms);
  if (report) {
    cudaFuncAttributes attr;
    cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
    if (err != cudaSuccess) return err;
    report[0] = blocks;
    report[1] = 4 * geo.wgs;
    report[2] = geo.unit_rows();
    report[3] = geo.slots;
    report[4] = (int)geo.bytes();
    report[5] = attr.numRegs;
    report[6] = geo.regs;
    report[7] = nb;
    return cudaSuccess;
  }
  if (m > 2147483647LL) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)geo.bytes());
  if (err != cudaSuccess) return err;
  kernel<<<blocks, 128 * geo.wgs, geo.bytes(), stream>>>(p);
  return cudaGetLastError();
}

// The local kernel for this width and N (kShared: N >= 64, a tile's biases
// staged).
template <bool kShared>
cudaError_t launch_local_bf16(const ParamsBf16& p, const LocalGeo& geo, int sms,
                              cudaStream_t stream, int* report) {
  if (geo.regs)
    return geo.nb == 64
               ? launch_local(epic_local_regs_kernel<64, kShared>, 64, p, geo, sms, stream, report)
               : launch_local(epic_local_regs_kernel<128, kShared>, 128, p, geo, sms, stream,
                              report);
  return geo.nb == 128
             ? launch_local(epic_local_bf16_kernel<128, kShared>, 128, p, geo, sms, stream, report)
             : launch_local(epic_local_bf16_kernel<152, kShared>, 152, p, geo, sms, stream,
                            report);
}

// Both kernels, or with `report` (10 ints) what they would be given: the local
// kernel's blocks, warps, rows its warpgroups take at a time, staged slices,
// shared bytes, registers per thread, whether the weights stay staged, the
// column block (wgmma's N); the per-set kernel's blocks and sets a block.
cudaError_t launch_bf16(const ParamsBf16& p, cudaStream_t stream, int* report) {
  if (p.b <= 0 || p.n <= 0 || p.h <= 0 || p.h > kMaxWidth || p.l <= 0 || p.l > kMaxWidth)
    return cudaErrorInvalidValue;
  const int sms = device_sms();
  if (sms <= 0) return cudaErrorNoDevice;
  const int sets = sets_per_block(p);
  const int set_blocks = (p.b + sets - 1) / sets;
  const LocalGeo geo(p.h);
  if (report) {
    report[8] = set_blocks;
    report[9] = sets;
  } else {
    // the scratch: the biases (B, 2, H), the pooled sums (B, H), the counts (B)
    float* pool = p.bias + (size_t)p.b * 2 * p.h;
    float* count = pool + (size_t)p.b * p.h;
    epic_pool_bf16_kernel<<<p.b, kSetThreads, 0, stream>>>(p, pool, count);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    const size_t smem = sets_smem_bytes(p, sets);
    err = cudaFuncSetAttribute(epic_sets_bf16_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return err;
    epic_sets_bf16_kernel<<<set_blocks, kSetThreads, smem, stream>>>(p, sets, pool, count);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return p.n >= kTileRows ? launch_local_bf16<true>(p, geo, sms, stream, report)
                          : launch_local_bf16<false>(p, geo, sms, stream, report);
}

}  // namespace

// Returns the first failing launch's cudaError_t (0 on success). Shapes and
// types were checked by the Python wrapper (ops/epic_layer.py::
// epic_layer_bf16): bfloat16 tensors but the float32 mask; `bias` is scratch
// of B * (3H + 1) floats (the biases, the pooled sums, the counts);
// `wslices` the weight image as bf16_weight_image lays it out (the per-set
// weights and w1x, w2x; the kernels read the weights from it only). 1 <= h
// <= 512, 1 <= l <= 512.
extern "C" int epic_layer_fwd_bf16(
    const bf16* x, const bf16* g, const float* mask, const bf16* sfeat,
    const bf16* wg1, const bf16* bg1, const bf16* wg2, const bf16* bg2,
    const bf16* w1x, const bf16* w1s, const bf16* b1,
    const bf16* w2x, const bf16* w2s, const bf16* b2,
    bf16* xo, bf16* go, float* bias, const bf16* wslices,
    int b, int n, int h, int l, int s, int tg, int tl, int cg, int cl,
    float sum_scale, void* stream_ptr) {
  const ParamsBf16 p{x, g, mask, sfeat, wg1, bg1, wg2, bg2, w1x, w1s, b1, w2x, w2s, b2,
                     xo, go, bias, wslices, b, n, h, l, s, tg, tl, cg, cl, sum_scale};
  return (int)launch_bf16(p, static_cast<cudaStream_t>(stream_ptr), nullptr);
}

// What the launcher gives the two kernels for b sets of n particles at these
// widths, into `report` (10 ints, as launch_bf16 writes them). Launches
// nothing.
extern "C" int epic_layer_bf16_geometry(int b, int n, int h, int l, int s, int tg, int tl, int cg,
                                        int cl, int* report) {
  ParamsBf16 p{};
  p.b = b; p.n = n; p.h = h; p.l = l; p.s = s; p.tg = tg; p.tl = tl; p.cg = cg; p.cl = cl;
  return (int)launch_bf16(p, nullptr, report);
}

extern "C" const char* epic_layer_bf16_mma_instruction() { return WGMMA_BF16_INSTRUCTION; }
