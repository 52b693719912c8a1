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
// bfloat16 products on mma.sync.m16n8k16 (mma_bf16.cuh), exact as the Pallas
// kernel's bfloat16 `jnp.dot` with float32 accumulation is; the plain version
// (ops/epic_layer.py::epic_layer_reference) computes the same function.
//
// Bound on an H100 SXM at the flagship shape (B=640, N=150, H=128): the two
// local products are 6.29 GFLOP, 6.4 us at 989 TFLOP/s; x in and out is 49 MB,
// 15 us at 3.35 TB/s: bound by bytes.
//
// Design, simple first: two kernels, one after the other on the stream.
//   * epic_set_bf16_kernel, a block of 256 threads per set: the masked pool,
//     the two global MLPs and the two per-set biases, the rows of x or of a
//     weight split over the 8 warps and the columns over the lanes (4
//     independent sums a lane; the warps' partial sums meet in shared memory),
//     g_new written out, the biases (B, 2, H) in float32 to scratch memory that
//     the wrapper allocates. The dot products are bound by the latency of their
//     loads (660 rows at path E), so each lane keeps four sums in flight.
//   * epic_local_bf16_kernel over the B*N rows as one matrix, in tiles of 128
//     rows (64 where 128 do not fit a block: H above 336; a tile may span
//     sets, and each row reads its set's biases): the x
//     tile is staged in shared memory once, zero-padded to HP (H rounded up
//     to 16, the k of one mma) at a row stride of HP+8; the weights are staged
//     64 output columns at a time, all HP rows of them, at a row stride of 72;
//     each of 16 warps (8) owns 16 rows and 32 of the 64 columns (4 n8 tiles,
//     16 accumulators a lane), with A from the tile and B from the weights by
//     ldmatrix (.trans: the weights are (in, out), k-major). x1 stays in shared
//     memory between the two products; the residual x is read from the tile.
//     Rows and weights are copied in 16-byte pieces where H % 8 == 0, else in
//     8- or 4-byte pieces (H % 4, H % 2; jetclass_cond's H=300 takes 8), else
//     by element: at H=300 one block fills an SM's shared memory, and its
//     warps wait on the copies, so they must be wide, and a tile as tall as
//     fits, so that each staged column of the weights serves many rows
//     (PERF.md has the times of the narrower versions).
//   Shared memory: 2 x 128 x (HP+8) + HP x 72 bfloat16, 88 KB at H=128 and 204
//   KB at H=300 (64-row tiles at H=512: 207 KB). No cp.async pipeline, no
//   persistent blocks, and the weights are read from L2 once per tile: that
//   is for a later version.

namespace {

using bf16 = __nv_bfloat16;

constexpr int kSetThreads = 256;            // threads of a block of the per-set kernel
constexpr int kLocalColWarps = 2;           // warps along the staged columns
constexpr int kLocalCols = 64;              // output columns staged at a time
constexpr int kBfWarpCols = kLocalCols / kLocalColWarps;  // of a warp: 4 n8 tiles
constexpr int kBfPad = 8;                   // a row stride is a multiple of 16 plus this
constexpr int kWStride = kLocalCols + kBfPad;

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
  float* bias;         // (B, 2, H): bias1, bias2
  int b, n, h, l, s, tg, tl, cg, cl;
  float sum_scale;
};

__device__ __forceinline__ float bf(const bf16* p, long long i) { return __bfloat162float(p[i]); }

constexpr int kSetWarps = kSetThreads / 32;

// epi(j, dot(in[0:k], w[:, j])) for j < m (w bfloat16, row-major (k, m)), by
// all the threads of the per-set kernel: warp q takes rows q, q + 8, ... of w
// and lane i the columns i, i + 32, i + 64, i + 96 of a pass of 128, so a warp
// reads whole rows and keeps four independent sums; the warps' partial sums
// meet in `part` (kSetWarps * m floats). The sums are float32 on the
// bfloat16 values.
template <class Epi>
__device__ __forceinline__ void set_dot(const float* in, const bf16* __restrict__ w, int k, int m,
                                        float* part, Epi epi) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int c0 = lane; c0 < m; c0 += 128) {
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 4
    for (int i = warp; i < k; i += kSetWarps) {
      const float a = in[i];
      const bf16* wr = w + (long long)i * m + c0;
#pragma unroll
      for (int q = 0; q < 4; ++q)
        if (c0 + 32 * q < m) acc[q] = fmaf(a, __bfloat162float(wr[32 * q]), acc[q]);
    }
#pragma unroll
    for (int q = 0; q < 4; ++q)
      if (c0 + 32 * q < m) part[warp * m + c0 + 32 * q] = acc[q];
  }
  __syncthreads();
  for (int j = threadIdx.x; j < m; j += kSetThreads) {
    float sum = 0.f;
    for (int q = 0; q < kSetWarps; ++q) sum += part[q * m + j];
    epi(j, sum);
  }
  __syncthreads();  // the outputs are written; part is reused next
}

// The per-set part of set blockIdx.x.
__global__ void __launch_bounds__(kSetThreads) epic_set_bf16_kernel(ParamsBf16 p) {
  extern __shared__ float fsm[];
  const int b = blockIdx.x, tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int n = p.n, h = p.h, l = p.l, tg = p.tg, tl = p.tl, s = p.s;
  const int k1 = tg + 2 * h + l + p.cg, k2 = tg + h + p.cg, k3 = tl + l + p.cl, k4 = tl + p.cl;
  float* gin = fsm;       // cat(t_g, mean, scaled_sum, g, cond_g)
  float* in2 = gin + k1;  // cat(t_g, g1, cond_g)
  float* s1 = in2 + k2;   // cat(t_l, g_new, cond_l)
  float* s2 = s1 + k3;    // cat(t_l, cond_l)
  float* cnt = s2 + k4;
  float* part = cnt + 1;  // kSetWarps * max(h, l)
  const bf16* x = p.x + (long long)b * n * h;
  const float* m = p.mask + (long long)b * n;
  const bf16* sf = p.sfeat + (long long)b * s;
  const bf16* cond_g = sf + s - p.cg;
  const bf16* cond_l = sf + s - p.cl;
  const bf16* g = p.g + (long long)b * l;

  if (tid < 32) {
    float c = 0.f;
    for (int r = tid; r < n; r += 32) c += m[r];
    for (int off = 16; off > 0; off >>= 1) c += __shfl_xor_sync(0xffffffffu, c, off);
    if (tid == 0) cnt[0] = c;
  }
  for (int i = tid; i < tg; i += kSetThreads) gin[i] = in2[i] = bf(sf, i);
  for (int i = tid; i < l; i += kSetThreads) gin[tg + 2 * h + i] = bf(g, i);
  for (int i = tid; i < p.cg; i += kSetThreads) {
    gin[tg + 2 * h + l + i] = in2[tg + h + i] = bf(cond_g, i);
  }
  for (int i = tid; i < tl; i += kSetThreads) s1[i] = s2[i] = bf(sf, i);
  for (int i = tid; i < p.cl; i += kSetThreads) s1[tl + l + i] = s2[tl + i] = bf(cond_l, i);

  // the pool, in float32 on the bfloat16 values: warps over the rows, lanes
  // over the columns, as in set_dot
  for (int c0 = lane; c0 < h; c0 += 128) {
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 4
    for (int r = warp; r < n; r += kSetWarps) {
      const float mv = m[r];
      const bf16* xr = x + (long long)r * h + c0;
#pragma unroll
      for (int q = 0; q < 4; ++q)
        if (c0 + 32 * q < h) acc[q] = fmaf(__bfloat162float(xr[32 * q]), mv, acc[q]);
    }
#pragma unroll
    for (int q = 0; q < 4; ++q)
      if (c0 + 32 * q < h) part[warp * h + c0 + 32 * q] = acc[q];
  }
  __syncthreads();
  const float count = cnt[0];
  for (int c = tid; c < h; c += kSetThreads) {
    float acc = 0.f;
    for (int q = 0; q < kSetWarps; ++q) acc += part[q * h + c];
    gin[tg + c] = acc / count;
    gin[tg + h + c] = acc * p.sum_scale;
  }
  __syncthreads();

  // global MLP 1; g1 rounded to bfloat16 as the second MLP's input
  set_dot(gin, p.wg1, k1, h, part,
          [&](int j, float v) { in2[tg + j] = round_bf16(act(v + bf(p.bg1, j))); });
  // global MLP 2 with the residual g; g_new rounded once
  set_dot(in2, p.wg2, k2, l, part, [&](int j, float v) {
    const bf16 gn = __float2bfloat16_rn(act(v + bf(p.bg2, j) + bf(g, j)));
    p.go[(long long)b * l + j] = gn;
    s1[tl + j] = __bfloat162float(gn);
  });
  // the per-set biases of the two local products, float32
  float* bias = p.bias + (long long)b * 2 * h;
  set_dot(s1, p.w1s, k3, h, part, [&](int j, float v) { bias[j] = v + bf(p.b1, j); });
  set_dot(s2, p.w2s, k4, h, part, [&](int j, float v) { bias[h + j] = v + bf(p.b2, j); });
}

// Shared memory of the local kernel, in bfloat16 elements from a 16-byte
// aligned base: the x tile, the x1 tile (`rows` rows at a stride of st), the
// staged weights (hp rows at a stride of kWStride).
struct LocalLayout {
  int hp, st, xs, x1s, ws;
  __host__ __device__ LocalLayout(int h, int rows) {
    hp = (h + 15) & ~15;
    st = hp + kBfPad;
    xs = 0;
    x1s = rows * st;
    ws = 2 * rows * st;
  }
  __host__ __device__ size_t bytes() const {
    return sizeof(bf16) * ((size_t)ws + (size_t)hp * kWStride);
  }
};

// A piece of P bfloat16 values (16, 8, 4 or 2 bytes), zeros where `in` is false.
template <int P>
struct Piece;
template <>
struct Piece<8> { using T = uint4; static __device__ T zero() { return make_uint4(0u, 0u, 0u, 0u); } };
template <>
struct Piece<4> { using T = uint2; static __device__ T zero() { return make_uint2(0u, 0u); } };
template <>
struct Piece<2> { using T = uint32_t; static __device__ T zero() { return 0u; } };
template <>
struct Piece<1> { using T = unsigned short; static __device__ T zero() { return 0; } };

// rows x cols (cols a multiple of P) from src (row distance ld; rows past
// `rows_in` and columns past `cols_in` read as zeros; both whole pieces) into
// dst (row distance dst_ld), in pieces of P values, by all threads.
template <int P>
__device__ __forceinline__ void copy_pieces(bf16* dst, int dst_ld, const bf16* src, long long ld,
                                            int rows, int cols, long long rows_in, int cols_in) {
  using T = typename Piece<P>::T;
  const int q = cols / P;
  for (int i = threadIdx.x; i < rows * q; i += blockDim.x) {
    const int r = i / q, c = (i - r * q) * P;
    T v = Piece<P>::zero();
    if (r < rows_in && c < cols_in) v = *reinterpret_cast<const T*>(src + r * ld + c);
    *reinterpret_cast<T*>(dst + r * dst_ld + c) = v;
  }
}

// The widest piece that the rows of `src` (h values, row distance h) allow.
__device__ __forceinline__ int piece_of(const bf16* src, int h) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(src);
  if (h % 8 == 0 && a % 16 == 0) return 8;
  if (h % 4 == 0 && a % 8 == 0) return 4;
  if (h % 2 == 0 && a % 4 == 0) return 2;
  return 1;
}

template <typename... A>
__device__ __forceinline__ void copy_any(int piece, A... a) {
  switch (piece) {
    case 8: copy_pieces<8>(a...); break;
    case 4: copy_pieces<4>(a...); break;
    case 2: copy_pieces<2>(a...); break;
    default: copy_pieces<1>(a...); break;
  }
}

// Rows row0 .. row0 + rows - 1 of x (m rows of h) into the tile, zeros past
// row m and from column h to hp.
__device__ __forceinline__ void stage_rows_bf16(bf16* xs, const bf16* x, long long row0,
                                                long long m, int h, int hp, int st, int rows) {
  copy_any(piece_of(x, h), xs, st, x + row0 * h, (long long)h, rows, hp, m - row0, h);
}

// Columns c0 .. c0 + kLocalCols - 1 of the (h, h) weights w (in, out), all hp
// rows, into ws; zeros past row h and column h.
__device__ __forceinline__ void stage_weights_bf16(bf16* ws, const bf16* w, int h, int hp,
                                                   int c0) {
  copy_any(piece_of(w, h), ws, kWStride, w + c0, (long long)h, hp, kLocalCols, (long long)h,
           h - c0);
}

// acc = rows 16 rw .. 16 rw + 15 of the tile `a` (row stride st) times the
// staged columns cw .. cw + kBfWarpCols - 1, over k < hp: 4 n8 tiles, one
// bfloat16 mma each per step of 16 along k. rw = warp % RW, cw = kBfWarpCols
// (warp / RW), for RW warps along the rows.
template <int RW>
__device__ __forceinline__ void warp_columns_bf16(float (&acc)[kBfWarpCols / 8][4], const bf16* a,
                                                  int st, const bf16* ws, int hp) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int rw = warp % RW, cw = kBfWarpCols * (warp / RW);
#pragma unroll
  for (int nt = 0; nt < kBfWarpCols / 8; ++nt)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[nt][i] = 0.f;
  const bf16* arow = a + (16 * rw + (lane & 15)) * st + 8 * (lane >> 4);
  const bf16* brow = ws + (lane & 15) * kWStride + cw + 8 * (lane >> 4);
  for (int k0 = 0; k0 < hp; k0 += 16) {
    uint32_t af[4];
    ldmatrix_x4(af, arow + k0);
#pragma unroll
    for (int np = 0; np < kBfWarpCols / 16; ++np) {
      uint32_t bfr[4];
      ldmatrix_x4_trans(bfr, brow + k0 * kWStride + 16 * np);
      mma_bf16(acc[2 * np], af, bfr[0], bfr[1]);
      mma_bf16(acc[2 * np + 1], af, bfr[2], bfr[3]);
    }
  }
}

// The local path of one tile of 16 RW of the B*N rows, by RW x 2 warps.
template <int RW>
__global__ void __launch_bounds__(32 * RW * kLocalColWarps)
epic_local_bf16_kernel(ParamsBf16 p) {
  constexpr int kRows = 16 * RW;
  extern __shared__ __align__(16) uint4 smem_bf16[];
  bf16* base = reinterpret_cast<bf16*>(smem_bf16);
  const LocalLayout lay(p.h, kRows);
  const int h = p.h, hp = lay.hp, st = lay.st;
  bf16* xs = base + lay.xs;
  bf16* x1s = base + lay.x1s;
  bf16* ws = base + lay.ws;
  const long long m = (long long)p.b * p.n;
  const long long row0 = (long long)blockIdx.x * kRows;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, g = lane >> 2, t = lane & 3;
  const int rw = 16 * (warp % RW), cw = kBfWarpCols * (warp / RW);
  stage_rows_bf16(xs, p.x, row0, m, h, hp, st, kRows);

  // x1 = act(x . w1x + bias1), rounded, zeros from column h to hp
  for (int c0 = 0; c0 < hp; c0 += kLocalCols) {
    __syncthreads();  // the tile is staged; the weights of the previous columns are read
    stage_weights_bf16(ws, p.w1x, h, hp, c0);
    __syncthreads();
    float acc[kBfWarpCols / 8][4];
    warp_columns_bf16<RW>(acc, xs, st, ws, hp);
#pragma unroll
    for (int nt = 0; nt < kBfWarpCols / 8; ++nt)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = rw + g + 8 * half, col = c0 + cw + 8 * nt + 2 * t;
        if (col >= hp) continue;
        float v0 = 0.f, v1 = 0.f;
        if (row0 + r < m) {
          const float* bs = p.bias + (row0 + r) / p.n * 2 * h;
          if (col < h) v0 = act(acc[nt][2 * half] + bs[col]);
          if (col + 1 < h) v1 = act(acc[nt][2 * half + 1] + bs[col + 1]);
        }
        *reinterpret_cast<__nv_bfloat162*>(x1s + r * st + col) = __floats2bfloat162_rn(v0, v1);
      }
  }

  // out = act(x1 . w2x + bias2 + x), rounded once
  for (int c0 = 0; c0 < hp; c0 += kLocalCols) {
    __syncthreads();  // x1 is whole; the weights of the previous columns are read
    stage_weights_bf16(ws, p.w2x, h, hp, c0);
    __syncthreads();
    float acc[kBfWarpCols / 8][4];
    warp_columns_bf16<RW>(acc, x1s, st, ws, hp);
#pragma unroll
    for (int nt = 0; nt < kBfWarpCols / 8; ++nt)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = rw + g + 8 * half, col = c0 + cw + 8 * nt + 2 * t;
        const long long row = row0 + r;
        if (row >= m || col >= h) continue;
        const float* bs = p.bias + row / p.n * 2 * h + h;
        const float o0 = act(acc[nt][2 * half] + bs[col] + __bfloat162float(xs[r * st + col]));
        bf16* orow = p.xo + row * h;
        if (col + 1 < h) {
          const float o1 =
              act(acc[nt][2 * half + 1] + bs[col + 1] + __bfloat162float(xs[r * st + col + 1]));
          if (h % 2 == 0) {
            *reinterpret_cast<__nv_bfloat162*>(orow + col) = __floats2bfloat162_rn(o0, o1);
          } else {
            orow[col] = __float2bfloat16_rn(o0);
            orow[col + 1] = __float2bfloat16_rn(o1);
          }
        } else {
          orow[col] = __float2bfloat16_rn(o0);
        }
      }
  }
}

// The local kernel with RW warps along the rows: tiles of 16 RW rows.
template <int RW>
cudaError_t launch_local_bf16(const ParamsBf16& p, cudaStream_t stream) {
  constexpr int kRows = 16 * RW;
  const LocalLayout lay(p.h, kRows);
  cudaError_t err = cudaFuncSetAttribute(epic_local_bf16_kernel<RW>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)lay.bytes());
  if (err != cudaSuccess) return err;
  const long long tiles = ((long long)p.b * p.n + kRows - 1) / kRows;
  if (tiles > 2147483647LL) return cudaErrorInvalidValue;
  epic_local_bf16_kernel<RW><<<(unsigned)tiles, 32 * RW * kLocalColWarps, lay.bytes(), stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// Returns the first failing launch's cudaError_t (0 on success). Shapes and
// types were checked by the Python wrapper (ops/epic_layer.py::
// epic_layer_bf16): bfloat16 tensors but the float32 mask; `bias` is scratch
// of B * 2 * H floats. 1 <= h <= 512, 1 <= l <= 512.
extern "C" int epic_layer_fwd_bf16(
    const bf16* x, const bf16* g, const float* mask, const bf16* sfeat,
    const bf16* wg1, const bf16* bg1, const bf16* wg2, const bf16* bg2,
    const bf16* w1x, const bf16* w1s, const bf16* b1,
    const bf16* w2x, const bf16* w2s, const bf16* b2,
    bf16* xo, bf16* go, float* bias,
    int b, int n, int h, int l, int s, int tg, int tl, int cg, int cl,
    float sum_scale, void* stream_ptr) {
  if (b <= 0 || n <= 0 || h <= 0 || h > kMaxWidth || l <= 0 || l > kMaxWidth)
    return (int)cudaErrorInvalidValue;
  const ParamsBf16 p{x, g, mask, sfeat, wg1, bg1, wg2, bg2, w1x, w1s, b1, w2x, w2s, b2,
                     xo, go, bias, b, n, h, l, s, tg, tl, cg, cl, sum_scale};
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const size_t set_smem =
      sizeof(float) * ((size_t)(tg + 2 * h + l + cg) + (tg + h + cg) + (tl + l + cl) + (tl + cl) +
                       1 + (size_t)kSetWarps * (h > l ? h : l));
  epic_set_bf16_kernel<<<b, kSetThreads, set_smem, stream>>>(p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  // tiles of 128 rows where they fit a block, else of 64 (H above 336)
  return (int)(LocalLayout(h, 128).bytes() <= (size_t)kMaxSmem ? launch_local_bf16<8>(p, stream)
                                                               : launch_local_bf16<4>(p, stream));
}

extern "C" const char* epic_layer_bf16_mma_instruction() { return MMA_BF16_INSTRUCTION; }
