// What the attention kernels of this directory share (short_attention.cu,
// flash_attention.cu): the (B, L, H, D) operand with its row and set
// distances, the staging of one head's rows into shared memory, cp.async,
// the real-key extent of a set, and the masking constants. Operands in float32 or bfloat16 (read into float32),
// sm_90a.
//
// -1e9 is added to the score of a masked key, never -inf, so a set whose keys
// are all masked gets uniform weights and stays finite; in float32 the sum
// s + (-1e9) rounds the score away, as in the plain versions. exp goes
// through exp2 with the log2 e factor applied after the mask was added, which
// keeps that rounding the same.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr float kNeg = 1e9f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kMaxSmem = 232448;  // bytes a block may use on sm_90

// q, k or v: (B, L, H, D) with (H, D) packed; `bs` and `ld` are the distances
// in elements between sets and between rows. `vec`: rows may be read four
// elements at a time (a float4; 8 bytes of bfloat16).
template <typename T>
struct HeadsT {
  const T* p;
  long long bs, ld;
  bool vec;
};
using Heads = HeadsT<float>;

// Columns c..c+3 of a row that is d wide; columns from d on read as zero.
__device__ __forceinline__ float4 load4(const float* row, int c, int d, bool vec) {
  float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
  if (vec) {
    if (c < d) val = *reinterpret_cast<const float4*>(row + c);
  } else {
    if (c + 0 < d) val.x = row[c + 0];
    if (c + 1 < d) val.y = row[c + 1];
    if (c + 2 < d) val.z = row[c + 2];
    if (c + 3 < d) val.w = row[c + 3];
  }
  return val;
}

// The same four elements of a bfloat16 row, as floats (exact).
__device__ __forceinline__ float4 load4(const __nv_bfloat16* row, int c, int d, bool vec) {
  float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
  if (vec) {
    if (c < d) {
      const uint2 raw = *reinterpret_cast<const uint2*>(row + c);
      const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
      const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
      val = make_float4(lo.x, lo.y, hi.x, hi.y);
    }
  } else {
    if (c + 0 < d) val.x = __bfloat162float(row[c + 0]);
    if (c + 1 < d) val.y = __bfloat162float(row[c + 1]);
    if (c + 2 < d) val.z = __bfloat162float(row[c + 2]);
    if (c + 3 < d) val.w = __bfloat162float(row[c + 3]);
  }
  return val;
}

// Stage `rows` rows of one head (d wide) into shared memory as floats at a row
// stride of `stride` floats; columns d..DP-1 and rows rows..rows_p-1 become
// zero.
template <int DP, typename T>
__device__ __forceinline__ void stage_head(float* dst, int stride, const T* src,
                                           long long ld, int rows, int rows_p, int d,
                                           bool vec) {
  constexpr int Q = DP / 4;
  for (int i = threadIdx.x; i < rows_p * Q; i += blockDim.x) {
    const int r = i / Q, c = (i % Q) * 4;
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r < rows) val = load4(src + r * ld, c, d, vec);
    *reinterpret_cast<float4*>(dst + r * stride + c) = val;
  }
}

// 8 bfloat16 values as floats (exact)
__device__ __forceinline__ void unpack8(uint4 r, float (&f)[8]) {
  const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

// exp(x) for x <= 0 (or -inf)
__device__ __forceinline__ float exp_neg(float x) { return exp2f(x * kLog2e); }

// 8 values of a bfloat16 row from column c; zeros from column d on. kStream:
// a streaming load (evict first), for rows read once.
template <bool kStream = true>
__device__ __forceinline__ uint4 load8_raw(const __nv_bfloat16* row, int c, int d, bool wide) {
  if (wide) {
    if (c >= d) return make_uint4(0u, 0u, 0u, 0u);
    const uint4* p = reinterpret_cast<const uint4*>(row + c);
    return kStream ? __ldcs(p) : *p;
  }
  uint32_t e[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) e[i] = c + i < d ? __bfloat16_as_ushort(row[c + i]) : 0u;
  return make_uint4(e[0] | (e[1] << 16), e[2] | (e[3] << 16), e[4] | (e[5] << 16),
                    e[6] | (e[7] << 16));
}

// (m, l, acc) of one stream merged into another's
__device__ __forceinline__ void merge_stream(float& m, float& l, float (&o)[8], float m2, float l2,
                                             const float (&o2)[8]) {
  const float mn = fmaxf(m, m2);
  const float e1 = exp_neg(m - mn), e2 = exp_neg(m2 - mn);
  l = l * e1 + l2 * e2;
#pragma unroll
  for (int i = 0; i < 8; ++i) o[i] = o[i] * e1 + o2[i] * e2;
  m = mn;
}

// The keys of a set that the bfloat16 flash (more than 4 query rows) and
// fused ("from") kernels step over: up to the set's last key with a nonzero
// mask when one of its keys has a mask of exactly 1, else all lk (no mask, a
// set whose keys are all masked, masks with fractional values only). The keys
// after that last key score about 1e9 below the running maximum, so exp gives
// exactly 0 for them and the rescale exactly 1: skipping them changes
// nothing (ops/short_attention.py::real_key_extents mirrors this). The
// block reads its mask row once; every thread calls this, `last` is a shared
// int.
__device__ __forceinline__ int real_key_extent(const float* mask_row, int lk, int* last) {
  if (threadIdx.x == 0) *last = -1;
  __syncthreads();
  int one = 0;
  if (mask_row) {
    int mine = -1;
    for (int j = threadIdx.x; j < lk; j += blockDim.x) {
      const float mv = mask_row[j];
      if (mv != 0.f) mine = j;
      one |= mv == 1.f;
    }
    mine = __reduce_max_sync(0xffffffffu, mine);
    if ((threadIdx.x & 31) == 0 && mine >= 0) atomicMax(last, mine);
  }
  return __syncthreads_or(one) ? *last + 1 : lk;
}

// The same extent (the rule above), from the one read of the mask row that
// also stages the set's additive mask into shared memory: madd[j] is 0 for a
// real key, -1e9 for a masked one (mask_row null: every key real), -inf for
// the keys j = n .. n_p - 1 past the set's end. Every thread calls this;
// `last` is a shared int. The closing barrier makes madd visible.
__device__ __forceinline__ int stage_mask_extent(float* madd, const float* mask_row, int n,
                                                 int n_p, int* last) {
  if (threadIdx.x == 0) *last = -1;
  __syncthreads();
  int one = 0, mine = -1;
  for (int j = threadIdx.x; j < n_p; j += blockDim.x) {
    float a = -CUDART_INF_F;
    if (j < n) {
      const float mv = mask_row ? mask_row[j] : 1.f;
      a = mask_row ? (mv - 1.f) * kNeg : 0.f;
      if (mv != 0.f) mine = j;
      one |= mv == 1.f;
    }
    madd[j] = a;
  }
  mine = __reduce_max_sync(0xffffffffu, mine);
  if ((threadIdx.x & 31) == 0 && mine >= 0) atomicMax(last, mine);
  return __syncthreads_or(one) ? *last + 1 : n;
}

// 16 bytes from device memory to shared memory without registers (cp.async;
// zeros where !in, and nothing is read then).
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool in) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(s), "l"(src),
               "r"(in ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;" ::: "memory");
}

template <typename T>
HeadsT<T> heads(const T* p, long long bs, long long ld, int d) {
  const bool vec = d % 4 == 0 && bs % 4 == 0 && ld % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(p) % (4 * sizeof(T)) == 0;
  return HeadsT<T>{p, bs, ld, vec};
}

// Four floats to four elements of a row that is d wide (columns from d on
// are not written); `vec`: d % 4 == 0 and the row starts on 4 elements.
__device__ __forceinline__ void store4(float* row, int c, int d, float4 val, bool vec) {
  if (vec) {
    if (c < d) *reinterpret_cast<float4*>(row + c) = val;
  } else {
    if (c + 0 < d) row[c + 0] = val.x;
    if (c + 1 < d) row[c + 1] = val.y;
    if (c + 2 < d) row[c + 2] = val.z;
    if (c + 3 < d) row[c + 3] = val.w;
  }
}

// ... rounded to the nearest bfloat16
__device__ __forceinline__ void store4(__nv_bfloat16* row, int c, int d, float4 val, bool vec) {
  if (vec) {
    if (c < d) {
      const __nv_bfloat162 lo = __floats2bfloat162_rn(val.x, val.y);
      const __nv_bfloat162 hi = __floats2bfloat162_rn(val.z, val.w);
      uint2 raw;
      raw.x = *reinterpret_cast<const uint32_t*>(&lo);
      raw.y = *reinterpret_cast<const uint32_t*>(&hi);
      *reinterpret_cast<uint2*>(row + c) = raw;
    }
  } else {
    if (c + 0 < d) row[c + 0] = __float2bfloat16_rn(val.x);
    if (c + 1 < d) row[c + 1] = __float2bfloat16_rn(val.y);
    if (c + 2 < d) row[c + 2] = __float2bfloat16_rn(val.z);
    if (c + 3 < d) row[c + 3] = __float2bfloat16_rn(val.w);
  }
}

// Two neighbouring outputs x0, x1 to columns col, col + 1 of a row that is d
// wide (col even; columns from d on are not written).
__device__ __forceinline__ void store2(float* row, int col, int d, float x0, float x1) {
  if (d % 2 == 0) {
    if (col < d) *reinterpret_cast<float2*>(row + col) = make_float2(x0, x1);
  } else {
    if (col < d) row[col] = x0;
    if (col + 1 < d) row[col + 1] = x1;
  }
}

__device__ __forceinline__ void store2(__nv_bfloat16* row, int col, int d, float x0, float x1) {
  if (d % 2 == 0) {
    if (col < d) *reinterpret_cast<__nv_bfloat162*>(row + col) = __floats2bfloat162_rn(x0, x1);
  } else {
    if (col < d) row[col] = __float2bfloat16_rn(x0);
    if (col + 1 < d) row[col + 1] = __float2bfloat16_rn(x1);
  }
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

}  // namespace
