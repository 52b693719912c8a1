// What the attention kernels of this directory share (short_attention.cu,
// flash_attention.cu): the (B, L, H, D) operand with its row and set
// distances, the staging of one head's rows into shared memory, and the
// masking constants. Operands in float32 or bfloat16 (read into float32),
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

// exp(x) for x <= 0 (or -inf)
__device__ __forceinline__ float exp_neg(float x) { return exp2f(x * kLog2e); }

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
