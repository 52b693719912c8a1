// What the attention kernels of this directory share (short_attention.cu,
// flash_attention.cu): the (B, L, H, D) operand with its row and set
// distances, the staging of one head's rows into shared memory, and the
// masking constants. float32, sm_90a.
//
// -1e9 is added to the score of a masked key, never -inf, so a set whose keys
// are all masked gets uniform weights and stays finite; in float32 the sum
// s + (-1e9) rounds the score away, as in the plain versions. exp goes
// through exp2 with the log2 e factor applied after the mask was added, which
// keeps that rounding the same.

#pragma once

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr float kNeg = 1e9f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kMaxSmem = 232448;  // bytes a block may use on sm_90

// q, k or v: (B, L, H, D) with (H, D) packed; `bs` and `ld` are the distances
// in elements between sets and between rows. `vec`: rows may be read as float4.
struct Heads {
  const float* p;
  long long bs, ld;
  bool vec;
};

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

// Stage `rows` rows of one head (d wide) into shared memory at a row stride of
// `stride` floats; columns d..DP-1 and rows rows..rows_p-1 become zero.
template <int DP>
__device__ __forceinline__ void stage_head(float* dst, int stride, const float* src,
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

Heads heads(const float* p, long long bs, long long ld, int d) {
  const bool vec = d % 4 == 0 && bs % 4 == 0 && ld % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(p) % 16 == 0;
  return Heads{p, bs, ld, vec};
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

}  // namespace
