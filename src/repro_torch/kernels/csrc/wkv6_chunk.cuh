// Building blocks shared by the chunked WKV-6 kernels: the forward's two-pass
// design (wkv6.cu) and the backward's (wkv6_bwd.cu).  Chunks of 64 steps,
// dk, dv <= 64, bf16 tiles copied with cp.async, the chunk-local cumulative
// sum of log_w in log2 units.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

#include "tensor_core.cuh"

namespace wkv6_chunk {

using bf16 = __nv_bfloat16;

constexpr int kMaxDim = 64;          // dk, dv <= 64
constexpr int kChunk = 64;           // L, steps per chunk
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ float tf32_value(float x) { return __uint_as_float(tc::to_tf32(x)); }
// A bf16 value as the 32-bit pattern of a TF32 operand (exact).
__device__ __forceinline__ uint32_t bf16_bits(bf16 x) {
  return __float_as_uint(__bfloat162float(x));
}

// Rows [0, len) of a chunk of a (T, n) bf16 matrix (`src` at the chunk's
// first row), columns [c0, c0 + cols), into a tile of `cols` columns and row
// stride `stride`, zero past len rows and n columns.  `vec`: n and c0 are
// multiples of 8 and the rows 16-byte aligned, so that the copy goes 16 bytes
// at a time with cp.async; otherwise element by element.
template <int kNumThreads>
__device__ __forceinline__ void load_chunk(bf16* dst, int stride, const bf16* src, int len, int n,
                                           int c0, int cols, bool vec) {
  if (vec) {
    const int per_row = cols / 8;
    for (int i = threadIdx.x; i < kChunk * per_row; i += kNumThreads) {
      const int t = i / per_row, c = (i % per_row) * 8;
      const bool in = t < len && c0 + c < n;
      // a slot past the data points at row 0, which exists, and reads no byte of it
      tc::cp_async16(dst + t * stride + c, src + (in ? t * n + c0 + c : 0), in ? 16 : 0);
    }
  } else {
    for (int i = threadIdx.x; i < kChunk * cols; i += kNumThreads) {
      const int t = i / cols, c = i % cols;
      dst[t * stride + c] =
          t < len && c0 + c < n ? src[t * n + c0 + c] : __float2bfloat16(0.f);
    }
  }
}

// c = cumulative sum of scale * x along the 64 steps of a chunk, per channel:
// x bf16 [t][d] (row stride sx), c f32 [t][d] (row stride sc).  kParts
// threads a channel (64 kParts threads in all), each adding 64 / kParts
// steps in order in registers, then the totals of the parts before it
// (`totals`: kParts x 64 floats of shared memory).  Zeros past len and dk keep
// c flat there.  Ends with the result visible to the block.
template <int kParts>
__device__ __forceinline__ void chunk_cumsum(const bf16* x, int sx, float* c, int sc, float scale,
                                             float* totals) {
  constexpr int kSteps = kChunk / kParts;
  const int d = threadIdx.x % kMaxDim;
  const int part = threadIdx.x / kMaxDim;
  float run[kSteps];
#pragma unroll
  for (int i = 0; i < kSteps; ++i) {
    run[i] = __bfloat162float(x[(part * kSteps + i) * sx + d]) * scale;
  }
#pragma unroll
  for (int i = 1; i < kSteps; ++i) run[i] += run[i - 1];
  totals[part * kMaxDim + d] = run[kSteps - 1];
  __syncthreads();
  float base = 0.f;
  for (int q = 0; q < part; ++q) base += totals[q * kMaxDim + d];
#pragma unroll
  for (int i = 0; i < kSteps; ++i) c[(part * kSteps + i) * sc + d] = base + run[i];
  __syncthreads();
}

__host__ __device__ inline bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

}  // namespace wkv6_chunk
