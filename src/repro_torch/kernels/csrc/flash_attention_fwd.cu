// Flash-attention forward for NVIDIA Hopper (sm_90a), hand-written CUDA C++.
//
// Replaces the TPU kernel `_flash_kernel` of
// src/repro/kernels/flash_attention/kernel.py, which `flash_attention_fwd_lse`
// launches there: online-softmax attention that also returns the f32
// logsumexp, with causal, sliding-window or bidirectional masks, GQA (query
// head h reads kv head h / group) and a key bound at the real key length.
//
// What bounds it on the H100.  At the serving shape (B=4, H=32, S=512, D=80,
// causal, bf16) the function needs ~5.4 GFLOP against ~42 MB of Q, K, V and O:
// a tensor-core kernel would be bound by memory, at ~12.5 us for 3.35 TB/s.
// This first kernel does its arithmetic in f32 on the CUDA cores, not on the
// tensor cores, so its own limit is the CUDA cores' FMA rate and the
// shared-memory reads that feed them.  `wgmma`, TMA and warp specialisation
// are later work; this version is simple and exact first.
//
// Design.  One CTA per (batch * query head, 64-query tile), 8 warps of 8 query
// rows each.  The CTA loops over the 64-key tiles that the mask leaves live:
// loop bounds from causal, window, off = sk - sq and sk take the place of the
// TPU kernel's pl.when tile skipping.  K and V tiles are staged in shared
// memory as f32 (K rows padded to D + 1 floats so a warp reading one column
// hits 32 banks).  Lane j scores keys j and j + 32 of the tile for its warp's
// 8 rows; the running max, sum and output accumulator stay in registers, and
// the probabilities reach the P.V product by warp shuffles.  Masked scores
// take the finite -1e30 and the denominator is clamped at 1e-30, as in the TPU
// kernel, so the logsumexp agrees with it.  The ragged edges of Sq and Sk are
// masked here; nothing is padded.  Shared memory is (64 D + 64 (D + 1) + 64 D)
// floats: 60 KB at D = 80 and 192 KB at D = 256, set per launch as dynamic
// shared memory.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlockQ = 64;
constexpr int kBlockK = 64;
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kRows = kBlockQ / kWarps;  // query rows per warp
constexpr float kNegInf = -1e30f;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) * static_cast<size_t>(kBlockQ * D + kBlockK * (D + 1) + kBlockK * D);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 T* __restrict__ o, float* __restrict__ lse, int hq, int group, int sq,
                 int sk, float scale, bool causal, bool use_window, int window) {
  constexpr int kStride = D + 1;         // padded K row
  constexpr int kCols = (D + 31) / 32;   // output columns per lane
  extern __shared__ float smem[];
  float* q_s = smem;                     // kBlockQ x D
  float* k_s = q_s + kBlockQ * D;        // kBlockK x kStride
  float* v_s = k_s + kBlockK * kStride;  // kBlockK x D

  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * kBlockQ;
  const int hkv = hq / group;
  const int64_t kv_bh = static_cast<int64_t>(bh / hq) * hkv + (bh % hq) / group;
  const T* q_g = q + static_cast<int64_t>(bh) * sq * D;
  const T* k_g = k + kv_bh * sk * D;
  const T* v_g = v + kv_bh * sk * D;
  const int off = sk - sq;
  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int row0 = (tid / 32) * kRows;   // this warp's first row in the tile

  for (int i = tid; i < kBlockQ * D; i += kThreads) {
    q_s[i] = q0 + i / D < sq ? to_float(q_g[static_cast<int64_t>(q0) * D + i]) : 0.f;
  }

  // Keys that some query of this tile may attend: [k_lo, k_hi).
  const int q_last = min(q0 + kBlockQ, sq) - 1;
  int k_lo = 0;
  int k_hi = sk;
  if (causal) k_hi = min(k_hi, q_last + off + 1);
  if (use_window) k_lo = max(k_lo, q0 + off - window + 1);

  float m[kRows], l[kRows], acc[kRows][kCols];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[i][c] = 0.f;
  }

  const int kt_begin = k_lo < k_hi ? (k_lo / kBlockK) * kBlockK : k_hi;
  for (int kt = kt_begin; kt < k_hi; kt += kBlockK) {
    __syncthreads();  // q_s is written and the previous K/V tile consumed
    const int64_t base = static_cast<int64_t>(kt) * D;
    for (int i = tid; i < kBlockK * D; i += kThreads) {
      const int r = i / D;
      const bool in = kt + r < sk;
      k_s[r * kStride + (i - r * D)] = in ? to_float(k_g[base + i]) : 0.f;
      v_s[i] = in ? to_float(v_g[base + i]) : 0.f;
    }
    __syncthreads();

    // s[i][j]: row row0 + i against key kt + lane + 32 j.
    float s[kRows][2];
#pragma unroll
    for (int i = 0; i < kRows; ++i) s[i][0] = s[i][1] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      const float k0 = k_s[lane * kStride + d];
      const float k1 = k_s[(lane + 32) * kStride + d];
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const float qv = q_s[(row0 + i) * D + d];
        s[i][0] = fmaf(qv, k0, s[i][0]);
        s[i][1] = fmaf(qv, k1, s[i][1]);
      }
    }

#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int qpos = q0 + row0 + i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int kpos = kt + lane + 32 * j;
        bool live = kpos < sk;
        if (causal) live = live && kpos <= qpos + off;
        if (use_window) live = live && kpos > qpos + off - window;
        s[i][j] = live ? s[i][j] * scale : kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int w = 16; w > 0; w >>= 1) mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, w));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      s[i][0] = expf(s[i][0] - m_new);
      s[i][1] = expf(s[i][1] - m_new);
      float sum = s[i][0] + s[i][1];
#pragma unroll
      for (int w = 16; w > 0; w >>= 1) sum += __shfl_xor_sync(kFull, sum, w);
      l[i] = alpha * l[i] + sum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < kCols; ++c) acc[i][c] *= alpha;
    }

    // acc[i][c] += sum_j p[i][j] * V[j][lane + 32 c]; p[i][j] lives in lane j % 32.
#pragma unroll
    for (int half = 0; half < 2; ++half) {
#pragma unroll 4
      for (int jj = 0; jj < 32; ++jj) {
        const float* v_row = v_s + (half * 32 + jj) * D;
        float vv[kCols];
#pragma unroll
        for (int c = 0; c < kCols; ++c) {
          const int d = lane + 32 * c;
          vv[c] = d < D ? v_row[d] : 0.f;
        }
#pragma unroll
        for (int i = 0; i < kRows; ++i) {
          const float p = __shfl_sync(kFull, s[i][half], jj);
#pragma unroll
          for (int c = 0; c < kCols; ++c) acc[i][c] = fmaf(p, vv[c], acc[i][c]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int qpos = q0 + row0 + i;
    if (qpos >= sq) continue;
    const float denom = fmaxf(l[i], 1e-30f);
    T* o_row = o + (static_cast<int64_t>(bh) * sq + qpos) * D;
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      const int d = lane + 32 * c;
      if (d < D) o_row[d] = from_float<T>(acc[i][c] / denom);
    }
    if (lane == 0) lse[static_cast<int64_t>(bh) * sq + qpos] = m[i] + logf(denom);
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, void* lse, int b,
                   int hq, int hkv, int sq, int sk, float scale, int causal, int use_window,
                   int window, cudaStream_t stream) {
  const size_t smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((sq + kBlockQ - 1) / kBlockQ, b * hq);
  flash_fwd_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), static_cast<float*>(lse), hq, hq / hkv, sq, sk, scale, causal != 0,
      use_window != 0, window);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_head_dim(const void* q, const void* k, const void* v, void* o, void* lse,
                              int b, int hq, int hkv, int sq, int sk, int d, float scale,
                              int causal, int use_window, int window, cudaStream_t stream) {
#define FLASH_CASE(DIM) \
  case DIM:             \
    return launch<T, DIM>(q, k, v, o, lse, b, hq, hkv, sq, sk, scale, causal, use_window, window, stream);
  switch (d) {
    FLASH_CASE(16)
    FLASH_CASE(32)
    FLASH_CASE(64)
    FLASH_CASE(80)
    FLASH_CASE(128)
    FLASH_CASE(256)
    default:
      return cudaErrorInvalidValue;
  }
#undef FLASH_CASE
}

}  // namespace

// q (B, Hq, Sq, D), k/v (B, Hkv, Sk, D) contiguous, f32 (is_bf16 = 0) or bf16;
// writes o (B, Hq, Sq, D) in the input type and lse (B, Hq, Sq) f32.  Launches
// on `stream` and returns the launch's cudaError_t (0 on success).
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                                   void* lse, int b, int hq, int hkv, int sq, int sk, int d,
                                   int is_bf16, float scale, int causal, int use_window,
                                   int window, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    return dispatch_head_dim<__nv_bfloat16>(q, k, v, o, lse, b, hq, hkv, sq, sk, d, scale, causal,
                                            use_window, window, s);
  }
  return dispatch_head_dim<float>(q, k, v, o, lse, b, hq, hkv, sq, sk, d, scale, causal,
                                  use_window, window, s);
}
