// RG-LRU linear recurrence for NVIDIA Hopper (sm_90a), hand-written CUDA C++.
//
// Replaces the TPU kernel `_rg_lru_kernel` of src/repro/kernels/rg_lru/kernel.py,
// which `rg_lru_fwd` launches there: h_t = a_t * h_{t-1} + b_t elementwise over
// D, y[:, t] = h_t in the input type, and the f32 h_last.  Unlike the TPU
// kernel it also takes an initial state h0, so that decode steps (T = 1) run
// it from the cache.
//
// What bounds it on the H100.  Each element of a and b is read once and each
// of y written once, with one multiply and one add between: bytes bound it.
// At the serving shape (B = 4, T = 512, D = 4096, f32) that is ~101 MB, ~30 us
// at 3.35 TB/s.  But the recurrence is a dependent chain along T, and this
// first kernel walks it in one thread per (b, d) lane: 16,384 lanes of 512
// steps leave most of the card idle, so latency, not bandwidth, sets its time.
// A chunked two-pass scan (local scans, then a carry pass) is later work.
//
// Design.  One thread per (b, d) lane, consecutive threads on consecutive d,
// so every step's loads and stores coalesce.  h lives in a register, from h0
// or 0.  The thread walks T in groups of kUnroll steps: it loads the group's
// a and b first, then runs the chain, so the loads of a group are in flight
// together.  The TPU kernel's padding (a = 1, b = 0) becomes a bound on t, its
// VMEM carry along the "arbitrary" time axis the register.  Multiply and add
// are rounded one by one (no FMA contraction), as the plain version computes
// them, so in f32 the two agree bit for bit.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kUnroll = 8;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
rg_lru_kernel(const T* __restrict__ a, const T* __restrict__ b, const float* __restrict__ h0,
              T* __restrict__ y, float* __restrict__ h_last, int batch, int steps, int d) {
  const int64_t lane = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (lane >= static_cast<int64_t>(batch) * d) return;
  const int64_t bi = lane / d;
  const int64_t base = bi * steps * d + (lane - bi * d);  // element (bi, t = 0, di)
  float h = h0 != nullptr ? h0[lane] : 0.f;
  for (int t0 = 0; t0 < steps; t0 += kUnroll) {
    float av[kUnroll], bv[kUnroll];
#pragma unroll
    for (int i = 0; i < kUnroll; ++i) {
      if (t0 + i < steps) {
        const int64_t idx = base + static_cast<int64_t>(t0 + i) * d;
        av[i] = to_float(a[idx]);
        bv[i] = to_float(b[idx]);
      }
    }
#pragma unroll
    for (int i = 0; i < kUnroll; ++i) {
      if (t0 + i < steps) {
        h = __fadd_rn(__fmul_rn(av[i], h), bv[i]);
        y[base + static_cast<int64_t>(t0 + i) * d] = from_float<T>(h);
      }
    }
  }
  h_last[lane] = h;
}

template <typename T>
cudaError_t launch(const void* a, const void* b, const void* h0, void* y, void* h_last,
                   int batch, int steps, int d, cudaStream_t stream) {
  const int64_t lanes = static_cast<int64_t>(batch) * d;
  const unsigned blocks = static_cast<unsigned>((lanes + kThreads - 1) / kThreads);
  rg_lru_kernel<T><<<blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(a), static_cast<const T*>(b), static_cast<const float*>(h0),
      static_cast<T*>(y), static_cast<float*>(h_last), batch, steps, d);
  return cudaGetLastError();
}

}  // namespace

// a, b (B, T, D) contiguous, both f32 (is_bf16 = 0) or both bf16; h0 (B, D) f32
// or null (zeros).  Writes y (B, T, D) in the input type and h_last (B, D) f32.
// Launches on `stream` and returns the launch's cudaError_t (0 on success).
extern "C" int rg_lru_fwd(const void* a, const void* b, const void* h0, void* y, void* h_last,
                          int batch, int steps, int d, int is_bf16, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) return launch<__nv_bfloat16>(a, b, h0, y, h_last, batch, steps, d, s);
  return launch<float>(a, b, h0, y, h_last, batch, steps, d, s);
}
