// RWKV-6 recurrence for NVIDIA Hopper (sm_90a), hand-written CUDA C++.
//
// Replaces the TPU kernel `_wkv6_kernel` of src/repro/kernels/wkv6/kernel.py,
// which `wkv6_fwd` launches there.  Per (batch, head), with the state S
// (dk x dv, f32), decay w_t = e^{log_w_t} and bonus u:
//     y_t = r_t^T (S_{t-1} + (u * k_t) v_t^T),   S_t = diag(w_t) S_{t-1} + k_t v_t^T.
// Unlike the TPU kernel it also takes an initial state s0, so that decode
// steps (T = 1) run it from the cache.
//
// The chunked form, as in the TPU kernel.  Within a chunk of L <= 64 steps,
// with c_t = sum_{tau <= t} log_w_tau (chunk-local, c_{-1} = 0):
//     A[t, j] = sum_d r_t[d] k_j[d] e^{c_{t-1}[d] - c_j[d]}   (j < t)
//     A[t, t] = sum_d r_t[d] u[d] k_t[d]                      (the bonus)
//     y_t     = sum_{j <= t} A[t, j] v_j + (r_t * e^{c_{t-1}})^T S_in
//     S_out   = e^{c_last} * S_in + sum_j (k_j * e^{c_last - c_j}) v_j^T
// Every exponent has the later index on the left, so with log_w <= 0 each is
// <= 0: every factor lies in [0, 1] and nothing overflows, even at
// log_w = -20 (a factor that underflows is 0, as it is in the step loop).
//
// What bounds it on the H100.  It reads r, k, v, log_w once, writes y once,
// and reads and writes the state once per call: at the serving shape
// (B*H = 160, T = 512, dk = dv = 64, bf16) ~58 MB, ~17 us at 3.35 TB/s.  The
// arithmetic is ~2.2 GFLOP in f32 plus ~130 M exps, on the CUDA cores here:
// the exps of A (one per (t, j < t, d)) and the block's 256 threads on one SM
// bound this first kernel, not the bytes.  Tensor-core products for A@V and
// r@S, and a second sweep to spread a head over SMs, are later work.
//
// Design.  One CTA per (batch, head) walks T in chunks; the TPU kernel's VMEM
// carry along its "arbitrary" time axis becomes that loop, with S in shared
// memory.  The TPU kernel materialises the (L, L, dk) decay tensor (1 MB at
// L = dk = 64), which does not fit in shared memory: here each A[t, j] is one
// thread's dot product over d, with the decay computed on the fly.  Threads
// take A's entries from the lower triangle only (p -> (t, j)), so all do the
// same work.  The ragged last chunk is a bound on t, not padding.  Tiles are
// kept in f32, rows of r, k and c padded to 65 floats so that a warp reading
// one column of 32 rows hits 32 banks.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxDim = 64;          // dk, dv <= 64
constexpr int kChunk = 64;           // L, steps per chunk
constexpr int kThreads = 256;
constexpr int kPad = kMaxDim + 1;    // row stride of the r, k, c tiles (floats)
constexpr int kAStride = kChunk + 1;  // row stride of A (floats)
constexpr size_t kSmemFloats =
    kMaxDim * kMaxDim + 3 * kChunk * kPad + kChunk * kMaxDim + kChunk * kAStride;
constexpr size_t kSmemBytes = kSmemFloats * sizeof(float);  // 99,328 bytes

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// Row t of the lower triangle entry p = t (t + 1) / 2 + j, 0 <= j <= t.
__device__ __forceinline__ int tri_row(int p) {
  int t = static_cast<int>((sqrtf(8.f * p + 1.f) - 1.f) * 0.5f);
  while ((t + 1) * (t + 2) / 2 <= p) ++t;
  while (t * (t + 1) / 2 > p) --t;
  return t;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
wkv6_kernel(const T* __restrict__ r, const T* __restrict__ k, const T* __restrict__ v,
            const T* __restrict__ log_w, const float* __restrict__ u,
            const float* __restrict__ s0, T* __restrict__ y, float* __restrict__ s_last,
            int heads, int steps, int dk, int dv) {
  extern __shared__ float smem[];
  float* S = smem;                       // [d][e], stride kMaxDim
  float* rs = S + kMaxDim * kMaxDim;     // [t][d], stride kPad
  float* ks = rs + kChunk * kPad;        // [t][d], stride kPad
  float* cs = ks + kChunk * kPad;        // [t][d], stride kPad: log_w, then c
  float* vs = cs + kChunk * kPad;        // [t][e], stride kMaxDim
  float* A = vs + kChunk * kMaxDim;      // [t][j], stride kAStride
  __shared__ float us[kMaxDim];
  __shared__ float clast[kMaxDim];

  const int bh = blockIdx.x;
  const int tid = threadIdx.x;
  const int64_t k_off = static_cast<int64_t>(bh) * steps * dk;
  const int64_t v_off = static_cast<int64_t>(bh) * steps * dv;
  const int64_t s_off = static_cast<int64_t>(bh) * dk * dv;

  for (int i = tid; i < dk * dv; i += kThreads) {
    S[(i / dv) * kMaxDim + i % dv] = s0 != nullptr ? s0[s_off + i] : 0.f;
  }
  for (int i = tid; i < dk; i += kThreads) us[i] = u[(bh % heads) * dk + i];

  for (int t0 = 0; t0 < steps; t0 += kChunk) {
    const int len = min(kChunk, steps - t0);
    __syncthreads();  // the previous chunk is done with the tiles
    const int64_t kc = k_off + static_cast<int64_t>(t0) * dk;
    for (int i = tid; i < len * dk; i += kThreads) {
      const int at = (i / dk) * kPad + i % dk;
      rs[at] = to_float(r[kc + i]);
      ks[at] = to_float(k[kc + i]);
      cs[at] = to_float(log_w[kc + i]);
    }
    const int64_t vc = v_off + static_cast<int64_t>(t0) * dv;
    for (int i = tid; i < len * dv; i += kThreads) {
      vs[(i / dv) * kMaxDim + i % dv] = to_float(v[vc + i]);
    }
    __syncthreads();

    // c = cumulative sum of log_w along the chunk, per channel
    for (int d = tid; d < dk; d += kThreads) {
      float acc = 0.f;
      for (int t = 0; t < len; ++t) {
        acc += cs[t * kPad + d];
        cs[t * kPad + d] = acc;
      }
      clast[d] = acc;
    }
    __syncthreads();

    // A over the lower triangle, the bonus on its diagonal
    const int pairs = len * (len + 1) / 2;
    for (int p = tid; p < pairs; p += kThreads) {
      const int t = tri_row(p);
      const int j = p - t * (t + 1) / 2;
      const float* rt = rs + t * kPad;
      const float* kj = ks + j * kPad;
      float acc = 0.f;
      if (j < t) {
        const float* cp = cs + (t - 1) * kPad;
        const float* cj = cs + j * kPad;
        for (int d = 0; d < dk; ++d) acc += rt[d] * kj[d] * expf(cp[d] - cj[d]);
      } else {
        for (int d = 0; d < dk; ++d) acc += rt[d] * us[d] * kj[d];
      }
      A[t * kAStride + j] = acc;
    }
    __syncthreads();

    // r_t <- r_t * e^{c_{t-1}} (reads S_in), k_j <- k_j * e^{c_last - c_j} (feeds S_out)
    for (int i = tid; i < len * dk; i += kThreads) {
      const int t = i / dk, d = i % dk;
      if (t > 0) rs[t * kPad + d] *= expf(cs[(t - 1) * kPad + d]);
      ks[t * kPad + d] *= expf(clast[d] - cs[t * kPad + d]);
    }
    __syncthreads();

    // y_t = sum_{j <= t} A[t, j] v_j + r_t^T S_in
    for (int i = tid; i < len * dv; i += kThreads) {
      const int t = i / dv, e = i % dv;
      const float* at = A + t * kAStride;
      const float* rt = rs + t * kPad;
      float acc = 0.f;
      for (int j = 0; j <= t; ++j) acc += at[j] * vs[j * kMaxDim + e];
      for (int d = 0; d < dk; ++d) acc += rt[d] * S[d * kMaxDim + e];
      y[vc + i] = from_float<T>(acc);
    }
    __syncthreads();

    // S_out = e^{c_last} * S_in + sum_j k_j v_j^T (k already scaled)
    for (int i = tid; i < dk * dv; i += kThreads) {
      const int d = i / dv, e = i % dv;
      float acc = expf(clast[d]) * S[d * kMaxDim + e];
      for (int j = 0; j < len; ++j) acc += ks[j * kPad + d] * vs[j * kMaxDim + e];
      S[d * kMaxDim + e] = acc;
    }
  }
  __syncthreads();
  for (int i = tid; i < dk * dv; i += kThreads) s_last[s_off + i] = S[(i / dv) * kMaxDim + i % dv];
}

template <typename T>
cudaError_t launch(const void* r, const void* k, const void* v, const void* log_w, const void* u,
                   const void* s0, void* y, void* s_last, int batch_heads, int heads, int steps,
                   int dk, int dv, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      wkv6_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(kSmemBytes));
  if (err != cudaSuccess) return err;
  wkv6_kernel<T><<<batch_heads, kThreads, kSmemBytes, stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(log_w), static_cast<const float*>(u), static_cast<const float*>(s0),
      static_cast<T*>(y), static_cast<float*>(s_last), heads, steps, dk, dv);
  return cudaGetLastError();
}

}  // namespace

// r, k, log_w (B, H, T, dk), v (B, H, T, dv) contiguous, all f32 (is_bf16 = 0) or
// all bf16; u (H, dk) f32; s0 (B, H, dk, dv) f32 or null (zeros); 1 <= dk, dv
// <= 64.  Writes y (B, H, T, dv) in the input type and s_last (B, H, dk, dv)
// f32.  Launches on `stream` and returns the launch's cudaError_t (0 on success).
extern "C" int wkv6_fwd(const void* r, const void* k, const void* v, const void* log_w,
                        const void* u, const void* s0, void* y, void* s_last, int batch_heads,
                        int heads, int steps, int dk, int dv, int is_bf16, void* stream) {
  if (dk < 1 || dk > kMaxDim || dv < 1 || dv > kMaxDim) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    return launch<__nv_bfloat16>(r, k, v, log_w, u, s0, y, s_last, batch_heads, heads, steps,
                                 dk, dv, s);
  }
  return launch<float>(r, k, v, log_w, u, s0, y, s_last, batch_heads, heads, steps, dk, dv, s);
}
