// RWKV-6 recurrence, the backward (B5'), for NVIDIA Hopper (sm_90a), hand-written
// CUDA C++.
//
// The JAX op has no backward kernel: its custom_vjp differentiates the jnp
// reference scan (src/repro/kernels/wkv6/ops.py:25).  Per (batch, head), with
// G_t the gradient of the state S_t (G_{T-1} = gs_last, or 0), for t = T-1 .. 0:
//     dr_t[i]     = sum_j gy_t[j] (S_{t-1}[i,j] + u_i k_t[i] v_t[j])
//     dk_t[i]     = sum_j G_t[i,j] v_t[j] + u_i r_t[i] (v_t . gy_t)
//     dv_t[j]     = sum_i k_t[i] (G_t[i,j] + u_i r_t[i] gy_t[j])
//     dlog_w_t[i] = w_t[i] sum_j G_t[i,j] S_{t-1}[i,j]
//     du[i]      += r_t[i] k_t[i] (v_t . gy_t)            (over batch and time)
//     G_{t-1}     = diag(w_t) G_t + r_t gy_t^T
// and ds0 = G_{-1}.
//
// The decay is diagonal, so row i of S and of G is a recurrence of its own
// over a dv-vector: only dv (a sum over rows) and du (a sum over the batch)
// cross rows.  Three kernels:
//   wkv6_bwd_entry_kernel (only when the forward left no states): the state
//     entering each 64-step chunk, walked forward from s0, into `states`
//     (B*H, n_chunks, 64, 64) f32, the layout of the two-pass forward's
//     workspace, which the op keeps for the bf16 path (wkv6.cu).  That
//     workspace holds the states rounded to TF32 (relative 2^-11), as the
//     forward's output pass used them; the bf16 gradients round to 2^-9.
//     Writing them unrounded cost the forward 1.1-4.5% on the card, so the
//     backward takes them as they are.
//   wkv6_bwd_kernel: grid (B*H, row blocks of 16), 256 threads, thread
//     (row, 4 columns).  It walks the chunks backwards; per chunk it copies
//     r, k, e^{log_w} of its rows and v, gy of all columns into shared memory,
//     walks the chunk forward from its entry state keeping the state entering
//     each 16-step sub-block (16 KB), then per sub-block, last first,
//     recomputes the 16 states in registers and walks them backwards.  The
//     row sums (dr, dk, dlog_w) are warp shuffles over the 16 threads of a
//     row; the column sums of dv over the CTA's 16 rows go through shared
//     memory and leave as one partial per row block.
//   wkv6_bwd_reduce_kernel: dv as the sum of the row blocks' partials, and du
//     as the sum over the batch of the per-(batch, head) sums, each in a
//     fixed order.  No atomics anywhere: two runs give the same bits.
//
// What bounds it on the H100.  At the training shape (B*H = 320, T = 512,
// dk = dv = 64, bf16) it reads r, k, v, log_w, gy and the chunk-entry states
// (42 MB) and writes dr, dk, dv, dlog_w: ~236 MB, 0.070 ms at 3.35 TB/s.  Its
// arithmetic (14 operations a state entry and step: the backward's 11 and
// one recompute of the state's 3; 9.5 GFLOP) is on the CUDA cores in f32,
// 0.143 ms at 67 TFLOP/s: operations bound it.  This design does them with
// 16 shuffles a step and thread besides, and recomputes each state twice.  Products stay f32 on the CUDA cores; a chunked form on the tensor
// cores is later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

#include "launch.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kMaxDim = 64;                     // dk, dv <= 64
constexpr int kChunk = 64;                      // steps per chunk, as the forward's
constexpr int kRows = 16;                       // rows of S a CTA
constexpr int kCols = 4;                        // columns a thread
constexpr int kRowThreads = kMaxDim / kCols;    // 16 threads a row
constexpr int kThreads = kRows * kRowThreads;   // 256
constexpr int kWarps = kThreads / 32;           // 8: warp w holds rows 2w, 2w + 1
constexpr int kSub = 16;                        // steps whose states sit in registers
constexpr int kSubs = kChunk / kSub;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(bf16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) { return x; }
template <> __device__ __forceinline__ bf16 from_float<bf16>(float x) {
  return __float2bfloat16(x);
}

struct Smem {
  float r[kChunk][kRows];              // the CTA's rows of a chunk
  float k[kChunk][kRows];
  float w[kChunk][kRows];              // e^{log_w}
  float v[kChunk][kMaxDim];            // every column of a chunk
  float gy[kChunk][kMaxDim];
  float vg[kChunk];                    // v_t . gy_t
  float out[3][kChunk][kRows];         // dr, dk, dlog_w of the chunk
  float4 ck[kSubs][kThreads];          // each thread's state entering each sub-block
  float4 pdv[kSub][kWarps][kRowThreads];  // a sub-block's dv, summed over a warp's rows
};
constexpr size_t kSmemBytes = sizeof(Smem);  // 106,752 bytes: two CTAs an SM

// Chunk [t0, t0 + len) into shared memory: k and e^{log_w} of rows [row0,
// row0 + 16) and every column of v, and with `grads` r and gy too.  Steps
// past len, rows past dk and columns past dv read as k = r = v = gy = 0 and
// w = 1, which leaves S and G as they are.
template <typename T>
__device__ __forceinline__ void load_chunk(Smem& sm, const T* __restrict__ r,
                                           const T* __restrict__ k, const T* __restrict__ lw,
                                           const T* __restrict__ v, const T* __restrict__ gy,
                                           int64_t bh, int steps, int t0, int len, int dk,
                                           int dv, int row0, bool grads) {
  for (int idx = threadIdx.x; idx < kChunk * kRows; idx += kThreads) {
    const int t = idx / kRows, i = idx % kRows;
    const bool in = t < len && row0 + i < dk;
    const int64_t at = in ? (bh * steps + t0 + t) * dk + row0 + i : 0;
    sm.k[t][i] = in ? to_float(k[at]) : 0.f;
    sm.w[t][i] = in ? expf(to_float(lw[at])) : 1.f;
    if (grads) sm.r[t][i] = in ? to_float(r[at]) : 0.f;
  }
  for (int idx = threadIdx.x; idx < kChunk * kMaxDim; idx += kThreads) {
    const int t = idx / kMaxDim, j = idx % kMaxDim;
    const bool in = t < len && j < dv;
    const int64_t at = in ? (bh * steps + t0 + t) * dv + j : 0;
    sm.v[t][j] = in ? to_float(v[at]) : 0.f;
    if (grads) sm.gy[t][j] = in ? to_float(gy[at]) : 0.f;
  }
}

// S <- w S + k v for one step of this thread's row and columns.
__device__ __forceinline__ void advance(float (&S)[kCols], const Smem& sm, int t, int ri,
                                        int j0) {
  const float kk = sm.k[t][ri], ww = sm.w[t][ri];
  const float4 vv = *reinterpret_cast<const float4*>(&sm.v[t][j0]);
  S[0] = __fmaf_rn(ww, S[0], kk * vv.x);
  S[1] = __fmaf_rn(ww, S[1], kk * vv.y);
  S[2] = __fmaf_rn(ww, S[2], kk * vv.z);
  S[3] = __fmaf_rn(ww, S[3], kk * vv.w);
}

// The state entering each chunk, walked forward from s0 (or 0).
// grid = (B*H, row blocks).
template <typename T>
__global__ void __launch_bounds__(kThreads)
wkv6_bwd_entry_kernel(const T* __restrict__ k, const T* __restrict__ v,
                      const T* __restrict__ lw, const float* __restrict__ s0,
                      float* __restrict__ states, int steps, int dk, int dv) {
  extern __shared__ __align__(16) unsigned char raw[];
  Smem& sm = *reinterpret_cast<Smem*>(raw);
  const int64_t bh = blockIdx.x;
  const int row0 = blockIdx.y * kRows;
  const int ri = threadIdx.x / kRowThreads;
  const int j0 = (threadIdx.x % kRowThreads) * kCols;
  const int i = row0 + ri;
  const int n_chunks = (steps + kChunk - 1) / kChunk;
  float S[kCols];
#pragma unroll
  for (int c = 0; c < kCols; ++c) {
    S[c] = s0 != nullptr && i < dk && j0 + c < dv ? s0[(bh * dk + i) * dv + j0 + c] : 0.f;
  }
  for (int c = 0; c < n_chunks; ++c) {
    *reinterpret_cast<float4*>(states + ((bh * n_chunks + c) * kMaxDim + i) * kMaxDim + j0) =
        make_float4(S[0], S[1], S[2], S[3]);
    if (c + 1 == n_chunks) break;
    __syncthreads();  // the previous chunk is done with the tiles
    load_chunk<T>(sm, nullptr, k, lw, v, nullptr, bh, steps, c * kChunk, kChunk, dk, dv, row0,
                  false);
    __syncthreads();
    for (int t = 0; t < kChunk; ++t) advance(S, sm, t, ri, j0);
  }
}

// The reverse walk.  grid = (B*H, row blocks), 256 threads: thread (ri, cg)
// holds row row0 + ri, columns 4 cg .. 4 cg + 3.
template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
wkv6_bwd_kernel(const T* __restrict__ r, const T* __restrict__ k, const T* __restrict__ v,
                const T* __restrict__ lw, const float* __restrict__ u, const T* __restrict__ gy,
                const float* __restrict__ gs_last, const float* __restrict__ states,
                T* __restrict__ dr, T* __restrict__ dk_out, T* __restrict__ dlw,
                float* __restrict__ ds0, float* __restrict__ dv_part,
                float* __restrict__ du_part, int heads, int steps, int dk, int dv) {
  extern __shared__ __align__(16) unsigned char raw[];
  Smem& sm = *reinterpret_cast<Smem*>(raw);
  const int64_t bh = blockIdx.x;
  const int rb = blockIdx.y;
  const int row0 = rb * kRows;
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int ri = tid / kRowThreads;
  const int cg = tid % kRowThreads;
  const int j0 = cg * kCols;
  const int i = row0 + ri;
  const bool row_live = i < dk;
  const int n_chunks = (steps + kChunk - 1) / kChunk;
  const float ui = row_live ? u[(bh % heads) * dk + i] : 0.f;

  float G[kCols];
#pragma unroll
  for (int c = 0; c < kCols; ++c) {
    G[c] = gs_last != nullptr && row_live && j0 + c < dv
               ? gs_last[(bh * dk + i) * dv + j0 + c] : 0.f;
  }
  float du_acc = 0.f;

  for (int chunk = n_chunks - 1; chunk >= 0; --chunk) {
    const int t0 = chunk * kChunk;
    const int len = min(kChunk, steps - t0);
    __syncthreads();  // the previous chunk is done with shared memory
    load_chunk<T>(sm, r, k, lw, v, gy, bh, steps, t0, len, dk, dv, row0, true);
    __syncthreads();
    {  // v_t . gy_t: four threads a step, 16 columns each, in a fixed order
      const int t = tid / 4, q = tid % 4;
      float acc = 0.f;
#pragma unroll
      for (int c = 0; c < 16; ++c) acc += sm.v[t][q * 16 + c] * sm.gy[t][q * 16 + c];
      acc += __shfl_xor_sync(kFull, acc, 1);
      acc += __shfl_xor_sync(kFull, acc, 2);
      if (q == 0) sm.vg[t] = acc;
    }
    {  // the state entering each sub-block, from the chunk's entry state
      const float4 e = *reinterpret_cast<const float4*>(
          states + ((bh * n_chunks + chunk) * kMaxDim + i) * kMaxDim + j0);
      float S[kCols] = {e.x, e.y, e.z, e.w};
      for (int q = 0; q < kSubs; ++q) {
        sm.ck[q][tid] = make_float4(S[0], S[1], S[2], S[3]);
        if (q + 1 < kSubs) {
#pragma unroll 4
          for (int s = 0; s < kSub; ++s) advance(S, sm, q * kSub + s, ri, j0);
        }
      }
    }
    __syncthreads();  // vg is visible
    for (int q = kSubs - 1; q >= 0; --q) {
      float st[kSub][kCols];  // st[s] = S_{t-1} for step t = q kSub + s
      {
        const float4 e = sm.ck[q][tid];
        float S[kCols] = {e.x, e.y, e.z, e.w};
#pragma unroll
        for (int s = 0; s < kSub; ++s) {
#pragma unroll
          for (int c = 0; c < kCols; ++c) st[s][c] = S[c];
          if (s + 1 < kSub) advance(S, sm, q * kSub + s, ri, j0);
        }
      }
#pragma unroll
      for (int s = kSub - 1; s >= 0; --s) {
        const int t = q * kSub + s;
        const float4 g4 = *reinterpret_cast<const float4*>(&sm.gy[t][j0]);
        const float4 v4 = *reinterpret_cast<const float4*>(&sm.v[t][j0]);
        const float gyv[kCols] = {g4.x, g4.y, g4.z, g4.w};
        const float vv[kCols] = {v4.x, v4.y, v4.z, v4.w};
        const float rr = sm.r[t][ri], kk = sm.k[t][ri], ww = sm.w[t][ri];
        const float ur = ui * rr;
        float pr = 0.f, pk = 0.f, pw = 0.f, pdv[kCols];
#pragma unroll
        for (int c = 0; c < kCols; ++c) {
          pr = __fmaf_rn(gyv[c], st[s][c], pr);
          pk = __fmaf_rn(G[c], vv[c], pk);
          pw = __fmaf_rn(G[c], st[s][c], pw);
          pdv[c] = kk * __fmaf_rn(ur, gyv[c], G[c]);
          G[c] = __fmaf_rn(ww, G[c], rr * gyv[c]);
        }
#pragma unroll
        for (int o = kRowThreads / 2; o > 0; o >>= 1) {  // over the row's 16 threads
          pr += __shfl_xor_sync(kFull, pr, o);
          pk += __shfl_xor_sync(kFull, pk, o);
          pw += __shfl_xor_sync(kFull, pw, o);
        }
#pragma unroll
        for (int c = 0; c < kCols; ++c) pdv[c] += __shfl_xor_sync(kFull, pdv[c], 16);
        if (lane < kRowThreads) sm.pdv[s][warp][cg] = make_float4(pdv[0], pdv[1], pdv[2], pdv[3]);
        if (cg == 0) {
          const float vg = sm.vg[t];
          sm.out[0][t][ri] = __fmaf_rn(ui * kk, vg, pr);
          sm.out[1][t][ri] = __fmaf_rn(ur, vg, pk);
          sm.out[2][t][ri] = ww * pw;
          du_acc = __fmaf_rn(rr * kk, vg, du_acc);
        }
      }
      __syncthreads();  // the sub-block's dv partials are complete
      const float* pdv_f = reinterpret_cast<const float*>(sm.pdv);
      for (int idx = tid; idx < kSub * kMaxDim; idx += kThreads) {
        const int s = idx / kMaxDim, j = idx % kMaxDim;
        const int t = q * kSub + s;
        if (t < len && j < dv) {
          float acc = 0.f;
#pragma unroll
          for (int w8 = 0; w8 < kWarps; ++w8) acc += pdv_f[(s * kWarps + w8) * kMaxDim + j];
          dv_part[((bh * gridDim.y + rb) * steps + t0 + t) * kMaxDim + j] = acc;
        }
      }
      __syncthreads();  // read before the next sub-block writes them
    }
    for (int idx = tid; idx < len * kRows; idx += kThreads) {
      const int t = idx / kRows, ii = idx % kRows;
      if (row0 + ii < dk) {
        const int64_t at = (bh * steps + t0 + t) * dk + row0 + ii;
        dr[at] = from_float<T>(sm.out[0][t][ii]);
        dk_out[at] = from_float<T>(sm.out[1][t][ii]);
        dlw[at] = from_float<T>(sm.out[2][t][ii]);
      }
    }
  }
#pragma unroll
  for (int c = 0; c < kCols; ++c) {
    if (row_live && j0 + c < dv) ds0[(bh * dk + i) * dv + j0 + c] = G[c];
  }
  if (cg == 0 && row_live) du_part[bh * dk + i] = du_acc;
}

// dv = the sum of the row blocks' partials, du = the sum over the batch,
// each in a fixed order.
template <typename T>
__global__ void __launch_bounds__(256)
wkv6_bwd_reduce_kernel(const float* __restrict__ dv_part, const float* __restrict__ du_part,
                       T* __restrict__ dv_out, float* __restrict__ du, int batch, int heads,
                       int steps, int dk, int dv, int row_blocks) {
  const int64_t idx = static_cast<int64_t>(blockIdx.x) * 256 + threadIdx.x;
  const int64_t n_dv = static_cast<int64_t>(batch) * heads * steps * dv;
  if (idx < n_dv) {
    const int64_t bh_t = idx / dv;
    const int j = static_cast<int>(idx - bh_t * dv);
    const int64_t bh = bh_t / steps;
    const int64_t t = bh_t - bh * steps;
    float acc = 0.f;
    for (int rb = 0; rb < row_blocks; ++rb) {
      acc += dv_part[((bh * row_blocks + rb) * steps + t) * kMaxDim + j];
    }
    dv_out[idx] = from_float<T>(acc);
  } else if (idx < n_dv + static_cast<int64_t>(heads) * dk) {
    const int e = static_cast<int>(idx - n_dv);
    const int h = e / dk, i = e % dk;
    float acc = 0.f;
    for (int b = 0; b < batch; ++b) acc += du_part[(static_cast<int64_t>(b) * heads + h) * dk + i];
    du[e] = acc;
  }
}

template <typename T>
cudaError_t run(const void* r, const void* k, const void* v, const void* log_w, const void* u,
                const void* s0, const void* gy, const void* gs_last, void* states,
                bool have_states, void* dr, void* dk_out, void* dv_out, void* dlog_w, void* du,
                void* ds0, void* dv_part, void* du_part, int batch, int heads, int steps, int dk,
                int dv, cudaStream_t stream) {
  static std::atomic<unsigned long long> entry_set{0}, main_set{0};
  const dim3 grid(batch * heads, (dk + kRows - 1) / kRows);
  const T* tk = static_cast<const T*>(k);
  const T* tv = static_cast<const T*>(v);
  const T* tl = static_cast<const T*>(log_w);
  cudaError_t err;
  if (!have_states) {
    err = launch::max_dynamic_smem_once(
        entry_set, reinterpret_cast<const void*>(wkv6_bwd_entry_kernel<T>),
        static_cast<int>(kSmemBytes));
    if (err != cudaSuccess) return err;
    wkv6_bwd_entry_kernel<T><<<grid, kThreads, kSmemBytes, stream>>>(
        tk, tv, tl, static_cast<const float*>(s0), static_cast<float*>(states), steps, dk, dv);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  err = launch::max_dynamic_smem_once(main_set, reinterpret_cast<const void*>(wkv6_bwd_kernel<T>),
                                      static_cast<int>(kSmemBytes), true);
  if (err != cudaSuccess) return err;
  wkv6_bwd_kernel<T><<<grid, kThreads, kSmemBytes, stream>>>(
      static_cast<const T*>(r), tk, tv, tl, static_cast<const float*>(u),
      static_cast<const T*>(gy), static_cast<const float*>(gs_last),
      static_cast<const float*>(states), static_cast<T*>(dr), static_cast<T*>(dk_out),
      static_cast<T*>(dlog_w), static_cast<float*>(ds0), static_cast<float*>(dv_part),
      static_cast<float*>(du_part), heads, steps, dk, dv);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int64_t n = static_cast<int64_t>(batch) * heads * steps * dv + heads * dk;
  wkv6_bwd_reduce_kernel<T><<<static_cast<unsigned>((n + 255) / 256), 256, 0, stream>>>(
      static_cast<const float*>(dv_part), static_cast<const float*>(du_part),
      static_cast<T*>(dv_out), static_cast<float*>(du), batch, heads, steps, dk, dv,
      static_cast<int>(grid.y));
  return cudaGetLastError();
}

}  // namespace

// r, k, log_w (B, H, T, dk), v and gy (B, H, T, dv) contiguous, all f32
// (is_bf16 = 0) or all bf16; u (H, dk) f32; s0 and gs_last (B, H, dk, dv) f32
// or null (zeros); 1 <= dk, dv <= 64.  `states` (B*H, ceil(T / 64), 64, 64)
// f32, 16-byte aligned: the state entering each chunk, as the two-pass
// forward leaves it in its workspace (have_states = 1), or filled here first
// (have_states = 0).  Scratch: dv_part (B*H, ceil(dk / 16), T, 64) f32 and
// du_part (B, H, dk) f32.  Writes dr, dk_out, dlog_w (B, H, T, dk) and dv_out
// (B, H, T, dv) in the input type, du (H, dk) and ds0 (B, H, dk, dv) f32.
// Launches on `stream` (two or three kernels) and returns the first launch
// error (0 on success).
extern "C" int wkv6_bwd(const void* r, const void* k, const void* v, const void* log_w,
                        const void* u, const void* s0, const void* gy, const void* gs_last,
                        void* states, int have_states, void* dr, void* dk_out, void* dv_out,
                        void* dlog_w, void* du, void* ds0, void* dv_part, void* du_part,
                        int batch, int heads, int steps, int dk, int dv, int is_bf16,
                        void* stream) {
  if (dk < 1 || dk > kMaxDim || dv < 1 || dv > kMaxDim || steps < 1 || batch < 1 ||
      heads < 1 || states == nullptr || reinterpret_cast<uintptr_t>(states) % 16 != 0) {
    return cudaErrorInvalidValue;
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    return run<bf16>(r, k, v, log_w, u, s0, gy, gs_last, states, have_states != 0, dr, dk_out,
                     dv_out, dlog_w, du, ds0, dv_part, du_part, batch, heads, steps, dk, dv, s);
  }
  return run<float>(r, k, v, log_w, u, s0, gy, gs_last, states, have_states != 0, dr, dk_out,
                    dv_out, dlog_w, du, ds0, dv_part, du_part, batch, heads, steps, dk, dv, s);
}
