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
// and ds0 = G_{-1}.  Both designs start from the state entering each 64-step
// chunk: the two-pass forward's workspace (wkv6.cu; bf16 with T > 1), held
// as a residual by the op, rounded to TF32 as the forward's output pass used
// it; or, where the forward left none (f32, or T = 1), `states` filled first
// by wkv6_bwd_entry_kernel, walked forward from s0 in f32.
//
// What bounds it on the H100.  At the training shape (B*H = 320, T = 512,
// dk = dv = 64, bf16) it must read r, k, v, log_w, gy and the chunk-entry
// states (42 MB) and write dr, dk, dv, dlog_w: ~236 MB, 0.070 ms at
// 3.35 TB/s.  The chunked design's products, 11.7 GFLOP on TF32 mma.sync
// (dr's and dk's intra-chunk ones with an operand in two parts), take 0.024
// ms at the 495 TFLOP/s TF32 peak: bytes bound it.
//
// bf16: the chunked form, the forward's two passes run backwards.  Per
// chunk, c_t the chunk-local cumulative sum of log_w (c_{-1} = 0), L its last
// step, S_in the state entering it, G_out the gradient of the state leaving
// it, dA[t, j] = gy_t . v_j and A[t, j] = sum_i r_t[i] k_j[i] e^{c_{t-1}[i] - c_j[i]}:
//   G_in   = e^{c_L} G_out + (r e^{c_{t-1}})^T gy
//   dr_t   = e^{c_{t-1}} (S_in gy_t) + sum_{j<t} e^{c_{t-1} - c_j} k_j dA[t,j] + u k_t (v_t . gy_t)
//   dk_j   = e^{c_L - c_j} (G_out v_j) + sum_{t>j} e^{c_{t-1} - c_j} r_t dA[t,j] + u r_j (v_j . gy_j)
//   dv_j   = G_out^T (k_j e^{c_L - c_j}) + sum_{t>j} A[t,j] gy_t + (sum_i u_i r_j[i] k_j[i]) gy_j
//   dlog_w_t = e^{c_L} rowsum(G_out S_in) + sum_j k_j dk_j^inter
//              + sum_{tau>t} r_tau dr'_tau - sum_{j>=t} k_j dk'_j
// (dk^inter: dk's first term; dr', dk': dr, dk without the bonus).  Every
// exponent has the later index on the left, so every factor lies in [0, 1].
// Three kernels:
//   wkv6_bwd_state_kernel, grid (B*H), 8 warps: the gradient-state pass,
//     chunks last to first, G carried in the C fragments of TF32 mma tiles
//     (the forward's state pass mirrored, r e^{c_{t-1}} in two TF32 parts);
//     it writes each chunk's G_out, rounded to TF32, to `g_states` (the
//     forward workspace's layout, 42 MB at the training shape) and ds0.
//   wkv6_bwd_grad_kernel, grid (B*H, n_chunks) = 2,560 CTAs of 4 warps at the
//     training shape, two an SM (104 KB of shared memory): the gradient pass.
//     Each CTA copies its chunk of r, k, v, log_w, gy, its S_in and G_out with
//     cp.async; warp w owns rows [16 w, 16 w + 16); dA goes to shared memory
//     (each of its rows computed once); A, dA and the products with S_in and
//     G_out run on TF32 mma.sync, A factored as the forward's output pass
//     does (sub-blocks of 16, operands measured against the step before the
//     sub-block or its last step, per-element exps only in the diagonal
//     8 x 8 quarters).  The intra-chunk products of dr and dk take their
//     decayed operand (k~, r^) in two TF32 parts: dlog_w's reverse sums take
//     those terms apart, and with one part a CPU emulation of this design
//     put dlog_w at 1.2x the bf16 bound (2e-2 + 2e-2|want|), with two at
//     0.35; dv's bonus term stays in f32 outside its products (0.64 -> 0.45
//     of the bound).  dlog_w's sums over later steps run down each warp's 16
//     rows in shared memory, in order, plus the later warps' totals.  dv no longer
//     crosses CTAs: one CTA holds all 64 rows of its chunk.  One du partial
//     a (b, h, chunk).
//   wkv6_bwd_du_kernel: du as the sum of those partials in a fixed order.
// f32 (the card-vs-CPU training parity): the first design.
//   wkv6_bwd_kernel: grid (B*H, row blocks of 16), 256 threads, thread (row,
//     4 columns).  The decay is diagonal, so row i of S and of G is a
//     recurrence of its own; it walks the chunks backwards, recomputes each
//     chunk's states from its entry state into 16-step sub-block checkpoints
//     and walks each sub-block backwards in registers, in f32 on the CUDA
//     cores.  Row sums are warp shuffles; dv's sums over the CTA's 16 rows
//     leave as one partial per row block, which wkv6_bwd_reduce_kernel sums
//     with du in a fixed order.
// No atomics anywhere: two runs give the same bits.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

#include "launch.cuh"
#include "tensor_core.cuh"
#include "wkv6_chunk.cuh"

namespace {

using bf16 = __nv_bfloat16;

using wkv6_chunk::kChunk;                        // steps per chunk, as the forward's
using wkv6_chunk::kMaxDim;                       // dk, dv <= 64
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

// The state entering each chunk, walked forward from s0 into `states`.
template <typename T>
cudaError_t entry_states(const void* k, const void* v, const void* log_w, const void* s0,
                         void* states, int batch, int heads, int steps, int dk, int dv,
                         cudaStream_t stream) {
  static std::atomic<unsigned long long> entry_set{0};
  const cudaError_t err = launch::max_dynamic_smem_once(
      entry_set, reinterpret_cast<const void*>(wkv6_bwd_entry_kernel<T>),
      static_cast<int>(kSmemBytes));
  if (err != cudaSuccess) return err;
  wkv6_bwd_entry_kernel<T><<<dim3(batch * heads, (dk + kRows - 1) / kRows), kThreads, kSmemBytes,
                             stream>>>(
      static_cast<const T*>(k), static_cast<const T*>(v), static_cast<const T*>(log_w),
      static_cast<const float*>(s0), static_cast<float*>(states), steps, dk, dv);
  return cudaGetLastError();
}

// f32: the reverse walk over row blocks, then the fixed-order sum of dv and du.
cudaError_t run_f32(const void* r, const void* k, const void* v, const void* log_w, const void* u,
                    const void* gy, const void* gs_last, const void* states, void* dr,
                    void* dk_out, void* dv_out, void* dlog_w, void* du, void* ds0, void* dv_part,
                    void* du_part, int batch, int heads, int steps, int dk, int dv,
                    cudaStream_t stream) {
  using T = float;
  if (dv_part == nullptr || du_part == nullptr) return cudaErrorInvalidValue;
  static std::atomic<unsigned long long> main_set{0};
  const dim3 grid(batch * heads, (dk + kRows - 1) / kRows);
  cudaError_t err = launch::max_dynamic_smem_once(
      main_set, reinterpret_cast<const void*>(wkv6_bwd_kernel<T>), static_cast<int>(kSmemBytes),
      true);
  if (err != cudaSuccess) return err;
  wkv6_bwd_kernel<T><<<grid, kThreads, kSmemBytes, stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(log_w), static_cast<const float*>(u), static_cast<const T*>(gy),
      static_cast<const float*>(gs_last), static_cast<const float*>(states), static_cast<T*>(dr),
      static_cast<T*>(dk_out), static_cast<T*>(dlog_w), static_cast<float*>(ds0),
      static_cast<float*>(dv_part), static_cast<float*>(du_part), heads, steps, dk, dv);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int64_t n = static_cast<int64_t>(batch) * heads * steps * dv + heads * dk;
  wkv6_bwd_reduce_kernel<T><<<static_cast<unsigned>((n + 255) / 256), 256, 0, stream>>>(
      static_cast<const float*>(dv_part), static_cast<const float*>(du_part),
      static_cast<T*>(dv_out), static_cast<float*>(du), batch, heads, steps, dk, dv,
      static_cast<int>(grid.y));
  return cudaGetLastError();
}

// ---- bf16: the chunked design on the tensor cores ---------------------------------

namespace chunked {

using wkv6_chunk::bf16_bits;
using wkv6_chunk::chunk_cumsum;
using wkv6_chunk::kLog2e;
using wkv6_chunk::load_chunk;
using wkv6_chunk::tf32_value;

// Row strides (words mod 32): a warp's mma fragment reads hit 32 banks when
// an operand read as (row g, column t4) has a stride of 4 and one read as
// (row t4, column g) a stride of 8; a bf16 tile of stride 72 serves both.
constexpr int kCStride = kMaxDim + 4;        // c (65 rows; row t holds c_{t-1})
constexpr int kBStride = kMaxDim + 8;        // bf16 tiles r, k, v, gy (and log_w)
constexpr int kFStride = kMaxDim + 4;        // the gradient pass's f32 tiles S_in, G_out, dA
constexpr int kSub = 16;                     // rows of a warp in the gradient pass
constexpr int kWarps = kChunk / kSub;        // 4
constexpr int kThreads = 32 * kWarps;
constexpr int kStateThreads = 256;           // gradient-state pass: 8 warps
// Gradient-state pass: two stages of (log_w, r, gy) chunks in bf16, then c
// (then r~) in f32 and c_last.
constexpr int kStageElems = 2 * kChunk * kMaxDim + kChunk * kBStride;
constexpr size_t kStateSmemBytes = 2 * sizeof(bf16) * kStageElems +
                                   sizeof(float) * ((kChunk + 1) * kCStride + kMaxDim);  // 69,136
// Gradient pass: r, k, v, gy (bf16), c, S_in, G_out and dA (f32; log_w's
// bf16 tile sits in dA's place until c is taken).
constexpr size_t kTileBytes = sizeof(bf16) * kChunk * kBStride;
constexpr size_t kGradSmemBytes =
    4 * kTileBytes + sizeof(float) * ((kChunk + 1) * kCStride + 3 * kChunk * kFStride);  // 106,768
static_assert(kTileBytes <= sizeof(float) * kChunk * kFStride, "log_w's tile fits dA's");

// A one-part operand is rounded as cvt.rna.tf32.f32 rounds a finite value
// (tc::tf32_operand).  A value in two TF32 parts: its TF32 value truncated
// (the low bits cleared, so that the rest is exact) and the rest, whose low
// bits the tensor core ignores: ~20 bits in all, in two integer operations
// and a subtraction.
__device__ __forceinline__ uint32_t tf32_big(float x) { return __float_as_uint(x) & 0xffffe000u; }
__device__ __forceinline__ void split(const float (&x)[4], uint32_t (&big)[4],
                                      uint32_t (&small)[4]) {
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    big[q] = tf32_big(x[q]);
    small[q] = __float_as_uint(x[q] - __uint_as_float(big[q]));
  }
}
// c += a b with b (the decayed operand) in two TF32 parts and a (dA) in one.
// dr's and dk's intra-chunk products, which dlog_w's reverse sums take apart:
// dA enters both rounded alike, so its rounding cancels there, and the
// decayed operands differ.  A CPU emulation of this design put dlog_w at
// 1.2x the bf16 bound with b in one part, at 0.35 with b in two (0.22 with
// a in two as well, 1.2 with a alone in two).
__device__ __forceinline__ void mma2(float (&c)[4], const uint32_t (&a)[4], float b0, float b1) {
  const uint32_t bb0 = tf32_big(b0), bb1 = tf32_big(b1);
  tc::mma_tf32(c, a, bb0, bb1);
  tc::mma_tf32(c, a, __float_as_uint(b0 - __uint_as_float(bb0)),
               __float_as_uint(b1 - __uint_as_float(bb1)));
}

// Gradient-state pass.  grid = (B*H), 8 warps: warp w holds rows
// [16 (w % 4), + 16) and columns [32 (w / 4), + 32) of G in the C fragments
// of its mma tiles.  Walks the chunks last to first; per chunk it writes G
// (the gradient of the state leaving the chunk) rounded to TF32 to g_out
// (B*H, n_chunks, 64, 64), then G <- e^{c_last} G + (r e^{c_{t-1}})^T gy
// with r e^{c_{t-1}} in two TF32 parts (gy is bf16, exact in TF32); the
// previous chunk's copy flies meanwhile.  At the end ds0 = G.  c is in log2
// units.  The forward's state pass (wkv6.cu), mirrored.
__global__ void __launch_bounds__(kStateThreads)
wkv6_bwd_state_kernel(const bf16* __restrict__ r, const bf16* __restrict__ gy,
                      const bf16* __restrict__ log_w, const float* __restrict__ gs_last,
                      float* __restrict__ g_out, float* __restrict__ ds0, int steps, int dk,
                      int dv, bool vec) {
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* staging = reinterpret_cast<bf16*>(smem);      // stage s at staging + s kStageElems
  float* cs = reinterpret_cast<float*>(staging + 2 * kStageElems);  // row t: c_{t-1}, then r~_t
  float* clast = cs + (kChunk + 1) * kCStride;        // c of the chunk's last step
  __shared__ float totals[(kStateThreads / kMaxDim) * kMaxDim];

  const int bh = blockIdx.x;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int t4 = lane % 4;
  const int drow = (warp % 4) * 16 + g;               // this lane's rows of G: drow, drow + 8
  const int e_base = (warp / 4) * 32;                 // and its warp's columns
  const int n_chunks = (steps + kChunk - 1) / kChunk;
  const int64_t s_off = static_cast<int64_t>(bh) * dk * dv;
  const bf16* r_g = r + static_cast<int64_t>(bh) * steps * dk;
  const bf16* lw_g = log_w + static_cast<int64_t>(bh) * steps * dk;
  const bf16* gy_g = gy + static_cast<int64_t>(bh) * steps * dv;

  // G[n][2 h + i]: row drow + 8 h, column e_base + 8 n + 2 t4 + i
  float G[4][4];
#pragma unroll
  for (int n = 0; n < 4; ++n) {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int d = drow + 8 * (q / 2), e = e_base + 8 * n + 2 * t4 + q % 2;
      G[n][q] = gs_last != nullptr && d < dk && e < dv
                    ? gs_last[s_off + static_cast<int64_t>(d) * dv + e] : 0.f;
    }
  }

  auto load = [&](int c) {  // chunk c's log_w, r and gy into stage c % 2
    bf16* lb = staging + (c & 1) * kStageElems;
    const int64_t t0 = static_cast<int64_t>(c) * kChunk;
    const int len = min(kChunk, steps - c * kChunk);
    load_chunk<kStateThreads>(lb, kMaxDim, lw_g + t0 * dk, len, dk, 0, kMaxDim, vec);
    load_chunk<kStateThreads>(lb + kChunk * kMaxDim, kMaxDim, r_g + t0 * dk, len, dk, 0, kMaxDim,
                              vec);
    load_chunk<kStateThreads>(lb + 2 * kChunk * kMaxDim, kBStride, gy_g + t0 * dv, len, dv, 0,
                              kMaxDim, vec);
    tc::cp_async_commit();
  };
  load(n_chunks - 1);

  for (int c = n_chunks - 1; c >= 0; --c) {
    const int len = min(kChunk, steps - c * kChunk);
    // the gradient of the state leaving this chunk, for the gradient pass
    float* out = g_out + (static_cast<int64_t>(bh) * n_chunks + c) * kMaxDim * kMaxDim;
#pragma unroll
    for (int n = 0; n < 4; ++n) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        *reinterpret_cast<float2*>(out + (drow + 8 * h) * kMaxDim + e_base + 8 * n + 2 * t4) =
            make_float2(tf32_value(G[n][2 * h]), tf32_value(G[n][2 * h + 1]));
      }
    }
    tc::cp_async_wait<0>();
    __syncthreads();  // chunk c has landed; the next chunk is done with cs and its stage
    if (c > 0) load(c - 1);  // the previous chunk's copy flies while this one is computed
    const bf16* lb = staging + (c & 1) * kStageElems;
    const bf16* rb = lb + kChunk * kMaxDim;
    const bf16* gb = rb + kChunk * kMaxDim;
    if (threadIdx.x < kMaxDim) cs[threadIdx.x] = 0.f;  // c_{-1}
    chunk_cumsum<kStateThreads / kMaxDim>(lb, kMaxDim, cs + kCStride, kCStride, kLog2e, totals);
    if (threadIdx.x < kMaxDim) clast[threadIdx.x] = cs[len * kCStride + threadIdx.x];
    __syncthreads();
    // r_t <- r_t e^{c_{t-1}} in place of c_{t-1} (each thread its own entries; 0 past len)
#pragma unroll 4
    for (int i = threadIdx.x; i < kChunk * kMaxDim; i += kStateThreads) {
      const int t = i / kMaxDim, d = i % kMaxDim;
      float* at = cs + t * kCStride + d;
      *at = t < len ? __bfloat162float(rb[i]) * tc::ex2(*at) : 0.f;
    }
    __syncthreads();
    // G <- e^{c_last} G + r~^T gy: A = r~^T (rows d, k-columns t), B = gy
    const float decay0 = tc::ex2(clast[drow]), decay1 = tc::ex2(clast[drow + 8]);
#pragma unroll
    for (int n = 0; n < 4; ++n) {
      G[n][0] *= decay0;
      G[n][1] *= decay0;
      G[n][2] *= decay1;
      G[n][3] *= decay1;
    }
#pragma unroll
    for (int kk = 0; kk < kChunk / 8; ++kk) {
      const int t = kk * 8 + t4;
      const float x[4] = {cs[t * kCStride + drow], cs[t * kCStride + drow + 8],
                          cs[(t + 4) * kCStride + drow], cs[(t + 4) * kCStride + drow + 8]};
      uint32_t big[4], small[4];
      split(x, big, small);
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        const uint32_t b0 = bf16_bits(gb[t * kBStride + e_base + 8 * n + g]);
        const uint32_t b1 = bf16_bits(gb[(t + 4) * kBStride + e_base + 8 * n + g]);
        tc::mma_tf32(G[n], big, b0, b1);
        tc::mma_tf32(G[n], small, b0, b1);
      }
    }
  }
#pragma unroll
  for (int n = 0; n < 4; ++n) {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int d = drow + 8 * (q / 2), e = e_base + 8 * n + 2 * t4 + q % 2;
      if (d < dk && e < dv) ds0[s_off + static_cast<int64_t>(d) * dv + e] = G[n][q];
    }
  }
}

// Rows s + g and s + 8 + g of a chunk's (64, n) bf16 output (`out` at the
// chunk's first row) from C fragments x[8][4] (columns 8 j + 2 t4, + 1),
// rows at or past len and columns at or past n left out.
__device__ __forceinline__ void store_rows(bf16* out, const float (&x)[8][4], int len, int s,
                                           int g, int t4, int n) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int t = s + g + 8 * h;
    if (t >= len) continue;
    bf16* o = out + t * n;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int e = 8 * j + 2 * t4;
      if (n % 2 == 0 && e + 1 < n) {
        *reinterpret_cast<__nv_bfloat162*>(o + e) =
            __floats2bfloat162_rn(x[j][2 * h], x[j][2 * h + 1]);
      } else {
        if (e < n) o[e] = __float2bfloat16(x[j][2 * h]);
        if (e + 1 < n) o[e + 1] = __float2bfloat16(x[j][2 * h + 1]);
      }
    }
  }
}

// Gradient pass.  grid = (B*H, n_chunks), 4 warps; warp w owns rows
// [s, s + 16), s = 16 w, of the chunk: the steps t of dr and the steps j of
// dk and dv.  With dA[t, j] = gy_t . v_j (in shared memory, j <= t) and
// A[t, j] = sum_i r_t[i] k_j[i] e^{c_{t-1}[i] - c_j[i]} (j < t), each warp
// computes on TF32 mma.sync:
//   dr = e^{c_{t-1}} (gy S_in^T) + e^{c_{t-1} - c_{s-1}} dA[., <s] k~,
//     k~_j = k_j e^{c_{s-1} - c_j};
//   dk = e^{c_{s+15} - c_j} dA[>s+15, .]^T r^ + e^{c_L - c_j} (v G_out^T),
//     r^_t = r_t e^{c_{t-1} - c_{s+15}};
//   dv = (k e^{c_L - c}) G_out + A[>s+15, .]^T gy (A from k e^{c_{s+15} - c}
//     and r^) + A[block]^T gy;
// in the block's lower-left 8 x 8 quarter the same products against step
// s + 7, and in its two diagonal quarters per element (A of the block goes
// to dA's unused upper triangle, transposed).  dr's and dk's intra-chunk
// products take their decayed operand in two TF32 parts: dlog_w takes them
// apart in its reverse sums.
// Then the bonus terms (dv's in f32), and, with P = r dr' and Q = k dk'
// (dr', dk' without the bonus) and Z = P - Q,
//   dlog_w_t = e^{c_L} rowsum(G_out S_in) + sum_j k_j dk_j^inter
//              + sum_{tau > t} Z_tau - Q_t,
// the sum over later rows taken down each warp's rows in order in shared
// memory, plus the later warps' totals.  One du partial a CTA.
__global__ void __launch_bounds__(kThreads, 2)
wkv6_bwd_grad_kernel(const bf16* __restrict__ r, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, const bf16* __restrict__ log_w,
                     const float* __restrict__ u, const bf16* __restrict__ gy,
                     const float* __restrict__ s_in, const float* __restrict__ g_out,
                     bf16* __restrict__ dr_out, bf16* __restrict__ dk_out,
                     bf16* __restrict__ dv_out, bf16* __restrict__ dlw_out,
                     float* __restrict__ du_part, int heads, int steps, int dk, int dv,
                     bool vec) {
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* rs = reinterpret_cast<bf16*>(smem);                        // [t][d]
  bf16* ks = rs + kChunk * kBStride;                               // [t][d]
  bf16* vs = ks + kChunk * kBStride;                               // [t][e]
  bf16* gs = vs + kChunk * kBStride;                               // [t][e]
  float* cs = reinterpret_cast<float*>(gs + kChunk * kBStride);    // row t: c_{t-1} log2e
  float* sin = cs + (kChunk + 1) * kCStride;                       // S_in [d][e]
  float* gsm = sin + kChunk * kFStride;                            // G_out [d][e]
  float* dam = gsm + kChunk * kFStride;                            // dA [t][j]; A^T in blocks
  bf16* ls = reinterpret_cast<bf16*>(dam);                         // log_w [t][d], first
  __shared__ __align__(16) float us[kMaxDim];
  __shared__ float erow[kMaxDim];                                  // e^{c_L} rowsum(G_out S_in)
  __shared__ float ysum[kWarps][kMaxDim];                          // sum_j k_j dk_j^inter
  __shared__ float zsum[kWarps][kMaxDim];                          // Z summed over a warp's rows
  __shared__ float usum[kWarps][kMaxDim];                          // du's partial sums
  __shared__ float totals[(kThreads / kMaxDim) * kMaxDim];

  const int bh = blockIdx.x;
  const int chunk = blockIdx.y;
  const int t0 = chunk * kChunk;
  const int len = min(kChunk, steps - t0);
  const int tid = threadIdx.x;
  const int64_t row0 = static_cast<int64_t>(bh) * steps + t0;  // the chunk's first step

  // two groups of copies: log_w, v and gy (the cumulative sum and dA) first
  load_chunk<kThreads>(ls, kBStride, log_w + row0 * dk, len, dk, 0, kMaxDim, vec);
  load_chunk<kThreads>(vs, kBStride, v + row0 * dv, len, dv, 0, kMaxDim, vec);
  load_chunk<kThreads>(gs, kBStride, gy + row0 * dv, len, dv, 0, kMaxDim, vec);
  tc::cp_async_commit();
  load_chunk<kThreads>(rs, kBStride, r + row0 * dk, len, dk, 0, kMaxDim, vec);
  load_chunk<kThreads>(ks, kBStride, k + row0 * dk, len, dk, 0, kMaxDim, vec);
  const int64_t ws = (static_cast<int64_t>(bh) * gridDim.y + chunk) * kMaxDim * kMaxDim;
  for (int i = tid; i < kMaxDim * kMaxDim / 4; i += kThreads) {
    const int row = i / (kMaxDim / 4), c4 = (i % (kMaxDim / 4)) * 4;
    tc::cp_async16(sin + row * kFStride + c4, s_in + ws + row * kMaxDim + c4, 16);
    tc::cp_async16(gsm + row * kFStride + c4, g_out + ws + row * kMaxDim + c4, 16);
  }
  tc::cp_async_commit();
  if (tid < kMaxDim) us[tid] = tid < dk ? u[(bh % heads) * dk + tid] : 0.f;
  tc::cp_async_wait<1>();
  __syncthreads();
  if (tid < kMaxDim) cs[tid] = 0.f;
  chunk_cumsum<kThreads / kMaxDim>(ls, kBStride, cs + kCStride, kCStride, kLog2e, totals);
  const float* c_last = cs + kChunk * kCStride;        // c flat past len: c_63 = c_L

  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane / 4;
  const int t4 = lane % 4;
  const int s = warp * kSub;
  const int tlo = s + g, thi = s + 8 + g;              // this lane's rows
  auto cp = [&](int t, int d) { return cs[t * kCStride + d]; };        // c_{t-1}
  auto cj = [&](int j, int d) { return cs[(j + 1) * kCStride + d]; };  // c_j
  auto rv = [&](int t, int d) { return __bfloat162float(rs[t * kBStride + d]); };
  auto kv = [&](int t, int d) { return __bfloat162float(ks[t * kBStride + d]); };
  auto rb = [&](const bf16* x, int t, int e) { return bf16_bits(x[t * kBStride + e]); };
  auto da = [&](int t, int j) { return dam[t * kFStride + j]; };

  {  // dA[t, j] for the block's rows and j < s + 16 (bf16 operands, exact in TF32)
    uint32_t ag[8][4];
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) {
      const int e = kk * 8 + t4;
      ag[kk][0] = rb(gs, tlo, e);
      ag[kk][1] = rb(gs, thi, e);
      ag[kk][2] = rb(gs, tlo, e + 4);
      ag[kk][3] = rb(gs, thi, e + 4);
    }
    for (int n = 0; n < 2 * warp + 2; ++n) {
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int kk = 0; kk < 8; ++kk) {
        const int e = kk * 8 + t4;
        tc::mma_tf32(acc, ag[kk], rb(vs, 8 * n + g, e), rb(vs, 8 * n + g, e + 4));
      }
      const int j = 8 * n + 2 * t4;
      *reinterpret_cast<float2*>(dam + tlo * kFStride + j) = make_float2(acc[0], acc[1]);
      *reinterpret_cast<float2*>(dam + thi * kFStride + j) = make_float2(acc[2], acc[3]);
    }
  }
  tc::cp_async_wait<0>();
  __syncthreads();  // every row of dA is in shared memory, and r, k, S_in, G_out have landed
  {  // e^{c_L} rowsum(G_out S_in): two threads a row, 32 columns each, in order
    const int d = tid / 2, half = tid % 2;
    float acc = 0.f;
    for (int e = 32 * half; e < 32 * half + 32; ++e) {
      acc = __fmaf_rn(gsm[d * kFStride + e], sin[d * kFStride + e], acc);
    }
    acc += __shfl_xor_sync(kFull, acc, 1);
    if (half == 0) erow[d] = tc::ex2(c_last[d]) * acc;
  }

  // dr' = e^{c_{t-1}} (gy S_in^T) + e^{c_{t-1} - c_{s-1}} (dA[., <s] k~), S_in as the
  // forward's state pass rounded it
  float dr[8][4];
#pragma unroll
  for (int n = 0; n < 8; ++n) dr[n][0] = dr[n][1] = dr[n][2] = dr[n][3] = 0.f;
#pragma unroll 2
  for (int kk = 0; kk < kMaxDim / 8; ++kk) {
    const int e = kk * 8 + t4;
    const uint32_t a[4] = {rb(gs, tlo, e), rb(gs, thi, e), rb(gs, tlo, e + 4), rb(gs, thi, e + 4)};
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const float* srow = sin + (8 * n + g) * kFStride;
      tc::mma_tf32(dr[n], a, __float_as_uint(srow[e]), __float_as_uint(srow[e + 4]));
    }
  }
#pragma unroll
  for (int n = 0; n < 8; ++n) {
#pragma unroll
    for (int q = 0; q < 4; ++q) dr[n][q] *= tc::ex2(cp(q < 2 ? tlo : thi, 8 * n + 2 * t4 + (q & 1)));
  }
  if (warp > 0) {
    float off[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n) off[n][0] = off[n][1] = off[n][2] = off[n][3] = 0.f;
    float c0[8];  // c_{s-1} at this lane's columns of B
#pragma unroll
    for (int n = 0; n < 8; ++n) c0[n] = cp(s, 8 * n + g);
    for (int kk = 0; kk < 2 * warp; ++kk) {  // warp-uniform
      const int j = kk * 8 + t4;
      const uint32_t a[4] = {tc::tf32_operand(da(tlo, j)), tc::tf32_operand(da(thi, j)),
                             tc::tf32_operand(da(tlo, j + 4)), tc::tf32_operand(da(thi, j + 4))};
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        const int d = 8 * n + g;
        mma2(off[n], a, kv(j, d) * tc::ex2(c0[n] - cj(j, d)),
             kv(j + 4, d) * tc::ex2(c0[n] - cj(j + 4, d)));
      }
    }
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int d = 8 * n + 2 * t4 + (q & 1);
        dr[n][q] = __fmaf_rn(off[n][q], tc::ex2(cp(q < 2 ? tlo : thi, d) - cp(s, d)), dr[n][q]);
      }
    }
  }
  {  // the lower-left quarter: rows s + 8 .., columns s .. s + 7, against step s + 7
    const uint32_t a[4] = {0u, tc::tf32_operand(da(thi, s + t4)), 0u,
                           tc::tf32_operand(da(thi, s + t4 + 4))};
    const int j = s + t4;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const int d = 8 * n + g;
      const float c7 = cj(s + 7, d);
      float q4[4] = {0.f, 0.f, 0.f, 0.f};
      mma2(q4, a, kv(j, d) * tc::ex2(c7 - cj(j, d)), kv(j + 4, d) * tc::ex2(c7 - cj(j + 4, d)));
      const int d0 = 8 * n + 2 * t4;
      dr[n][2] += q4[2] * tc::ex2(cp(thi, d0) - cj(s + 7, d0));
      dr[n][3] += q4[3] * tc::ex2(cp(thi, d0 + 1) - cj(s + 7, d0 + 1));
    }
  }

  // dk' = e^{c_{s+15} - c_j} dA[>s+15, .]^T r^ + its quarter + e^{c_L - c_j} (v G_out^T)
  float dkg[8][4];
#pragma unroll
  for (int n = 0; n < 8; ++n) dkg[n][0] = dkg[n][1] = dkg[n][2] = dkg[n][3] = 0.f;
  if (warp + 1 < kWarps) {
    float c15[8];  // c_{s+15} at this lane's columns of B
#pragma unroll
    for (int n = 0; n < 8; ++n) c15[n] = cj(s + 15, 8 * n + g);
    for (int kk = 2 * warp + 2; kk < 8; ++kk) {  // warp-uniform; A = dA^T
      const int t = kk * 8 + t4;
      const uint32_t a[4] = {tc::tf32_operand(da(t, tlo)), tc::tf32_operand(da(t, thi)),
                             tc::tf32_operand(da(t + 4, tlo)), tc::tf32_operand(da(t + 4, thi))};
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        const int d = 8 * n + g;
        mma2(dkg[n], a, rv(t, d) * tc::ex2(cp(t, d) - c15[n]),
             rv(t + 4, d) * tc::ex2(cp(t + 4, d) - c15[n]));
      }
    }
  }
#pragma unroll
  for (int n = 0; n < 8; ++n) {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int d = 8 * n + 2 * t4 + (q & 1);
      dkg[n][q] *= tc::ex2(cj(s + 15, d) - cj(q < 2 ? tlo : thi, d));
    }
  }
  {  // the quarter: rows s .. s + 7, t in s + 8 .., against step s + 7
    const uint32_t a[4] = {tc::tf32_operand(da(s + 8 + t4, tlo)), 0u,
                           tc::tf32_operand(da(s + 12 + t4, tlo)), 0u};
    const int t = s + 8 + t4;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const int d = 8 * n + g;
      const float c7 = cj(s + 7, d);
      float q4[4] = {0.f, 0.f, 0.f, 0.f};
      mma2(q4, a, rv(t, d) * tc::ex2(cp(t, d) - c7), rv(t + 4, d) * tc::ex2(cp(t + 4, d) - c7));
      const int d0 = 8 * n + 2 * t4;
      dkg[n][0] += q4[0] * tc::ex2(cj(s + 7, d0) - cj(tlo, d0));
      dkg[n][1] += q4[1] * tc::ex2(cj(s + 7, d0 + 1) - cj(tlo, d0 + 1));
    }
  }
  float ys[8][2];  // this lane's part of sum_j k_j dk_j^inter, over its two rows
  {
    float dki[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n) dki[n][0] = dki[n][1] = dki[n][2] = dki[n][3] = 0.f;
#pragma unroll 2
    for (int kk = 0; kk < kMaxDim / 8; ++kk) {
      const int e = kk * 8 + t4;
      const uint32_t a[4] = {rb(vs, tlo, e), rb(vs, thi, e), rb(vs, tlo, e + 4), rb(vs, thi, e + 4)};
#pragma unroll
      for (int n = 0; n < 8; ++n) {  // G_out was rounded to TF32 by the gradient-state pass
        const float* grow = gsm + (8 * n + g) * kFStride;
        tc::mma_tf32(dki[n], a, __float_as_uint(grow[e]), __float_as_uint(grow[e + 4]));
      }
    }
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int b = 0; b < 2; ++b) {
        const int d = 8 * n + 2 * t4 + b;
        const float lo = dki[n][b] * tc::ex2(c_last[d] - cj(tlo, d));
        const float hi = dki[n][2 + b] * tc::ex2(c_last[d] - cj(thi, d));
        ys[n][b] = kv(tlo, d) * lo + kv(thi, d) * hi;
        dkg[n][b] += lo;
        dkg[n][2 + b] += hi;
      }
    }
  }

  // The two diagonal 8 x 8 quarters, per element: at step m a lane with
  // m < g adds pair (t, j) = (s + g, s + m) to dr (and sums A[t, j] into
  // dA's upper triangle as A^T[j, t]), otherwise pair (s + m + 1, s + g) to
  // dk; likewise 8 rows down.
  for (int m = 0; m < 7; ++m) {
    const bool to_dr = m < g;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int t = (to_dr ? tlo : s + m + 1) + 8 * h;
      const int j = (to_dr ? s + m : tlo) + 8 * h;
      const float coef = da(t, j);
      const float* ct = cs + t * kCStride;
      const float* cjr = cs + (j + 1) * kCStride;
      float ap = 0.f;
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        const int d = 8 * n + 2 * t4;
        const float2 c1 = *reinterpret_cast<const float2*>(ct + d);
        const float2 c2 = *reinterpret_cast<const float2*>(cjr + d);
        const float2 rr = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(
            rs + t * kBStride + d));
        const float2 kk2 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(
            ks + j * kBStride + d));
        const float e0 = tc::ex2(c1.x - c2.x), e1 = tc::ex2(c1.y - c2.y);
        ap = __fmaf_rn(rr.x * kk2.x, e0, ap);
        ap = __fmaf_rn(rr.y * kk2.y, e1, ap);
        if (to_dr) {
          dr[n][2 * h] = __fmaf_rn(coef * kk2.x, e0, dr[n][2 * h]);
          dr[n][2 * h + 1] = __fmaf_rn(coef * kk2.y, e1, dr[n][2 * h + 1]);
        } else {
          dkg[n][2 * h] = __fmaf_rn(coef * rr.x, e0, dkg[n][2 * h]);
          dkg[n][2 * h + 1] = __fmaf_rn(coef * rr.y, e1, dkg[n][2 * h + 1]);
        }
      }
      ap += __shfl_xor_sync(kFull, ap, 1);
      ap += __shfl_xor_sync(kFull, ap, 2);
      if (to_dr && t4 == 0) dam[j * kFStride + t] = ap;
    }
  }
  {  // A's lower-left quarter against step s + 7, into dA's upper triangle as A^T
    float q4[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 2
    for (int kk = 0; kk < kMaxDim / 8; ++kk) {
      const int d = kk * 8 + t4;
      const float c0 = cj(s + 7, d), c1 = cj(s + 7, d + 4);
      const uint32_t a[4] = {0u, tc::tf32_operand(rv(thi, d) * tc::ex2(cp(thi, d) - c0)), 0u,
                             tc::tf32_operand(rv(thi, d + 4) * tc::ex2(cp(thi, d + 4) - c1))};
      tc::mma_tf32(q4, a, tc::tf32_operand(kv(tlo, d) * tc::ex2(c0 - cj(tlo, d))),
                   tc::tf32_operand(kv(tlo, d + 4) * tc::ex2(c1 - cj(tlo, d + 4))));
    }
    dam[(s + 2 * t4) * kFStride + thi] = q4[2];
    dam[(s + 2 * t4 + 1) * kFStride + thi] = q4[3];
  }

  // Q = k dk', then dk with its bonus out; Z = r dr' - Q, then dr with its
  // bonus out (u k_t (v_t . gy_t) and u r_j (v_j . gy_j)); du's terms
  float qv[8][4], uk[8][2];
  {
    const float vg_lo = da(tlo, tlo), vg_hi = da(thi, thi);  // v_t . gy_t
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int t = q < 2 ? tlo : thi, d = 8 * n + 2 * t4 + (q & 1);
        qv[n][q] = kv(t, d) * dkg[n][q];
        dkg[n][q] = __fmaf_rn(us[d] * rv(t, d), q < 2 ? vg_lo : vg_hi, dkg[n][q]);
      }
    }
    store_rows(dk_out + row0 * dk, dkg, len, s, g, t4, dk);
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int b = 0; b < 2; ++b) {
        const int d = 8 * n + 2 * t4 + b;
        const float rl = rv(tlo, d), kl = kv(tlo, d), rh = rv(thi, d), kh = kv(thi, d);
        uk[n][b] = rl * kl * vg_lo + rh * kh * vg_hi;
        const float zl = rl * dr[n][b] - qv[n][b], zh = rh * dr[n][2 + b] - qv[n][2 + b];
        dr[n][b] = __fmaf_rn(us[d] * kl, vg_lo, dr[n][b]);
        dr[n][2 + b] = __fmaf_rn(us[d] * kh, vg_hi, dr[n][2 + b]);
        dkg[n][b] = zl;  // dk is out: its registers hold Z from here
        dkg[n][2 + b] = zh;
      }
    }
    store_rows(dr_out + row0 * dk, dr, len, s, g, t4, dk);
  }

  // dlog_w: Z summed over the later rows.  Each warp puts its rows of Z in
  // the S_in tile's rows [s, s + 16) (every warp is done with S_in), and each
  // lane sums two columns down them, last row first, in order; the warp's
  // column totals of Z, of k dk^inter and of du's terms go to shared memory
  float (&z)[8][4] = dkg;
  float* zt = sin + s * kFStride;                      // Z[t - s][d], then its sums after t
  __syncthreads();
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    const int d = 8 * n + 2 * t4;
    *reinterpret_cast<float2*>(zt + g * kFStride + d) = make_float2(z[n][0], z[n][1]);
    *reinterpret_cast<float2*>(zt + (g + 8) * kFStride + d) = make_float2(z[n][2], z[n][3]);
#pragma unroll
    for (int b = 0; b < 2; ++b) {
#pragma unroll
      for (int o = 4; o < 32; o <<= 1) {  // over g
        ys[n][b] += __shfl_xor_sync(kFull, ys[n][b], o);
        uk[n][b] += __shfl_xor_sync(kFull, uk[n][b], o);
      }
      if (g == 0) {
        ysum[warp][d + b] = ys[n][b];
        usum[warp][d + b] = uk[n][b];
      }
    }
  }
  __syncwarp();
  {
    const int d = 2 * lane;
    float a0 = 0.f, a1 = 0.f;
#pragma unroll
    for (int i = kSub - 1; i >= 0; --i) {
      float2* at = reinterpret_cast<float2*>(zt + i * kFStride + d);
      const float2 zi = *at;
      *at = make_float2(a0, a1);                       // the sum over the rows after row i
      a0 += zi.x;
      a1 += zi.y;
    }
    zsum[warp][d] = a0;
    zsum[warp][d + 1] = a1;
  }
  __syncthreads();  // every warp's totals are in; the warp's A block is in dA
#pragma unroll
  for (int n = 0; n < 8; ++n) {
#pragma unroll
    for (int b = 0; b < 2; ++b) {
      const int d = 8 * n + 2 * t4 + b;
      float x = erow[d] + ysum[0][d] + ysum[1][d] + ysum[2][d] + ysum[3][d];
      for (int w2 = warp + 1; w2 < kWarps; ++w2) x += zsum[w2][d];
      z[n][b] = x + zt[g * kFStride + d] - qv[n][b];
      z[n][2 + b] = x + zt[(g + 8) * kFStride + d] - qv[n][2 + b];
    }
  }
  store_rows(dlw_out + row0 * dk, z, len, s, g, t4, dk);
  if (tid < kMaxDim) {
    du_part[(static_cast<int64_t>(bh) * gridDim.y + chunk) * kMaxDim + tid] =
        usum[0][tid] + usum[1][tid] + usum[2][tid] + usum[3][tid];
  }

  // dv = (k e^{c_L - c}) G_out + A[>s+15, .]^T gy + A[block]^T gy + the bonus
  float dvv[8][4];
#pragma unroll
  for (int n = 0; n < 8; ++n) dvv[n][0] = dvv[n][1] = dvv[n][2] = dvv[n][3] = 0.f;
#pragma unroll 2
  for (int kk = 0; kk < kMaxDim / 8; ++kk) {
    const int d = kk * 8 + t4;
    const float c0 = c_last[d], c1 = c_last[d + 4];
    const uint32_t a[4] = {tc::tf32_operand(kv(tlo, d) * tc::ex2(c0 - cj(tlo, d))),
                           tc::tf32_operand(kv(thi, d) * tc::ex2(c0 - cj(thi, d))),
                           tc::tf32_operand(kv(tlo, d + 4) * tc::ex2(c1 - cj(tlo, d + 4))),
                           tc::tf32_operand(kv(thi, d + 4) * tc::ex2(c1 - cj(thi, d + 4)))};
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      tc::mma_tf32(dvv[n], a, __float_as_uint(gsm[d * kFStride + 8 * n + g]),
                   __float_as_uint(gsm[(d + 4) * kFStride + 8 * n + g]));
    }
  }
  if (warp + 1 < kWarps) {  // A^T[j, t] for t past the block, against step s + 15
    uint32_t kh[8][4];
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) {
      const int d = kk * 8 + t4;
      const float c0 = cj(s + 15, d), c1 = cj(s + 15, d + 4);
      kh[kk][0] = tc::tf32_operand(kv(tlo, d) * tc::ex2(c0 - cj(tlo, d)));
      kh[kk][1] = tc::tf32_operand(kv(thi, d) * tc::ex2(c0 - cj(thi, d)));
      kh[kk][2] = tc::tf32_operand(kv(tlo, d + 4) * tc::ex2(c1 - cj(tlo, d + 4)));
      kh[kk][3] = tc::tf32_operand(kv(thi, d + 4) * tc::ex2(c1 - cj(thi, d + 4)));
    }
    float c15[8][2];  // c_{s+15} at this lane's rows of B
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) {
      c15[kk][0] = cj(s + 15, kk * 8 + t4);
      c15[kk][1] = cj(s + 15, kk * 8 + t4 + 4);
    }
    for (int nt = 2 * warp + 2; nt < 8; ++nt) {
      float at[4] = {0.f, 0.f, 0.f, 0.f};
      const int t = 8 * nt + g;                        // this lane's column of A^T
#pragma unroll
      for (int kk = 0; kk < 8; ++kk) {
        const int d = kk * 8 + t4;
        tc::mma_tf32(at, kh[kk], tc::tf32_operand(rv(t, d) * tc::ex2(cp(t, d) - c15[kk][0])),
                     tc::tf32_operand(rv(t, d + 4) * tc::ex2(cp(t, d + 4) - c15[kk][1])));
      }
      const uint32_t a[4] = {tc::tf32_operand(at[0]), tc::tf32_operand(at[2]), tc::tf32_operand(at[1]),
                             tc::tf32_operand(at[3])};
      const int t2 = 8 * nt + 2 * t4;                  // the C fragment's columns, as k t4, t4 + 4
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        tc::mma_tf32(dvv[n], a, rb(gs, t2, 8 * n + g), rb(gs, t2 + 1, 8 * n + g));
      }
    }
  }
#pragma unroll
  for (int kk = 0; kk < 2; ++kk) {  // A[block]^T gy: A^T[j, t] in dA's upper triangle, t > j
    const int t = s + kk * 8 + t4;
    const uint32_t a[4] = {tc::tf32_operand(t > tlo ? da(tlo, t) : 0.f),
                           tc::tf32_operand(t > thi ? da(thi, t) : 0.f),
                           tc::tf32_operand(t + 4 > tlo ? da(tlo, t + 4) : 0.f),
                           tc::tf32_operand(t + 4 > thi ? da(thi, t + 4) : 0.f)};
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      tc::mma_tf32(dvv[n], a, rb(gs, t, 8 * n + g), rb(gs, t + 4, 8 * n + g));
    }
  }
  {  // the bonus: dv_j += (sum_i u_i r_j[i] k_j[i]) gy_j, in f32
    float b_lo = 0.f, b_hi = 0.f;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int b = 0; b < 2; ++b) {
        const int d = 8 * n + 2 * t4 + b;
        b_lo = __fmaf_rn(us[d] * rv(tlo, d), kv(tlo, d), b_lo);
        b_hi = __fmaf_rn(us[d] * rv(thi, d), kv(thi, d), b_hi);
      }
    }
    b_lo += __shfl_xor_sync(kFull, b_lo, 1);
    b_lo += __shfl_xor_sync(kFull, b_lo, 2);
    b_hi += __shfl_xor_sync(kFull, b_hi, 1);
    b_hi += __shfl_xor_sync(kFull, b_hi, 2);
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int b = 0; b < 2; ++b) {
        const int e = 8 * n + 2 * t4 + b;
        dvv[n][b] = __fmaf_rn(b_lo, __bfloat162float(gs[tlo * kBStride + e]), dvv[n][b]);
        dvv[n][2 + b] = __fmaf_rn(b_hi, __bfloat162float(gs[thi * kBStride + e]), dvv[n][2 + b]);
      }
    }
  }
  store_rows(dv_out + row0 * dv, dvv, len, s, g, t4, dv);
}

// du[h][d] = sum over the batch and the chunks of the gradient pass's
// partials, in a fixed order.
__global__ void __launch_bounds__(256)
wkv6_bwd_du_kernel(const float* __restrict__ du_part, float* __restrict__ du, int batch,
                   int heads, int n_chunks, int dk) {
  const int e = blockIdx.x * 256 + threadIdx.x;
  if (e >= heads * dk) return;
  const int h = e / dk, d = e % dk;
  float acc = 0.f;
  for (int b = 0; b < batch; ++b) {
    const float* p = du_part + (static_cast<int64_t>(b) * heads + h) * n_chunks * kMaxDim + d;
    for (int c = 0; c < n_chunks; ++c) acc += p[c * kMaxDim];
  }
  du[e] = acc;
}

cudaError_t launch(const void* r, const void* k, const void* v, const void* log_w, const void* u,
                   const void* gy, const void* gs_last, const void* states, void* g_states,
                   void* dr, void* dk_out, void* dv_out, void* dlog_w, void* du, void* ds0,
                   void* du_part, int batch, int heads, int steps, int dk, int dv,
                   cudaStream_t stream) {
  if (g_states == nullptr || !wkv6_chunk::aligned16(g_states) || du_part == nullptr) {
    return cudaErrorInvalidValue;
  }
  static std::atomic<unsigned long long> state_set{0}, grad_set{0};
  cudaError_t err = launch::max_dynamic_smem_once(
      state_set, reinterpret_cast<const void*>(wkv6_bwd_state_kernel),
      static_cast<int>(kStateSmemBytes), true);
  if (err != cudaSuccess) return err;
  err = launch::max_dynamic_smem_once(grad_set, reinterpret_cast<const void*>(wkv6_bwd_grad_kernel),
                                      static_cast<int>(kGradSmemBytes), true);
  if (err != cudaSuccess) return err;
  const bf16* tr = static_cast<const bf16*>(r);
  const bf16* tl = static_cast<const bf16*>(log_w);
  const bf16* tg = static_cast<const bf16*>(gy);
  const bool vec = dk % 8 == 0 && dv % 8 == 0 && wkv6_chunk::aligned16(r) &&
                   wkv6_chunk::aligned16(k) && wkv6_chunk::aligned16(v) &&
                   wkv6_chunk::aligned16(log_w) && wkv6_chunk::aligned16(gy);
  const int n_chunks = (steps + kChunk - 1) / kChunk;
  wkv6_bwd_state_kernel<<<batch * heads, kStateThreads, kStateSmemBytes, stream>>>(
      tr, tg, tl, static_cast<const float*>(gs_last), static_cast<float*>(g_states),
      static_cast<float*>(ds0), steps, dk, dv, vec);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  wkv6_bwd_grad_kernel<<<dim3(batch * heads, n_chunks), kThreads, kGradSmemBytes, stream>>>(
      tr, static_cast<const bf16*>(k), static_cast<const bf16*>(v), tl,
      static_cast<const float*>(u), tg, static_cast<const float*>(states),
      static_cast<const float*>(g_states), static_cast<bf16*>(dr), static_cast<bf16*>(dk_out),
      static_cast<bf16*>(dv_out), static_cast<bf16*>(dlog_w), static_cast<float*>(du_part),
      heads, steps, dk, dv, vec);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  wkv6_bwd_du_kernel<<<(heads * dk + 255) / 256, 256, 0, stream>>>(
      static_cast<const float*>(du_part), static_cast<float*>(du), batch, heads, n_chunks, dk);
  return cudaGetLastError();
}

}  // namespace chunked

}  // namespace

// r, k, log_w (B, H, T, dk), v and gy (B, H, T, dv) contiguous, all f32
// (is_bf16 = 0) or all bf16; u (H, dk) f32; s0 and gs_last (B, H, dk, dv) f32
// or null (zeros); 1 <= dk, dv <= 64.  `states` (B*H, ceil(T / 64), 64, 64)
// f32, 16-byte aligned: the state entering each chunk, as the two-pass
// forward leaves it in its workspace (have_states = 1), or filled here first
// (have_states = 0).  Scratch: for f32 dv_part (B*H, ceil(dk / 16), T, 64)
// and du_part (B, H, dk); for bf16 g_states (the layout of `states`, 16-byte
// aligned) and du_part (B*H, ceil(T / 64), 64), all f32 (null where unused).
// Writes dr, dk_out, dlog_w (B, H, T, dk) and dv_out (B, H, T, dv) in the
// input type, du (H, dk) and ds0 (B, H, dk, dv) f32.  Launches on `stream`
// (three or four kernels) and returns the first launch error (0 on success).
extern "C" int wkv6_bwd(const void* r, const void* k, const void* v, const void* log_w,
                        const void* u, const void* s0, const void* gy, const void* gs_last,
                        void* states, int have_states, void* dr, void* dk_out, void* dv_out,
                        void* dlog_w, void* du, void* ds0, void* dv_part, void* g_states,
                        void* du_part, int batch, int heads, int steps, int dk, int dv,
                        int is_bf16, void* stream) {
  if (dk < 1 || dk > kMaxDim || dv < 1 || dv > kMaxDim || steps < 1 || batch < 1 ||
      heads < 1 || states == nullptr || !wkv6_chunk::aligned16(states)) {
    return cudaErrorInvalidValue;
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!have_states) {
    const cudaError_t err =
        is_bf16 ? entry_states<bf16>(k, v, log_w, s0, states, batch, heads, steps, dk, dv, s)
                : entry_states<float>(k, v, log_w, s0, states, batch, heads, steps, dk, dv, s);
    if (err != cudaSuccess) return err;
  }
  if (is_bf16) {
    return chunked::launch(r, k, v, log_w, u, gy, gs_last, states, g_states, dr, dk_out, dv_out,
                           dlog_w, du, ds0, du_part, batch, heads, steps, dk, dv, s);
  }
  return run_f32(r, k, v, log_w, u, gy, gs_last, states, dr, dk_out, dv_out, dlog_w, du, ds0,
                 dv_part, du_part, batch, heads, steps, dk, dv, s);
}
