// Flash-attention backward for NVIDIA Hopper (sm_90a), hand-written CUDA C++.
//
// Two kernels replace the two TPU kernels of
// src/repro/kernels/flash_attention/kernel_bwd.py, which
// `flash_attention_bwd` launches there:
//   flash_bwd_dkv_kernel  <- _bwd_dkv_kernel  (dK, dV for one key tile)
//   flash_bwd_dq_kernel   <- _bwd_dq_kernel   (dQ for one query tile)
// Both take the MHA layout (B*H, S, D): GQA expansion of K/V and the group
// sum of dK/dV stay in the op (kernels/flash_attention/ops.py), as in the
// JAX package.  With the logsumexp L saved by the forward and
// D_i = sum_d dO_id O_id (computed by the wrapper):
//   P_ij  = exp(q_i . k_j * scale - L_i)          (0 where masked)
//   dV_j  = sum_i P_ij dO_i
//   dS_ij = P_ij (dO_i . v_j - D_i) scale
//   dK_j  = sum_i dS_ij q_i        dQ_i = sum_j dS_ij k_j
//
// What bounds them on the H100.  At the training shape (B*H = 256, S = 512,
// D = 80, causal, bf16) the two kernels together need ~14 GFLOP on the live
// (query, key) pairs against ~100 MB of inputs and outputs: a tensor-core
// pair would be bound by memory at a few tens of microseconds.  These first
// kernels do their arithmetic in f32 on the CUDA cores from shared memory, so
// their own limit is the FMA rate and the shared-memory reads feeding it.
// `wgmma`, TMA and a fused one-pass design are later work.
//
// Design.  8 warps per CTA.  A CTA owns a tile of rows (64, or 32 at D = 256
// so that shared memory stays under the 227 KB a block can have): the dK/dV
// kernel owns key rows and loops over the query tiles the mask leaves live;
// the dQ kernel owns query rows and loops over the live key tiles.  The TPU
// kernels' pl.when tile skipping becomes those loop bounds, taken from causal,
// window and off = sk - sq.  Each warp owns R = rows / 8 of the owned rows,
// and its lanes own output columns lane + 32 c (so head dim 80 needs no
// padding), accumulating in f32 registers.  The streamed tile is 64 rows
// wide, lane j taking rows j and j + 32; its rows are stored in shared
// memory padded to D + 1 floats so that a warp reading one column hits 32
// banks.  Scores, P and dS of the owned rows against the streamed rows stay
// in registers and reach the products by warp shuffles.  Masked pairs,
// pairs past the ragged edges and rows that are masked throughout give P = 0,
// hence no gradient, as the TPU kernels' jnp.where(mask, exp, 0) does.  The
// sums over the streamed tiles run in a fixed order in f32.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kStream = 64;  // rows of the streamed tile: two per lane
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// Rows owned by one CTA: 64, or 32 at D = 256 to fit shared memory.
template <int D>
__host__ __device__ constexpr int owned_rows() { return D > 128 ? 32 : 64; }

// Owned rows unpadded (read as broadcasts) + streamed rows padded to D + 1.
template <int D>
__host__ __device__ constexpr size_t smem_floats() {
  return 2 * static_cast<size_t>(owned_rows<D>()) * D + 2 * static_cast<size_t>(kStream) * (D + 1) +
         2 * kStream;
}

__device__ __forceinline__ bool live_pair(int qpos, int kpos, int sq, int sk, int off, bool causal,
                                          bool use_window, int window) {
  bool live = qpos < sq && kpos < sk;
  if (causal) live = live && kpos <= qpos + off;
  if (use_window) live = live && kpos > qpos + off - window;
  return live;
}

// Loads rows [r0, r0 + rows) of a (S, D) matrix as f32, zero past `s`, with
// row stride `stride` in shared memory.
template <typename T, int D>
__device__ __forceinline__ void load_rows(float* dst, const T* src, int r0, int rows, int s,
                                          int stride) {
  for (int i = threadIdx.x; i < rows * D; i += kThreads) {
    const int r = i / D;
    const int c = i - r * D;
    dst[r * stride + c] = r0 + r < s ? to_float(src[static_cast<int64_t>(r0) * D + i]) : 0.f;
  }
}

// dK, dV of one key tile.  grid = (ceil(sk / BK), B*H).
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                     const T* __restrict__ dout, const float* __restrict__ lse,
                     const float* __restrict__ dvec, T* __restrict__ dk, T* __restrict__ dv,
                     int sq, int sk, float scale, bool causal, bool use_window, int window) {
  constexpr int BK = owned_rows<D>();
  constexpr int R = BK / kWarps;       // key rows per warp
  constexpr int P = D + 1;             // padded stride of streamed rows
  constexpr int C = (D + 31) / 32;     // output columns per lane
  extern __shared__ float smem[];
  float* k_s = smem;                   // BK x D
  float* v_s = k_s + BK * D;           // BK x D
  float* q_s = v_s + BK * D;           // kStream x P
  float* do_s = q_s + kStream * P;     // kStream x P
  float* lse_s = do_s + kStream * P;   // kStream
  float* dvec_s = lse_s + kStream;     // kStream

  const int bh = blockIdx.y;
  const int k0 = blockIdx.x * BK;
  const T* q_g = q + static_cast<int64_t>(bh) * sq * D;
  const T* do_g = dout + static_cast<int64_t>(bh) * sq * D;
  const float* lse_g = lse + static_cast<int64_t>(bh) * sq;
  const float* dvec_g = dvec + static_cast<int64_t>(bh) * sq;
  const int off = sk - sq;
  const int lane = threadIdx.x % 32;
  const int row0 = (threadIdx.x / 32) * R;

  load_rows<T, D>(k_s, k + static_cast<int64_t>(bh) * sk * D, k0, BK, sk, D);
  load_rows<T, D>(v_s, v + static_cast<int64_t>(bh) * sk * D, k0, BK, sk, D);

  // Queries that attend some key of this tile: [q_lo, q_hi).
  const int k_last = min(k0 + BK, sk) - 1;
  int q_lo = 0;
  int q_hi = sq;
  if (causal) q_lo = max(q_lo, k0 - off);
  if (use_window) q_hi = min(q_hi, k_last - off + window);

  float dk_acc[R][C], dv_acc[R][C];
#pragma unroll
  for (int i = 0; i < R; ++i) {
#pragma unroll
    for (int c = 0; c < C; ++c) dk_acc[i][c] = dv_acc[i][c] = 0.f;
  }

  const int qt_begin = q_lo < q_hi ? (q_lo / kStream) * kStream : q_hi;
  for (int qt = qt_begin; qt < q_hi; qt += kStream) {
    __syncthreads();  // K/V written; the previous query tile consumed
    load_rows<T, D>(q_s, q_g, qt, kStream, sq, P);
    load_rows<T, D>(do_s, do_g, qt, kStream, sq, P);
    for (int i = threadIdx.x; i < kStream; i += kThreads) {
      const bool in = qt + i < sq;
      lse_s[i] = in ? lse_g[qt + i] : 0.f;
      dvec_s[i] = in ? dvec_g[qt + i] : 0.f;
    }
    __syncthreads();

    // s[i][h], dp[i][h]: key row0 + i against query qt + lane + 32 h.
    float s[R][2], dp[R][2];
#pragma unroll
    for (int i = 0; i < R; ++i) s[i][0] = s[i][1] = dp[i][0] = dp[i][1] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      const float q0 = q_s[lane * P + d];
      const float q1 = q_s[(lane + 32) * P + d];
      const float o0 = do_s[lane * P + d];
      const float o1 = do_s[(lane + 32) * P + d];
#pragma unroll
      for (int i = 0; i < R; ++i) {
        const float kv = k_s[(row0 + i) * D + d];
        const float vv = v_s[(row0 + i) * D + d];
        s[i][0] = fmaf(kv, q0, s[i][0]);
        s[i][1] = fmaf(kv, q1, s[i][1]);
        dp[i][0] = fmaf(vv, o0, dp[i][0]);
        dp[i][1] = fmaf(vv, o1, dp[i][1]);
      }
    }
    // s <- P, dp <- dS
#pragma unroll
    for (int i = 0; i < R; ++i) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int qr = lane + 32 * h;
        const bool live = live_pair(qt + qr, k0 + row0 + i, sq, sk, off, causal, use_window,
                                    window);
        const float p = live ? expf(s[i][h] * scale - lse_s[qr]) : 0.f;
        s[i][h] = p;
        dp[i][h] = p * (dp[i][h] - dvec_s[qr]) * scale;
      }
    }
    // dV[j][col] += sum_q P[j][q] dO[q][col];  dK[j][col] += sum_q dS[j][q] Q[q][col]
#pragma unroll
    for (int h = 0; h < 2; ++h) {
#pragma unroll 4
      for (int jj = 0; jj < 32; ++jj) {
        const int qr = h * 32 + jj;
        float ov[C], qv[C];
#pragma unroll
        for (int c = 0; c < C; ++c) {
          const int col = lane + 32 * c;
          ov[c] = col < D ? do_s[qr * P + col] : 0.f;
          qv[c] = col < D ? q_s[qr * P + col] : 0.f;
        }
#pragma unroll
        for (int i = 0; i < R; ++i) {
          const float p = __shfl_sync(kFull, s[i][h], jj);
          const float ds = __shfl_sync(kFull, dp[i][h], jj);
#pragma unroll
          for (int c = 0; c < C; ++c) {
            dv_acc[i][c] = fmaf(p, ov[c], dv_acc[i][c]);
            dk_acc[i][c] = fmaf(ds, qv[c], dk_acc[i][c]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int kpos = k0 + row0 + i;
    if (kpos >= sk) continue;
    const int64_t base = (static_cast<int64_t>(bh) * sk + kpos) * D;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int col = lane + 32 * c;
      if (col < D) {
        dk[base + col] = from_float<T>(dk_acc[i][c]);
        dv[base + col] = from_float<T>(dv_acc[i][c]);
      }
    }
  }
}

// dQ of one query tile.  grid = (ceil(sq / BQ), B*H).
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                    const T* __restrict__ dout, const float* __restrict__ lse,
                    const float* __restrict__ dvec, T* __restrict__ dq, int sq, int sk,
                    float scale, bool causal, bool use_window, int window) {
  constexpr int BQ = owned_rows<D>();
  constexpr int R = BQ / kWarps;       // query rows per warp
  constexpr int P = D + 1;
  constexpr int C = (D + 31) / 32;
  extern __shared__ float smem[];
  float* q_s = smem;                   // BQ x D
  float* do_s = q_s + BQ * D;          // BQ x D
  float* k_s = do_s + BQ * D;          // kStream x P
  float* v_s = k_s + kStream * P;      // kStream x P

  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * BQ;
  const T* k_g = k + static_cast<int64_t>(bh) * sk * D;
  const T* v_g = v + static_cast<int64_t>(bh) * sk * D;
  const int off = sk - sq;
  const int lane = threadIdx.x % 32;
  const int row0 = (threadIdx.x / 32) * R;

  load_rows<T, D>(q_s, q + static_cast<int64_t>(bh) * sq * D, q0, BQ, sq, D);
  load_rows<T, D>(do_s, dout + static_cast<int64_t>(bh) * sq * D, q0, BQ, sq, D);
  float lse_r[R], dvec_r[R];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int qpos = q0 + row0 + i;
    const bool in = qpos < sq;
    lse_r[i] = in ? lse[static_cast<int64_t>(bh) * sq + qpos] : 0.f;
    dvec_r[i] = in ? dvec[static_cast<int64_t>(bh) * sq + qpos] : 0.f;
  }

  // Keys that some query of this tile attends: [k_lo, k_hi).
  const int q_last = min(q0 + BQ, sq) - 1;
  int k_lo = 0;
  int k_hi = sk;
  if (causal) k_hi = min(k_hi, q_last + off + 1);
  if (use_window) k_lo = max(k_lo, q0 + off - window + 1);

  float dq_acc[R][C];
#pragma unroll
  for (int i = 0; i < R; ++i) {
#pragma unroll
    for (int c = 0; c < C; ++c) dq_acc[i][c] = 0.f;
  }

  const int kt_begin = k_lo < k_hi ? (k_lo / kStream) * kStream : k_hi;
  for (int kt = kt_begin; kt < k_hi; kt += kStream) {
    __syncthreads();  // Q/dO written; the previous key tile consumed
    load_rows<T, D>(k_s, k_g, kt, kStream, sk, P);
    load_rows<T, D>(v_s, v_g, kt, kStream, sk, P);
    __syncthreads();

    // s[i][h], dp[i][h]: query row0 + i against key kt + lane + 32 h.
    float s[R][2], dp[R][2];
#pragma unroll
    for (int i = 0; i < R; ++i) s[i][0] = s[i][1] = dp[i][0] = dp[i][1] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      const float k0v = k_s[lane * P + d];
      const float k1v = k_s[(lane + 32) * P + d];
      const float v0v = v_s[lane * P + d];
      const float v1v = v_s[(lane + 32) * P + d];
#pragma unroll
      for (int i = 0; i < R; ++i) {
        const float qv = q_s[(row0 + i) * D + d];
        const float ov = do_s[(row0 + i) * D + d];
        s[i][0] = fmaf(qv, k0v, s[i][0]);
        s[i][1] = fmaf(qv, k1v, s[i][1]);
        dp[i][0] = fmaf(ov, v0v, dp[i][0]);
        dp[i][1] = fmaf(ov, v1v, dp[i][1]);
      }
    }
    // dp <- dS
#pragma unroll
    for (int i = 0; i < R; ++i) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const bool live = live_pair(q0 + row0 + i, kt + lane + 32 * h, sq, sk, off, causal,
                                    use_window, window);
        const float p = live ? expf(s[i][h] * scale - lse_r[i]) : 0.f;
        dp[i][h] = p * (dp[i][h] - dvec_r[i]) * scale;
      }
    }
    // dQ[i][col] += sum_j dS[i][j] K[j][col]
#pragma unroll
    for (int h = 0; h < 2; ++h) {
#pragma unroll 4
      for (int jj = 0; jj < 32; ++jj) {
        const int kr = h * 32 + jj;
        float kv[C];
#pragma unroll
        for (int c = 0; c < C; ++c) {
          const int col = lane + 32 * c;
          kv[c] = col < D ? k_s[kr * P + col] : 0.f;
        }
#pragma unroll
        for (int i = 0; i < R; ++i) {
          const float ds = __shfl_sync(kFull, dp[i][h], jj);
#pragma unroll
          for (int c = 0; c < C; ++c) dq_acc[i][c] = fmaf(ds, kv[c], dq_acc[i][c]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int qpos = q0 + row0 + i;
    if (qpos >= sq) continue;
    const int64_t base = (static_cast<int64_t>(bh) * sq + qpos) * D;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int col = lane + 32 * c;
      if (col < D) dq[base + col] = from_float<T>(dq_acc[i][c]);
    }
  }
}

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const float* lse;
  const float* dvec;
  int bh, sq, sk;
  float scale;
  int causal, use_window, window;
  cudaStream_t stream;
};

template <typename T, int D>
cudaError_t launch_dkv(const Args& a, void* dk, void* dv) {
  const size_t smem = sizeof(float) * smem_floats<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkv_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((a.sk + owned_rows<D>() - 1) / owned_rows<D>(), a.bh);
  flash_bwd_dkv_kernel<T, D><<<grid, kThreads, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<const T*>(a.dout), a.lse, a.dvec, static_cast<T*>(dk), static_cast<T*>(dv),
      a.sq, a.sk, a.scale, a.causal != 0, a.use_window != 0, a.window);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_dq(const Args& a, void* dq) {
  const size_t smem = sizeof(float) * smem_floats<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((a.sq + owned_rows<D>() - 1) / owned_rows<D>(), a.bh);
  flash_bwd_dq_kernel<T, D><<<grid, kThreads, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<const T*>(a.dout), a.lse, a.dvec, static_cast<T*>(dq), a.sq, a.sk, a.scale,
      a.causal != 0, a.use_window != 0, a.window);
  return cudaGetLastError();
}

// Calls LAUNCH<T, D>(args...) for the runtime head dim d.
#define DISPATCH_HEAD_DIM(LAUNCH, T, d, ...)        \
  switch (d) {                                      \
    case 16: return LAUNCH<T, 16>(__VA_ARGS__);     \
    case 32: return LAUNCH<T, 32>(__VA_ARGS__);     \
    case 64: return LAUNCH<T, 64>(__VA_ARGS__);     \
    case 80: return LAUNCH<T, 80>(__VA_ARGS__);     \
    case 128: return LAUNCH<T, 128>(__VA_ARGS__);   \
    case 256: return LAUNCH<T, 256>(__VA_ARGS__);   \
    default: return cudaErrorInvalidValue;          \
  }

template <typename T>
cudaError_t dkv(const Args& a, int d, void* dk, void* dv) {
  DISPATCH_HEAD_DIM(launch_dkv, T, d, a, dk, dv)
}

template <typename T>
cudaError_t dq(const Args& a, int d, void* out) {
  DISPATCH_HEAD_DIM(launch_dq, T, d, a, out)
}

}  // namespace

// q, dout (BH, Sq, D) and k, v (BH, Sk, D) contiguous, f32 (is_bf16 = 0) or
// bf16; lse and dvec (BH, Sq) f32.  Writes dk and dv (BH, Sk, D) in the input
// type.  Launches on `stream`; returns the launch's cudaError_t (0 on success).
extern "C" int flash_attention_bwd_dkv(const void* q, const void* k, const void* v,
                                       const void* dout, const void* lse, const void* dvec,
                                       void* dk, void* dv, int bh, int sq, int sk, int d,
                                       int is_bf16, float scale, int causal, int use_window,
                                       int window, void* stream) {
  const Args a{q, k, v, dout, static_cast<const float*>(lse), static_cast<const float*>(dvec),
               bh, sq, sk, scale, causal, use_window, window, static_cast<cudaStream_t>(stream)};
  return is_bf16 ? dkv<__nv_bfloat16>(a, d, dk, dv) : dkv<float>(a, d, dk, dv);
}

// As above; writes dq (BH, Sq, D) in the input type.
extern "C" int flash_attention_bwd_dq(const void* q, const void* k, const void* v,
                                      const void* dout, const void* lse, const void* dvec,
                                      void* dq_out, int bh, int sq, int sk, int d, int is_bf16,
                                      float scale, int causal, int use_window, int window,
                                      void* stream) {
  const Args a{q, k, v, dout, static_cast<const float*>(lse), static_cast<const float*>(dvec),
               bh, sq, sk, scale, causal, use_window, window, static_cast<cudaStream_t>(stream)};
  return is_bf16 ? dq<__nv_bfloat16>(a, d, dq_out) : dq<float>(a, d, dq_out);
}
