// Flash-attention backward for NVIDIA Hopper (sm_90a), hand-written CUDA C++.
//
// Two kernels replace the two TPU kernels of
// src/repro/kernels/flash_attention/kernel_bwd.py, which
// `flash_attention_bwd` launches there, each in two variants chosen by the
// inputs' dtype (never by failure): bf16 (the trained model's type) on the
// tensor cores, f32 (the card-vs-CPU parity checks) on the CUDA cores.
//   flash_bwd_dkv_tc_kernel (bf16), flash_bwd_dkv_kernel (f32)
//                         <- _bwd_dkv_kernel  (dK, dV for one key tile)
//   flash_bwd_dq_tc_kernel (bf16), flash_bwd_dq_kernel (f32)
//                         <- _bwd_dq_kernel   (dQ for one query tile)
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
// D = 80, causal, bf16) the dK/dV kernel needs 8 D FLOPs per live (query,
// key) pair, 21.5 GFLOP, against ~127 MB of inputs and outputs: 0.038 ms at
// 3.35 TB/s, so the bytes bound it, while the FLOPs take 0.022 ms at the
// tensor cores' 989 TFLOP/s and at least 0.32 ms on the CUDA cores (67
// TFLOP/s in f32), which is why the bf16 variants run on the tensor cores.
// The dQ kernel needs 6 D FLOPs a pair (16.1 GFLOP) against ~106 MB: 0.032
// ms of bytes against 0.016 ms of tensor-core FLOPs.
// `mma.sync` rather than `wgmma`: see flash_attention_fwd.cu.
//
// dK/dV, bf16 design (tensor cores, after FlashAttention-2).  One CTA per
// (b*h, 64-key tile), 4 warps, each owning 16 keys; under a causal mask the
// first key tiles, which the most queries attend, start first.  The CTA
// streams the live query tiles of 32 rows: Q, dO, lse and dvec are
// double-buffered in shared memory with cp.async (the next tile's copy flies
// while this one is computed; rows past sq are zero-filled by the copies'
// source size), rows padded to D + 8 elements so that ldmatrix reads are free
// of bank conflicts.  K and V of the owned keys stay in shared memory and are
// read by ldmatrix per query tile (the accumulators take the registers).  Per
// warp and query tile, with mma.m16n8k16.bf16 into f32:
//   S^T = K Q^T;  P^T = exp(S^T scale - lse), 0 where masked (ex2.approx);
//   dV += P^T dO  (P^T rounded to bf16 in registers as the A operand, dO by ldmatrix.trans);
//   dP^T = V dO^T;  dS^T = P^T (dP^T - dvec) scale;
//   dK += dS^T Q  (dS^T rounded to bf16 in registers, Q by ldmatrix.trans).
// Every product is warp-local: no cross-warp reduction, no atomics, and every
// sum runs in a fixed order, so two runs give the same bits.  Up to D = 96 one
// pass accumulates dK and dV together (166 registers at D = 80: three CTAs an
// SM; at D = 96, MLA's query/key head, two 16 x 96 f32 accumulators take 96
// registers a thread and two CTAs fit an SM); from D = 128 on, one pass accumulates dV and a second one dK, each
// recomputing P^T, so that at D = 256 one 16 x 256 f32 accumulator (128
// registers) lives at a time and the kernel stays under 255 registers without
// spills.  Rounding P^T and dS^T to bf16 before their products is the one
// numerical difference from the TPU kernel, which multiplies them in f32.
// Shared memory: K, V and two stages of Q and dO tiles, (2 * 64 + 4 * 32) x
// (D + 8) bf16, and 128 floats: 45 KB at D = 80, 53 KB at D = 96 and 133 KB
// at D = 256.  D = 96 rows are 192 bytes, twelve 16-byte cp.async chunks.
//
// dQ, bf16 design (tensor cores, the forward's loop).  One CTA per (b*h,
// 64-query tile), 4 warps of 16 query rows; under a causal mask the query
// tiles run last to first, so the heaviest start first.  Q and dO of the
// CTA's rows are copied into shared memory once and read by ldmatrix as A
// operands; lse and dvec of a lane's two rows are held in registers.  The CTA
// loops over the live key tiles (64 keys, 32 at D = 256, where the 16 x 256
// f32 dQ accumulator takes 128 registers), K and V double-buffered with
// cp.async, rows padded to D + 8 elements; the loop bounds and the
// per-element masks of cut tiles are the forward's.  Per warp and key tile,
// with mma.m16n8k16.bf16 into f32:
//   S = Q K^T and dP = dO V^T  (K and V as B operands by ldmatrix);
//   P = 2^(S scale log2e - lse log2e), 0 where masked;  dS = P (dP - dvec) scale;
//   dQ += dS K  (dS rounded to bf16 in registers as the A operand, K by ldmatrix.trans).
// dQ is not folded into the dK/dV kernel with atomicAdd, as FlashAttention-2
// does: warp-local products and a fixed order of every sum give the same bits
// on every run.  Rounding dS to bf16 before dS K is the one numerical
// difference from the TPU kernel.  Shared memory: Q and dO tiles and two
// stages of K and V tiles, (2 * 64 + 4 * 64) x (D + 8) bf16 = 66 KB at D = 80,
// 78 KB at D = 96, (2 * 64 + 4 * 32) x 264 = 132 KB at D = 256.  Up to D = 80 it is held to 170
// registers: three CTAs an SM.  Inputs must be 16-byte aligned (the wrapper
// checks).
//
// f32 variants (the first design of the port, unchanged).  8 warps per CTA.
// A CTA owns a tile of rows (64, or 32 at D = 256 so that shared memory stays
// under the 227 KB a block can have): the dK/dV kernel owns key rows and
// loops over the query tiles the mask leaves live; the dQ kernel owns query
// rows and loops over the live key tiles.  The TPU kernels' pl.when tile
// skipping becomes those loop bounds, taken from causal, window and
// off = sk - sq.  Each warp owns R = rows / 8 of the owned rows, and its
// lanes own output columns lane + 32 c (so head dim 80 needs no padding),
// accumulating in f32 registers.  The streamed tile is 64 rows wide, lane j
// taking rows j and j + 32; its rows are stored in shared memory padded to
// D + 1 floats so that a warp reading one column hits 32 banks.  Scores, P
// and dS of the owned rows against the streamed rows stay in registers and
// reach the products by warp shuffles.  Masked pairs, pairs past the ragged
// edges and rows that are masked throughout give P = 0, hence no gradient,
// as the TPU kernels' jnp.where(mask, exp, 0) does.  The sums over the
// streamed tiles run in a fixed order in f32.
//
// Each launcher raises its kernel's dynamic shared-memory limit once per
// device (launch.cuh), not on every launch.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "launch.cuh"
#include "tensor_core.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kStream = 64;  // rows of the streamed tile: two per lane
constexpr unsigned kFull = 0xffffffffu;

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

// Loads rows [r0, r0 + rows) of a (S, D) matrix, zero past `s`, with row
// stride `stride` in shared memory.
template <int D>
__device__ __forceinline__ void load_rows(float* dst, const float* src, int r0, int rows, int s,
                                          int stride) {
  for (int i = threadIdx.x; i < rows * D; i += kThreads) {
    const int r = i / D;
    const int c = i - r * D;
    dst[r * stride + c] = r0 + r < s ? src[static_cast<int64_t>(r0) * D + i] : 0.f;
  }
}

// dK, dV of one key tile, f32.  grid = (ceil(sk / BK), B*H).
template <int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, const float* __restrict__ dout,
                     const float* __restrict__ lse, const float* __restrict__ dvec,
                     float* __restrict__ dk, float* __restrict__ dv, int sq, int sk, float scale,
                     bool causal, bool use_window, int window) {
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
  const float* q_g = q + static_cast<int64_t>(bh) * sq * D;
  const float* do_g = dout + static_cast<int64_t>(bh) * sq * D;
  const float* lse_g = lse + static_cast<int64_t>(bh) * sq;
  const float* dvec_g = dvec + static_cast<int64_t>(bh) * sq;
  const int off = sk - sq;
  const int lane = threadIdx.x % 32;
  const int row0 = (threadIdx.x / 32) * R;

  load_rows<D>(k_s, k + static_cast<int64_t>(bh) * sk * D, k0, BK, sk, D);
  load_rows<D>(v_s, v + static_cast<int64_t>(bh) * sk * D, k0, BK, sk, D);

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
    load_rows<D>(q_s, q_g, qt, kStream, sq, P);
    load_rows<D>(do_s, do_g, qt, kStream, sq, P);
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
        dk[base + col] = dk_acc[i][c];
        dv[base + col] = dv_acc[i][c];
      }
    }
  }
}

// dQ of one query tile, f32.  grid = (ceil(sq / BQ), B*H).
template <int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, const float* __restrict__ dout,
                    const float* __restrict__ lse, const float* __restrict__ dvec,
                    float* __restrict__ dq, int sq, int sk, float scale, bool causal,
                    bool use_window, int window) {
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
  const float* k_g = k + static_cast<int64_t>(bh) * sk * D;
  const float* v_g = v + static_cast<int64_t>(bh) * sk * D;
  const int off = sk - sq;
  const int lane = threadIdx.x % 32;
  const int row0 = (threadIdx.x / 32) * R;

  load_rows<D>(q_s, q + static_cast<int64_t>(bh) * sq * D, q0, BQ, sq, D);
  load_rows<D>(do_s, dout + static_cast<int64_t>(bh) * sq * D, q0, BQ, sq, D);
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
    load_rows<D>(k_s, k_g, kt, kStream, sk, P);
    load_rows<D>(v_s, v_g, kt, kStream, sk, P);
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
      if (col < D) dq[base + col] = dq_acc[i][c];
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

// The f32 kernels' launches (bf16::launch_dkv and bf16::launch_dq launch the
// bf16 ones).
template <int D>
cudaError_t launch_dkv(const Args& a, void* dk, void* dv) {
  constexpr size_t smem = sizeof(float) * smem_floats<D>();
  static std::atomic<unsigned long long> smem_set{0};
  cudaError_t err = launch::max_dynamic_smem_once(
      smem_set, reinterpret_cast<const void*>(flash_bwd_dkv_kernel<D>), static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((a.sk + owned_rows<D>() - 1) / owned_rows<D>(), a.bh);
  flash_bwd_dkv_kernel<D><<<grid, kThreads, smem, a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<const float*>(a.dout), a.lse, a.dvec,
      static_cast<float*>(dk), static_cast<float*>(dv), a.sq, a.sk, a.scale, a.causal != 0,
      a.use_window != 0, a.window);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dq(const Args& a, void* dq) {
  constexpr size_t smem = sizeof(float) * smem_floats<D>();
  static std::atomic<unsigned long long> smem_set{0};
  cudaError_t err = launch::max_dynamic_smem_once(
      smem_set, reinterpret_cast<const void*>(flash_bwd_dq_kernel<D>), static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((a.sq + owned_rows<D>() - 1) / owned_rows<D>(), a.bh);
  flash_bwd_dq_kernel<D><<<grid, kThreads, smem, a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<const float*>(a.dout), a.lse, a.dvec,
      static_cast<float*>(dq), a.sq, a.sk, a.scale, a.causal != 0, a.use_window != 0, a.window);
  return cudaGetLastError();
}

// Returns the expression after d, with the constant D set to the runtime head dim d.
#define DISPATCH_HEAD_DIM(d, ...)                                \
  switch (d) {                                                   \
    case 16: { constexpr int D = 16; return __VA_ARGS__; }       \
    case 32: { constexpr int D = 32; return __VA_ARGS__; }       \
    case 64: { constexpr int D = 64; return __VA_ARGS__; }       \
    case 80: { constexpr int D = 80; return __VA_ARGS__; }       \
    case 96: { constexpr int D = 96; return __VA_ARGS__; }       \
    case 128: { constexpr int D = 128; return __VA_ARGS__; }     \
    case 256: { constexpr int D = 256; return __VA_ARGS__; }     \
    default: return cudaErrorInvalidValue;                       \
  }

// ---- dK/dV and dQ, bf16 variants: tensor cores ---------------------------------

namespace bf16 {

using T = __nv_bfloat16;
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kBlockK = 16 * kWarps;  // 16 owned keys per warp
// Rows of a streamed query tile.  32 keeps S^T and dP^T at 16 registers each,
// so that at D = 80 the kernel needs 166 registers (three CTAs an SM) and at
// D = 256 the pass for dK, with its 16 x 256 f32 accumulator (128
// registers), stays under 255 without spills.
constexpr int kBlockQ = 32;
constexpr float kLog2e = 1.4426950408889634f;

// K and V tiles, then two stages of (Q, dO) tiles, rows padded to D + 8
// elements, then two stages of (lse, dvec).
template <int D>
constexpr size_t smem_bytes() {
  return sizeof(T) * static_cast<size_t>((2 * kBlockK + 4 * kBlockQ) * (D + 8)) +
         sizeof(float) * 4 * kBlockQ;
}

// One pass over the live query tiles of key tile k0: accumulates dV (kDV)
// and/or dK (kDK) for the warp's 16 keys and writes them.  Every product is
// warp-local and every sum runs in a fixed order.
template <int D, bool kDV, bool kDK>
__device__ __forceinline__ void dkv_pass(unsigned char* smem, const T* q_g, const T* k_g,
                                         const T* v_g, const T* do_g, const float* lse_g,
                                         const float* dvec_g, T* dk_g, T* dv_g, int k0, int sq,
                                         int sk, float scale, bool causal, bool use_window,
                                         int window) {
  constexpr int kStride = D + 8;
  constexpr int kTile = kBlockQ * kStride;  // a query tile
  constexpr int kSlices = D / 16;
  constexpr int kQueryTiles = kBlockQ / 8;  // n-tiles of S^T
  T* k_s = reinterpret_cast<T*>(smem);
  T* v_s = k_s + kBlockK * kStride;
  T* q_s = v_s + kBlockK * kStride;     // stage s at q_s + 2 s kTile
  T* do_s = q_s + kTile;                // stage s at do_s + 2 s kTile
  float* lse_s = reinterpret_cast<float*>(q_s + 4 * kTile);  // stage s at lse_s + 2 s kBlockQ
  float* dvec_s = lse_s + kBlockQ;                           // stage s at dvec_s + 2 s kBlockQ

  const int off = sk - sq;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int t4 = lane % 4;
  const int wkey = warp * 16;           // this warp's first key in the tile

  // Queries that attend some key of this tile: [q_lo, q_hi).
  const int k_last = min(k0 + kBlockK, sk) - 1;
  int q_lo = 0;
  int q_hi = sq;
  if (causal) q_lo = max(q_lo, k0 - off);
  if (use_window) q_hi = min(q_hi, k_last - off + window);
  const int qt_begin = q_lo < q_hi ? (q_lo / kBlockQ) * kBlockQ : q_hi;
  const int n_tiles = (q_hi - qt_begin + kBlockQ - 1) / kBlockQ;

  // Q, dO, lse and dvec of query tile qt into `stage` (rows past sq read as 0)
  auto load_query_tile = [&](int stage, int qt) {
    tc::load_tile_async<D, kBlockQ, kThreads>(q_s + 2 * stage * kTile, q_g, qt, sq);
    tc::load_tile_async<D, kBlockQ, kThreads>(do_s + 2 * stage * kTile, do_g, qt, sq);
    // lse by threads [0, kBlockQ), dvec by threads [64, 64 + kBlockQ)
    const int tid = static_cast<int>(threadIdx.x);
    const int i = tid % 64;
    const bool in = qt + i < sq;
    if (i >= kBlockQ) return;
    if (tid < 64) {
      tc::cp_async4(lse_s + 2 * stage * kBlockQ + i, lse_g + (in ? qt + i : 0), in ? 4 : 0);
    } else if (kDK) {
      tc::cp_async4(dvec_s + 2 * stage * kBlockQ + i, dvec_g + (in ? qt + i : 0), in ? 4 : 0);
    }
  };

  if (n_tiles > 0) {
    tc::load_tile_async<D, kBlockK, kThreads>(k_s, k_g, k0, sk);
    if (kDK) tc::load_tile_async<D, kBlockK, kThreads>(v_s, v_g, k0, sk);
    load_query_tile(0, qt_begin);
    tc::cp_async_commit();
  }

  float dv_acc[kDV ? 2 * kSlices : 1][4];
  float dk_acc[kDK ? 2 * kSlices : 1][4];
#pragma unroll
  for (int j = 0; j < (kDV ? 2 * kSlices : 1); ++j) {
    dv_acc[j][0] = dv_acc[j][1] = dv_acc[j][2] = dv_acc[j][3] = 0.f;
  }
#pragma unroll
  for (int j = 0; j < (kDK ? 2 * kSlices : 1); ++j) {
    dk_acc[j][0] = dk_acc[j][1] = dk_acc[j][2] = dk_acc[j][3] = 0.f;
  }
  const bool warp_live = k0 + wkey < sk;  // some key of this warp exists
  const T* k_frag = k_s + (wkey + lane % 16) * kStride + (lane / 16) * 8;
  const T* v_frag = v_s + (wkey + lane % 16) * kStride + (lane / 16) * 8;

  for (int t = 0; t < n_tiles; ++t) {
    const int qt = qt_begin + t * kBlockQ;
    const int stage = t & 1;
    if (t + 1 < n_tiles) {  // the next tile's copy flies while this one is computed
      load_query_tile(stage ^ 1, qt + kBlockQ);
      tc::cp_async_commit();
      tc::cp_async_wait<1>();
    } else {
      tc::cp_async_wait<0>();
    }
    __syncthreads();
    if (warp_live) {
      const T* qs = q_s + 2 * stage * kTile;
      const T* dos = do_s + 2 * stage * kTile;
      const float* lses = lse_s + 2 * stage * kBlockQ;
      const float* dvecs = dvec_s + 2 * stage * kBlockQ;
      // S^T = K Q^T and (for dK) dP^T = V dO^T: 16 keys x kBlockQ queries,
      // n-tile j holds queries qt + 8 j ..
      float st[kQueryTiles][4], dpt[kDK ? kQueryTiles : 1][4];
#pragma unroll
      for (int j = 0; j < kQueryTiles; ++j) st[j][0] = st[j][1] = st[j][2] = st[j][3] = 0.f;
#pragma unroll
      for (int j = 0; j < (kDK ? kQueryTiles : 1); ++j) {
        dpt[j][0] = dpt[j][1] = dpt[j][2] = dpt[j][3] = 0.f;
      }
#pragma unroll
      for (int kk = 0; kk < kSlices; ++kk) {
        const int b_off = (lane % 8 + (lane / 16) * 8) * kStride + kk * 16 + ((lane / 8) % 2) * 8;
        uint32_t a[4];
        tc::ldmatrix_x4(a, k_frag + kk * 16);
#pragma unroll
        for (int np = 0; np < kQueryTiles / 2; ++np) {
          uint32_t b[4];
          tc::ldmatrix_x4(b, qs + np * 16 * kStride + b_off);
          tc::mma_bf16(st[2 * np], a, b[0], b[1]);
          tc::mma_bf16(st[2 * np + 1], a, b[2], b[3]);
        }
        if constexpr (kDK) {
          tc::ldmatrix_x4(a, v_frag + kk * 16);
#pragma unroll
          for (int np = 0; np < kQueryTiles / 2; ++np) {
            uint32_t b[4];
            tc::ldmatrix_x4(b, dos + np * 16 * kStride + b_off);
            tc::mma_bf16(dpt[2 * np], a, b[0], b[1]);
            tc::mma_bf16(dpt[2 * np + 1], a, b[2], b[3]);
          }
        }
      }
      // P^T = exp(S^T scale - lse), 0 where masked (per element, only on a
      // tile that the mask or a ragged edge cuts); dS^T = P^T (dP^T - dvec) scale
      const bool cut = qt + kBlockQ > sq || k0 + kBlockK > sk ||
                       (causal && k0 + kBlockK - 1 > qt + off) ||
                       (use_window && k0 <= qt + kBlockQ - 1 + off - window);
#pragma unroll
      for (int j = 0; j < kQueryTiles; ++j) {
        const float2 lse2 = *reinterpret_cast<const float2*>(lses + 8 * j + 2 * t4);
        const float2 dvec2 = *reinterpret_cast<const float2*>(dvecs + 8 * j + 2 * t4);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          bool live = true;
          if (cut) {
            const int kpos = k0 + wkey + g + 8 * (e / 2);
            const int qpos = qt + 8 * j + 2 * t4 + (e % 2);
            live = qpos < sq && kpos < sk;
            if (causal) live = live && kpos <= qpos + off;
            if (use_window) live = live && kpos > qpos + off - window;
          }
          const float p =
              live ? tc::ex2((st[j][e] * scale - (e % 2 ? lse2.y : lse2.x)) * kLog2e) : 0.f;
          st[j][e] = p;
          if constexpr (kDK) dpt[j][e] = p * (dpt[j][e] - (e % 2 ? dvec2.y : dvec2.x)) * scale;
        }
      }
      // dV += P^T dO and dK += dS^T Q: P^T and dS^T rounded to bf16 in
      // registers are the A operands; dO and Q through ldmatrix.trans
#pragma unroll
      for (int kk = 0; kk < kQueryTiles / 2; ++kk) {  // queries 16 kk .. 16 kk + 15
        const int b_off = (kk * 16 + lane % 8 + ((lane / 8) % 2) * 8) * kStride + (lane / 16) * 8;
        uint32_t a[4];
        if constexpr (kDV) {
          tc::c_to_a(a, st[2 * kk], st[2 * kk + 1]);
#pragma unroll
          for (int dp = 0; dp < kSlices; ++dp) {
            uint32_t b[4];
            tc::ldmatrix_x4_trans(b, dos + b_off + dp * 16);
            tc::mma_bf16(dv_acc[2 * dp], a, b[0], b[1]);
            tc::mma_bf16(dv_acc[2 * dp + 1], a, b[2], b[3]);
          }
        }
        if constexpr (kDK) {
          tc::c_to_a(a, dpt[2 * kk], dpt[2 * kk + 1]);
#pragma unroll
          for (int dp = 0; dp < kSlices; ++dp) {
            uint32_t b[4];
            tc::ldmatrix_x4_trans(b, qs + b_off + dp * 16);
            tc::mma_bf16(dk_acc[2 * dp], a, b[0], b[1]);
            tc::mma_bf16(dk_acc[2 * dp + 1], a, b[2], b[3]);
          }
        }
      }
    }
    __syncthreads();  // this stage is read out before the copy after next overwrites it
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int kpos = k0 + wkey + g + 8 * r;
    if (kpos >= sk) continue;
    const int64_t base = static_cast<int64_t>(kpos) * D + 2 * t4;
#pragma unroll
    for (int j = 0; j < 2 * kSlices; ++j) {
      if constexpr (kDV) {
        *reinterpret_cast<__nv_bfloat162*>(dv_g + base + 8 * j) =
            __floats2bfloat162_rn(dv_acc[j][2 * r], dv_acc[j][2 * r + 1]);
      }
      if constexpr (kDK) {
        *reinterpret_cast<__nv_bfloat162*>(dk_g + base + 8 * j) =
            __floats2bfloat162_rn(dk_acc[j][2 * r], dk_acc[j][2 * r + 1]);
      }
    }
  }
}

// dK, dV of one 64-key tile.  grid = (B*H, ceil(sk / 64)): under a causal mask
// the first key tiles, which the most queries attend, start first.  Up to
// D = 96 one pass accumulates both; from D = 128 on, dV and then dK each take
// a pass over the query tiles (recomputing P^T), so that one f32 accumulator
// of 16 x D lives at a time and the kernel stays under 255 registers.
template <int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_tc_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const T* __restrict__ dout,
                        const float* __restrict__ lse, const float* __restrict__ dvec,
                        T* __restrict__ dk, T* __restrict__ dv, int sq, int sk, float scale,
                        bool causal, bool use_window, int window) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int64_t bh = blockIdx.x;
  const int k0 = blockIdx.y * kBlockK;
  const T* q_g = q + bh * sq * D;
  const T* k_g = k + bh * sk * D;
  const T* v_g = v + bh * sk * D;
  const T* do_g = dout + bh * sq * D;
  const float* lse_g = lse + bh * sq;
  const float* dvec_g = dvec + bh * sq;
  T* dk_g = dk + bh * sk * D;
  T* dv_g = dv + bh * sk * D;
  if constexpr (D <= 96) {
    dkv_pass<D, true, true>(smem, q_g, k_g, v_g, do_g, lse_g, dvec_g, dk_g, dv_g, k0, sq, sk,
                            scale, causal, use_window, window);
  } else {
    dkv_pass<D, true, false>(smem, q_g, k_g, v_g, do_g, lse_g, dvec_g, dk_g, dv_g, k0, sq, sk,
                             scale, causal, use_window, window);
    __syncthreads();
    dkv_pass<D, false, true>(smem, q_g, k_g, v_g, do_g, lse_g, dvec_g, dk_g, dv_g, k0, sq, sk,
                             scale, causal, use_window, window);
  }
}

template <int D>
cudaError_t launch_dkv(const Args& a, void* dk, void* dv) {
  constexpr size_t smem = smem_bytes<D>();
  static std::atomic<unsigned long long> smem_set{0};
  cudaError_t err = launch::max_dynamic_smem_once(
      smem_set, reinterpret_cast<const void*>(flash_bwd_dkv_tc_kernel<D>), static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(a.bh, (a.sk + kBlockK - 1) / kBlockK);
  flash_bwd_dkv_tc_kernel<D><<<grid, kThreads, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<const T*>(a.dout), a.lse, a.dvec, static_cast<T*>(dk), static_cast<T*>(dv),
      a.sq, a.sk, a.scale, a.causal != 0, a.use_window != 0, a.window);
  return cudaGetLastError();
}


// ---- dQ --------------------------------------------------------------------------

constexpr int kDqRows = 16 * kWarps;  // query rows of a CTA: 16 per warp

// Keys per streamed tile: 64, or 32 at D = 256, where the 16 x 256 f32 dQ
// accumulator takes 128 registers of a thread.
template <int D>
__host__ __device__ constexpr int dq_block_k() { return D > 128 ? 32 : 64; }

// Q and dO tiles, then two stages of (K tile, V tile), rows padded to D + 8.
template <int D>
constexpr size_t dq_smem_bytes() {
  return sizeof(T) * static_cast<size_t>((2 * kDqRows + 4 * dq_block_k<D>()) * (D + 8));
}

// dQ of one 64-query tile.  grid = (B*H, ceil(sq / 64)); under a causal mask
// blockIdx.y runs the query tiles last to first.  Up to D = 80 the kernel is
// held to 170 registers: three CTAs (12 warps) an SM.
template <int D>
__global__ void __launch_bounds__(kThreads, D <= 80 ? 3 : 1)
flash_bwd_dq_tc_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                       const T* __restrict__ dout, const float* __restrict__ lse,
                       const float* __restrict__ dvec, T* __restrict__ dq, int sq, int sk,
                       float scale, bool causal, bool use_window, int window) {
  constexpr int kBlockKeys = dq_block_k<D>();
  constexpr int kStride = D + 8;             // padded row: ldmatrix reads hit 32 banks
  constexpr int kTile = kBlockKeys * kStride;
  constexpr int kSlices = D / 16;            // k-slices of Q K^T, pairs of dQ n-tiles
  constexpr int kKeyTiles = kBlockKeys / 8;  // n-tiles of S
  extern __shared__ __align__(16) unsigned char smem[];
  T* q_s = reinterpret_cast<T*>(smem);
  T* do_s = q_s + kDqRows * kStride;
  T* k_s = do_s + kDqRows * kStride;         // stage s at k_s + 2 s kTile
  T* v_s = k_s + kTile;                      // stage s at v_s + 2 s kTile

  const int64_t bh = blockIdx.x;
  // under a causal mask the last query tiles have the most keys: they start first
  const int tile = causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y;
  const int q0 = tile * kDqRows;
  const T* q_g = q + bh * sq * D;
  const T* k_g = k + bh * sk * D;
  const T* v_g = v + bh * sk * D;
  const T* do_g = dout + bh * sq * D;
  const int off = sk - sq;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;                    // fragment row (and row + 8)
  const int t4 = lane % 4;                   // fragment column pair
  const int wrow = warp * 16;                // this warp's first row in the tile
  const float scale_log2 = scale * kLog2e;

  // Keys that some query of this tile attends: [k_lo, k_hi).
  const int q_last = min(q0 + kDqRows, sq) - 1;
  int k_lo = 0;
  int k_hi = sk;
  if (causal) k_hi = min(k_hi, q_last + off + 1);
  if (use_window) k_lo = max(k_lo, q0 + off - window + 1);
  const int kt_begin = k_lo < k_hi ? (k_lo / kBlockKeys) * kBlockKeys : k_hi;
  const int n_tiles = (k_hi - kt_begin + kBlockKeys - 1) / kBlockKeys;

  if (n_tiles > 0) {
    tc::load_tile_async<D, kDqRows, kThreads>(q_s, q_g, q0, sq);
    tc::load_tile_async<D, kDqRows, kThreads>(do_s, do_g, q0, sq);
    tc::load_tile_async<D, kBlockKeys, kThreads>(k_s, k_g, kt_begin, sk);
    tc::load_tile_async<D, kBlockKeys, kThreads>(v_s, v_g, kt_begin, sk);
    tc::cp_async_commit();
  }

  // lse (in log2 units) and dvec of rows g and g + 8
  float lse2[2], dvec_r[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qpos = q0 + wrow + g + 8 * r;
    const bool in = qpos < sq;
    lse2[r] = in ? lse[bh * sq + qpos] * kLog2e : 0.f;
    dvec_r[r] = in ? dvec[bh * sq + qpos] : 0.f;
  }
  float acc[2 * kSlices][4];                 // dQ rows g, g + 8; 8 columns per n-tile
#pragma unroll
  for (int j = 0; j < 2 * kSlices; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  const bool warp_live = q0 + wrow < sq;     // some row of this warp is a query
  const T* q_frag = q_s + (wrow + lane % 16) * kStride + (lane / 16) * 8;
  const T* do_frag = do_s + (wrow + lane % 16) * kStride + (lane / 16) * 8;

  for (int t = 0; t < n_tiles; ++t) {
    const int kt = kt_begin + t * kBlockKeys;
    const int stage = t & 1;
    if (t + 1 < n_tiles) {  // the next tile's copy flies while this one is computed
      tc::load_tile_async<D, kBlockKeys, kThreads>(k_s + 2 * (stage ^ 1) * kTile, k_g,
                                                   kt + kBlockKeys, sk);
      tc::load_tile_async<D, kBlockKeys, kThreads>(v_s + 2 * (stage ^ 1) * kTile, v_g,
                                                   kt + kBlockKeys, sk);
      tc::cp_async_commit();
      tc::cp_async_wait<1>();
    } else {
      tc::cp_async_wait<0>();
    }
    __syncthreads();
    if (warp_live) {
      const T* ks = k_s + 2 * stage * kTile;
      const T* vs = v_s + 2 * stage * kTile;
      // S = Q K^T and dP = dO V^T: 16 rows x kBlockKeys keys, n-tile j holds
      // keys kt + 8 j ..
      float s[kKeyTiles][4], dp[kKeyTiles][4];
#pragma unroll
      for (int j = 0; j < kKeyTiles; ++j) {
        s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
        dp[j][0] = dp[j][1] = dp[j][2] = dp[j][3] = 0.f;
      }
#pragma unroll
      for (int kk = 0; kk < kSlices; ++kk) {
        uint32_t a[4];
        tc::ldmatrix_x4(a, q_frag + kk * 16);
#pragma unroll
        for (int np = 0; np < kKeyTiles / 2; ++np) {  // keys 16 np .. 16 np + 15
          const int b_off = (np * 16 + lane % 8 + (lane / 16) * 8) * kStride + kk * 16 +
                            ((lane / 8) % 2) * 8;
          uint32_t b[4];
          tc::ldmatrix_x4(b, ks + b_off);
          tc::mma_bf16(s[2 * np], a, b[0], b[1]);
          tc::mma_bf16(s[2 * np + 1], a, b[2], b[3]);
        }
        tc::ldmatrix_x4(a, do_frag + kk * 16);
#pragma unroll
        for (int np = 0; np < kKeyTiles / 2; ++np) {
          const int b_off = (np * 16 + lane % 8 + (lane / 16) * 8) * kStride + kk * 16 +
                            ((lane / 8) % 2) * 8;
          uint32_t b[4];
          tc::ldmatrix_x4(b, vs + b_off);
          tc::mma_bf16(dp[2 * np], a, b[0], b[1]);
          tc::mma_bf16(dp[2 * np + 1], a, b[2], b[3]);
        }
      }
      // P = 2^(S scale log2e - lse log2e), 0 where masked (per element, only
      // on a tile that the mask or a ragged edge cuts, as in the forward);
      // s <- dS = P (dP - dvec) scale
      const bool cut = kt + kBlockKeys > sk || (causal && kt + kBlockKeys - 1 > q0 + off) ||
                       (use_window && kt <= q0 + kDqRows - 1 + off - window);
#pragma unroll
      for (int j = 0; j < kKeyTiles; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          bool live = true;
          if (cut) {
            const int qpos = q0 + wrow + g + 8 * (e / 2);
            const int kpos = kt + 8 * j + 2 * t4 + (e % 2);
            live = kpos < sk;
            if (causal) live = live && kpos <= qpos + off;
            if (use_window) live = live && kpos > qpos + off - window;
          }
          const float p = live ? tc::ex2(fmaf(s[j][e], scale_log2, -lse2[e / 2])) : 0.f;
          s[j][e] = p * (dp[j][e] - dvec_r[e / 2]) * scale;
        }
      }
      // dQ += dS K: dS rounded to bf16 in registers is the A operand; K
      // through ldmatrix.trans
#pragma unroll
      for (int kk = 0; kk < kKeyTiles / 2; ++kk) {  // keys 16 kk .. 16 kk + 15
        uint32_t a[4];
        tc::c_to_a(a, s[2 * kk], s[2 * kk + 1]);
#pragma unroll
        for (int dc = 0; dc < kSlices; ++dc) {  // columns 16 dc .. 16 dc + 15
          uint32_t b[4];
          tc::ldmatrix_x4_trans(b, ks + (kk * 16 + lane % 8 + ((lane / 8) % 2) * 8) * kStride +
                                       dc * 16 + (lane / 16) * 8);
          tc::mma_bf16(acc[2 * dc], a, b[0], b[1]);
          tc::mma_bf16(acc[2 * dc + 1], a, b[2], b[3]);
        }
      }
    }
    __syncthreads();  // this stage is read out before the copy after next overwrites it
  }

  // every row of the tile is written, zeros where no key is live
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qpos = q0 + wrow + g + 8 * r;
    if (qpos >= sq) continue;
    T* dq_row = dq + (bh * sq + qpos) * D + 2 * t4;
#pragma unroll
    for (int j = 0; j < 2 * kSlices; ++j) {
      *reinterpret_cast<__nv_bfloat162*>(dq_row + 8 * j) =
          __floats2bfloat162_rn(acc[j][2 * r], acc[j][2 * r + 1]);
    }
  }
}

template <int D>
cudaError_t launch_dq(const Args& a, void* dq) {
  constexpr size_t smem = dq_smem_bytes<D>();
  static std::atomic<unsigned long long> smem_set{0};
  cudaError_t err = launch::max_dynamic_smem_once(
      smem_set, reinterpret_cast<const void*>(flash_bwd_dq_tc_kernel<D>), static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(a.bh, (a.sq + kDqRows - 1) / kDqRows);
  flash_bwd_dq_tc_kernel<D><<<grid, kThreads, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<const T*>(a.dout), a.lse, a.dvec, static_cast<T*>(dq), a.sq, a.sk, a.scale,
      a.causal != 0, a.use_window != 0, a.window);
  return cudaGetLastError();
}

}  // namespace bf16

// dK, dV and dQ of the variant of the inputs' dtype at the runtime head dim d.
cudaError_t dkv(const Args& a, int d, int is_bf16, void* dk, void* dv) {
  DISPATCH_HEAD_DIM(d, is_bf16 ? bf16::launch_dkv<D>(a, dk, dv) : launch_dkv<D>(a, dk, dv))
}

cudaError_t dq(const Args& a, int d, int is_bf16, void* out) {
  DISPATCH_HEAD_DIM(d, is_bf16 ? bf16::launch_dq<D>(a, out) : launch_dq<D>(a, out))
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
  return dkv(a, d, is_bf16, dk, dv);
}

// As above; writes dq (BH, Sq, D) in the input type.
extern "C" int flash_attention_bwd_dq(const void* q, const void* k, const void* v,
                                      const void* dout, const void* lse, const void* dvec,
                                      void* dq_out, int bh, int sq, int sk, int d, int is_bf16,
                                      float scale, int causal, int use_window, int window,
                                      void* stream) {
  const Args a{q, k, v, dout, static_cast<const float*>(lse), static_cast<const float*>(dvec),
               bh, sq, sk, scale, causal, use_window, window, static_cast<cudaStream_t>(stream)};
  return dq(a, d, is_bf16, dq_out);
}
