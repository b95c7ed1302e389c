// Flash-attention forward for NVIDIA Hopper (sm_90a), hand-written CUDA C++.
//
// Replaces the TPU kernel `_flash_kernel` of
// src/repro/kernels/flash_attention/kernel.py, which `flash_attention_fwd_lse`
// launches there: online-softmax attention that also returns the f32
// logsumexp, with causal, sliding-window or bidirectional masks, GQA (query
// head h reads kv head h / group) and a key bound at the real key length.
// Two variants, chosen by the inputs' dtype (never by failure):
//   bf16 (the served and trained models' type): flash_fwd_tc_kernel, tensor cores;
//   f32 (the card-vs-CPU parity checks): flash_fwd_f32_kernel, CUDA cores.
//
// What bounds it on the H100.  At the serving shape (B=4, H=32, S=512, D=80,
// causal, bf16) the function needs ~5.4 GFLOP on the live (query, key) pairs
// against ~42 MB of Q, K, V, O and lse: 12.6 us at 3.35 TB/s, so the bytes
// bound it; the 5.4 GFLOP take ~5.4 us at the 989 TFLOP/s of the tensor
// cores, and ~9 us at the ~600 TFLOP/s that `mma.sync` reaches.  On the CUDA
// cores (67 TFLOP/s in f32) the same work takes at least 80 us, which is why
// the bf16 variant runs on the tensor cores.
//
// Why `mma.sync` and not `wgmma`.  The main path's head dim is 80: 160-byte
// rows.  `wgmma` could take them: its no-swizzle shared-memory layout is
// built of core matrices of 8 rows x 16 bytes, which 160-byte rows fit, and
// its 32/64/128-byte swizzled layouts would need D padded to 96 or 128 in
// shared memory only (TMA or cp.async still read 160 bytes a row from device
// memory), so padding costs shared-memory space and products on zero
// columns, not device-memory bytes.  This kernel uses `mma.sync` (m16n8k16),
// whose operands `ldmatrix` loads from any 16-byte-aligned rows into
// registers, so that P passes from one product to the next in registers;
// at ~600 TFLOP/s its ~9 us stay under the 12.6 us byte bound, so its rate
// is not what limits the kernel.  `wgmma`'s asynchrony (products that run
// under the softmax) is the open route (PERF.md, open questions).
//
// bf16 design (after FlashAttention-2).  One CTA per (batch * query head,
// 64-query tile), 4 warps of 16 query rows; under a causal mask blockIdx.y
// runs the query tiles last to first, so the heaviest start first and the
// light ones fill the tail.  The CTA loops over the key tiles (64 keys, 32 at
// D = 256) that the mask leaves live: the bounds come from causal, window,
// off = sk - sq and sk, the first tile aligned down to a multiple of the tile,
// in place of the TPU kernel's pl.when tile skipping.  K and V tiles are
// double-buffered in shared memory with 16-byte cp.async copies (the next
// tile's copy flies while this one is computed; rows past sk are zero-filled
// by the copy's source size, nothing is padded in device memory), rows padded
// to D + 8 elements so that ldmatrix reads are free of bank conflicts.  Each
// warp keeps its Q fragment in registers (read from shared memory per tile at
// D = 256, where the output accumulator takes 128 registers), computes
// S = Q K^T with mma.m16n8k16.bf16 into f32, and runs the online softmax on
// the accumulator fragments: row max and row sum over the 4 lanes that share
// a row (two __shfl_xor_sync), exponentials as ex2.approx on the
// special-function unit, the denominator summed in f32 from the unrounded P.
// P rounded to bf16 in registers is the A operand of O += P V (V through
// ldmatrix.trans): it never goes through shared memory.  Masks are applied
// per element, only on the tiles that the mask cuts; masked scores take the
// finite -1e30 and the denominator is clamped at 1e-30, as in the TPU kernel,
// so lse = m + log(l) agrees with it.  Rounding P to bf16 before P V is the
// one numerical difference from the TPU kernel, which multiplies P in f32.
// Shared memory: a Q tile and two stages of K and V tiles, (64 + 4 * 64) x
// (D + 8) bf16 = 56 KB at D = 80 and (64 + 4 * 32) x 264 = 99 KB at D = 256.
// D = 96 is MLA's query/key head (64 nope + 32 rope): 6 k-slices, rows of
// 104 elements (208 bytes: 16-byte aligned, and the 8 rows an ldmatrix
// reads start on 8 distinct 4-bank groups); its value head of 64 arrives
// zero-padded to 96 by the op, whose sliced output drops the zero columns.
// What limits it in practice is latency more than any rate: a warp runs its
// Q K^T products, its softmax and its P V products in order, so other warps
// must fill the gaps; up to D = 80 the kernel is held to 170 registers so that
// three CTAs share an SM.  Inputs must be 16-byte aligned (the wrapper
// checks).
//
// f32 design (the first kernel of the port, unchanged).  One CTA per
// (batch * query head, 64-query tile), 8 warps of 8 query rows each, over the
// same live key tiles.  K and V tiles are staged in shared memory as f32 (K
// rows padded to D + 1 floats so a warp reading one column hits 32 banks).
// Lane j scores keys j and j + 32 of the tile for its warp's 8 rows; the
// running max, sum and output accumulator stay in registers, and the
// probabilities reach the P.V product by warp shuffles.  Masking, the
// -1e30 fill and the 1e-30 clamp are those above.  The ragged edges of Sq and
// Sk are masked; nothing is padded.  Shared memory is (64 D + 64 (D + 1) +
// 64 D) floats: 60 KB at D = 80 and 192 KB at D = 256, set per launch as
// dynamic shared memory.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tensor_core.cuh"

namespace {

namespace f32 {

// ---- f32 variant: f32 arithmetic on the CUDA cores ------------------------------

constexpr int kBlockQ = 64;
constexpr int kBlockK = 64;
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kRows = kBlockQ / kWarps;  // query rows per warp
constexpr float kNegInf = -1e30f;
constexpr unsigned kFull = 0xffffffffu;

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) * static_cast<size_t>(kBlockQ * D + kBlockK * (D + 1) + kBlockK * D);
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ o,
                     float* __restrict__ lse, int hq, int group, int sq, int sk, float scale,
                     bool causal, bool use_window, int window) {
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
  const float* q_g = q + static_cast<int64_t>(bh) * sq * D;
  const float* k_g = k + kv_bh * sk * D;
  const float* v_g = v + kv_bh * sk * D;
  const int off = sk - sq;
  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int row0 = (tid / 32) * kRows;   // this warp's first row in the tile

  for (int i = tid; i < kBlockQ * D; i += kThreads) {
    q_s[i] = q0 + i / D < sq ? q_g[static_cast<int64_t>(q0) * D + i] : 0.f;
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
      k_s[r * kStride + (i - r * D)] = in ? k_g[base + i] : 0.f;
      v_s[i] = in ? v_g[base + i] : 0.f;
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
    float* o_row = o + (static_cast<int64_t>(bh) * sq + qpos) * D;
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      const int d = lane + 32 * c;
      if (d < D) o_row[d] = acc[i][c] / denom;
    }
    if (lane == 0) lse[static_cast<int64_t>(bh) * sq + qpos] = m[i] + logf(denom);
  }
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, void* lse, int b,
                   int hq, int hkv, int sq, int sk, float scale, int causal, int use_window,
                   int window, cudaStream_t stream) {
  const size_t smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_f32_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((sq + kBlockQ - 1) / kBlockQ, b * hq);
  flash_fwd_f32_kernel<D><<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(o), static_cast<float*>(lse), hq, hq / hkv, sq, sk, scale, causal != 0,
      use_window != 0, window);
  return cudaGetLastError();
}

}  // namespace f32

// ---- bf16 variant: tensor cores --------------------------------------------------

namespace bf16 {

using T = __nv_bfloat16;
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kBlockQ = 16 * kWarps;  // 16 query rows per warp
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr unsigned kFull = 0xffffffffu;

// Keys per tile: 64, or 32 at D = 256, where the 16 x 256 f32 output
// accumulator takes 128 registers of a thread and a narrower score tile keeps
// the kernel under 255 without spills (and halves the K/V shared memory).
template <int D>
__host__ __device__ constexpr int block_k() { return D > 128 ? 32 : 64; }

// Q tile, then two stages of (K tile, V tile), rows padded to D + 8 elements.
template <int D>
constexpr size_t smem_bytes() {
  return sizeof(T) * static_cast<size_t>((kBlockQ + 4 * block_k<D>()) * (D + 8));
}

// Up to D = 80 the kernel is held to 170 registers: three CTAs (12 warps) an SM.
template <int D>
__global__ void __launch_bounds__(kThreads, D <= 80 ? 3 : 1)
flash_fwd_tc_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                    T* __restrict__ o, float* __restrict__ lse, int hq, int group, int sq,
                    int sk, float scale, bool causal, bool use_window, int window) {
  constexpr int kBlockK = block_k<D>();
  constexpr int kStride = D + 8;          // padded row: ldmatrix reads hit 32 banks
  constexpr int kTile = kBlockK * kStride;
  constexpr int kSlices = D / 16;         // k-slices of Q.K^T, pairs of output n-tiles
  constexpr int kKeyTiles = kBlockK / 8;  // n-tiles of S
  constexpr bool kQInRegs = D <= 128;     // at D = 256 Q is read from shared memory
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* q_s = reinterpret_cast<T*>(smem_raw);
  T* k_s = q_s + kBlockQ * kStride;       // stage s at k_s + 2 s kTile
  T* v_s = k_s + kTile;                   // stage s at v_s + 2 s kTile

  const int bh = blockIdx.x;
  // under a causal mask the last query tiles have the most keys: they start first
  const int tile = causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y;
  const int q0 = tile * kBlockQ;
  const int hkv = hq / group;
  const int64_t kv_bh = static_cast<int64_t>(bh / hq) * hkv + (bh % hq) / group;
  const T* q_g = q + static_cast<int64_t>(bh) * sq * D;
  const T* k_g = k + kv_bh * sk * D;
  const T* v_g = v + kv_bh * sk * D;
  const int off = sk - sq;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;                 // fragment row (and row + 8)
  const int t4 = lane % 4;                // fragment column pair
  const int wrow = warp * 16;             // this warp's first row in the tile

  // Keys that some query of this tile may attend: [k_lo, k_hi).
  const int q_last = min(q0 + kBlockQ, sq) - 1;
  int k_lo = 0;
  int k_hi = sk;
  if (causal) k_hi = min(k_hi, q_last + off + 1);
  if (use_window) k_lo = max(k_lo, q0 + off - window + 1);
  const int kt_begin = k_lo < k_hi ? (k_lo / kBlockK) * kBlockK : k_hi;
  const int n_tiles = (k_hi - kt_begin + kBlockK - 1) / kBlockK;

  if (n_tiles > 0) {
    tc::load_tile_async<D, kBlockQ, kThreads>(q_s, q_g, q0, sq);
    tc::load_tile_async<D, kBlockK, kThreads>(k_s, k_g, kt_begin, sk);
    tc::load_tile_async<D, kBlockK, kThreads>(v_s, v_g, kt_begin, sk);
    tc::cp_async_commit();
  }

  uint32_t qf[kQInRegs ? kSlices : 1][4];
  float acc[2 * kSlices][4];              // output rows g, g + 8; 8 columns per n-tile
  float m[2] = {kNegInf, kNegInf};        // running max of rows g, g + 8
  float l[2] = {0.f, 0.f};                // this lane's part of the running sums
#pragma unroll
  for (int j = 0; j < 2 * kSlices; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  const bool warp_live = q0 + wrow < sq;  // some row of this warp is a query

  for (int t = 0; t < n_tiles; ++t) {
    const int kt = kt_begin + t * kBlockK;
    const int stage = t & 1;
    if (t + 1 < n_tiles) {  // the next tile's copy flies while this one is computed
      tc::load_tile_async<D, kBlockK, kThreads>(k_s + 2 * (stage ^ 1) * kTile, k_g, kt + kBlockK,
                                                sk);
      tc::load_tile_async<D, kBlockK, kThreads>(v_s + 2 * (stage ^ 1) * kTile, v_g, kt + kBlockK,
                                                sk);
      tc::cp_async_commit();
      tc::cp_async_wait<1>();
    } else {
      tc::cp_async_wait<0>();
    }
    __syncthreads();
    if (warp_live) {
      const T* ks = k_s + 2 * stage * kTile;
      const T* vs = v_s + 2 * stage * kTile;
      const T* q_frag = q_s + (wrow + lane % 16) * kStride + (lane / 16) * 8;
      if constexpr (kQInRegs) {
        if (t == 0) {  // the warp's Q fragments, loaded once
#pragma unroll
          for (int kk = 0; kk < kSlices; ++kk) tc::ldmatrix_x4(qf[kk], q_frag + kk * 16);
        }
      }
      // S = Q K^T: 16 rows x kBlockK keys, n-tile j holds keys kt + 8 j ..
      float s[kKeyTiles][4];
#pragma unroll
      for (int j = 0; j < kKeyTiles; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < kSlices; ++kk) {
        uint32_t a[4];
        if constexpr (kQInRegs) {
#pragma unroll
          for (int i = 0; i < 4; ++i) a[i] = qf[kk][i];
        } else {
          tc::ldmatrix_x4(a, q_frag + kk * 16);
        }
#pragma unroll
        for (int np = 0; np < kKeyTiles / 2; ++np) {  // keys 16 np .. 16 np + 15
          uint32_t b[4];
          tc::ldmatrix_x4(b, ks + (np * 16 + lane % 8 + (lane / 16) * 8) * kStride + kk * 16 +
                                 ((lane / 8) % 2) * 8);
          tc::mma_bf16(s[2 * np], a, b[0], b[1]);
          tc::mma_bf16(s[2 * np + 1], a, b[2], b[3]);
        }
      }
      // scale and mask (per element, only on a tile that the mask cuts), as the
      // f32 variant: masked scores take the finite -1e30
      const bool cut = kt + kBlockK > sk || (causal && kt + kBlockK - 1 > q0 + off) ||
                       (use_window && kt <= q0 + kBlockQ - 1 + off - window);
      float mx[2] = {m[0], m[1]};
#pragma unroll
      for (int j = 0; j < kKeyTiles; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = s[j][e] * scale;
          if (cut) {
            const int qpos = q0 + wrow + g + 8 * (e / 2);
            const int kpos = kt + 8 * j + 2 * t4 + (e % 2);
            bool live = kpos < sk;
            if (causal) live = live && kpos <= qpos + off;
            if (use_window) live = live && kpos > qpos + off - window;
            if (!live) x = kNegInf;
          }
          s[j][e] = x;
          mx[e / 2] = fmaxf(mx[e / 2], x);
        }
      }
      // online softmax: the 4 lanes of a row group share rows g and g + 8
      float alpha[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(kFull, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(kFull, mx[r], 2));
        alpha[r] = tc::ex2((m[r] - mx[r]) * kLog2e);
        m[r] = mx[r];
        l[r] *= alpha[r];
      }
#pragma unroll
      for (int j = 0; j < 2 * kSlices; ++j) {
        acc[j][0] *= alpha[0];
        acc[j][1] *= alpha[0];
        acc[j][2] *= alpha[1];
        acc[j][3] *= alpha[1];
      }
#pragma unroll
      for (int j = 0; j < kKeyTiles; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = tc::ex2((s[j][e] - m[e / 2]) * kLog2e);
          s[j][e] = p;
          l[e / 2] += p;  // the denominator sums P before it is rounded
        }
      }
      // O += P V: P rounded to bf16 in registers is the A operand; V through
      // ldmatrix.trans
#pragma unroll
      for (int kk = 0; kk < kKeyTiles / 2; ++kk) {  // keys 16 kk .. 16 kk + 15
        uint32_t a[4];
        tc::c_to_a(a, s[2 * kk], s[2 * kk + 1]);
#pragma unroll
        for (int dp = 0; dp < kSlices; ++dp) {  // columns 16 dp .. 16 dp + 15
          uint32_t b[4];
          tc::ldmatrix_x4_trans(b, vs + (kk * 16 + lane % 8 + ((lane / 8) % 2) * 8) * kStride +
                                       dp * 16 + (lane / 16) * 8);
          tc::mma_bf16(acc[2 * dp], a, b[0], b[1]);
          tc::mma_bf16(acc[2 * dp + 1], a, b[2], b[3]);
        }
      }
    }
    __syncthreads();  // this stage is read out before the copy after next overwrites it
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(kFull, l[r], 1);
    l[r] += __shfl_xor_sync(kFull, l[r], 2);
    const int qpos = q0 + wrow + g + 8 * r;
    if (qpos >= sq) continue;
    const float denom = fmaxf(l[r], 1e-30f);
    T* o_row = o + (static_cast<int64_t>(bh) * sq + qpos) * D + 2 * t4;
#pragma unroll
    for (int j = 0; j < 2 * kSlices; ++j) {
      *reinterpret_cast<__nv_bfloat162*>(o_row + 8 * j) =
          __floats2bfloat162_rn(acc[j][2 * r] / denom, acc[j][2 * r + 1] / denom);
    }
    if (t4 == 0) lse[static_cast<int64_t>(bh) * sq + qpos] = m[r] + logf(denom);
  }
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, void* lse, int b,
                   int hq, int hkv, int sq, int sk, float scale, int causal, int use_window,
                   int window, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_tc_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(b * hq, (sq + kBlockQ - 1) / kBlockQ);
  flash_fwd_tc_kernel<D><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), static_cast<float*>(lse), hq, hq / hkv, sq, sk, scale, causal != 0,
      use_window != 0, window);
  return cudaGetLastError();
}

}  // namespace bf16

// Launches the variant of the inputs' dtype at the runtime head dim d.
cudaError_t dispatch(const void* q, const void* k, const void* v, void* o, void* lse, int b,
                     int hq, int hkv, int sq, int sk, int d, int is_bf16, float scale, int causal,
                     int use_window, int window, cudaStream_t stream) {
#define FLASH_CASE(DIM)                                                                        \
  case DIM:                                                                                    \
    return is_bf16 ? bf16::launch<DIM>(q, k, v, o, lse, b, hq, hkv, sq, sk, scale, causal,      \
                                       use_window, window, stream)                             \
                   : f32::launch<DIM>(q, k, v, o, lse, b, hq, hkv, sq, sk, scale, causal,       \
                                      use_window, window, stream);
  switch (d) {
    FLASH_CASE(16)
    FLASH_CASE(32)
    FLASH_CASE(64)
    FLASH_CASE(80)
    FLASH_CASE(96)
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
  return dispatch(q, k, v, o, lse, b, hq, hkv, sq, sk, d, is_bf16, scale, causal, use_window,
                  window, static_cast<cudaStream_t>(stream));
}
