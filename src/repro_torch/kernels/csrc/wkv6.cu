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
// (B*H = 160, T = 512, dk = dv = 64, bf16) ~58 MB, 17 us at 3.35 TB/s.  The
// arithmetic is ~2.2 GFLOP plus the exps of A, which are latency on the CUDA
// cores unless the work is spread over the whole card.  The first design
// (one CTA of 256 threads per head walking T) left 160 CTAs on 132 SMs with
// a 64-long dot product and an exp per term for each entry of A (133 k exps
// a chunk) and eight barrier-separated phases a chunk: 42x its bound.
// Three kernels now, chosen by T and the inputs' dtype (never by failure):
//
// bf16, T > 1: two passes (the chunk form of flash-linear-attention's
// GLA / RWKV-6 kernels).
//   State pass, grid (B*H) = 160 CTAs of 8 warps at the serving shape.  Each
//   CTA walks the chunks of its head in order carrying S (64 x 64) in f32, in
//   the C fragments of its mma tiles, the next chunk's log_w, k and v copied
//   in with cp.async while this one is computed: per chunk it writes the
//   state entering the chunk, S_in, to a workspace (B*H, n_chunks, 64, 64)
//   f32 (21 MB at the serving shape), then takes c (four threads a channel,
//   in order), k~_j = k_j e^{c_last - c_j} and S <- e^{c_last} * S + k~^T V;
//   at the end it writes s_last.  The product k~^T V (335 M multiply-adds at
//   the serving shape) runs on TF32 mma.sync with k~ split into its TF32
//   value and the TF32 value of the rest: 3xTF32 whose third product
//   vanishes, since v is bf16 and exact in TF32.  That keeps ~21 bits of k~;
//   on the CUDA cores the same product was bound by shared-memory loads
//   (three for eight FMAs).  A chunk's serial chain (copy, scan, exps,
//   product) sets this pass's time, so one CTA a head reads k and log_w once.
//   Output pass, grid (B*H, n_chunks) = 1280 CTAs of 4 warps, warp w owning
//   the 16 steps of sub-block w.  Each CTA copies its chunk of r, k, v and
//   log_w (bf16) and its S_in into shared memory with cp.async, takes c as
//   the state pass does, and computes y = A V + (r * e^{c_{t-1}}) S_in.
//   Left of a warp's diagonal
//   sub-block A is built from factored operands measured against the step
//   before the sub-block, s - 1:
//     r~_t = r_t e^{c_{t-1} - c_{s-1}} (t >= s),  k~_j = k_j e^{c_{s-1} - c_j} (j < s),
//   both exponents <= 0, so that A[t, j] = r~_t . k~_j for j < s, a product;
//   in the diagonal 16 x 16 sub-block the lower-left 8 x 8 quarter is the
//   same product against step s + 7, and only the strict lower triangles of
//   the two diagonal 8 x 8 quarters keep per-element exps (with the bonus on
//   the diagonal): 14 k exps a chunk against the first design's 129 k, 40 k
//   a chunk in all (both passes) against 137 k.  r~ k~^T, A V and
//   (r e^{c}) S_in run on TF32 mma.sync.m16n8k8 with f32 sums; operands are
//   read from shared memory with 32-bit loads, rows padded so that the
//   fragment reads are free of bank conflicts.
//   Why the state keeps f32 precision and the output products are TF32 (a
//   CPU emulation of the rounding on chip_smoke's inputs, against an f64 step
//   loop and chip_smoke's bounds, 1 x 4 heads x 512 x 64 x 64): k e^{c_last -
//   c_j} rounded to bf16 in the state update is 9.5x over the state bound
//   (5e-4 + 5e-4|want|), rounded to TF32 1.1-1.5x over, split in two TF32
//   parts 0.0004-0.0007 of it (f32: 0.0003); the output products with bf16
//   operands are 1.96x over the y bound (5e-2 + 5e-2|want|), with TF32
//   operands 0.21 of it (0.09 at log_w = -20).  bf16 inputs are exact in
//   TF32, so only the derived operands (r~, k~, A, S_in) are rounded; the
//   state pass writes S_in already rounded.
//   Shared memory: state pass two stages of bf16 chunks and c (then k~) in
//   f32, 68 KB; output pass four 64 x 72 bf16 tiles, c as 65 x 68 f32 and
//   S_in (then A, in the same place) as 64 x 72 f32, 71 KB, three CTAs an
//   SM.
//   Ragged T, T < 64, dk or dv not a multiple of 8 and s0 = null are loop
//   bounds and zeros.
// f32, T > 1 (the card-vs-CPU parity checks): the first design, unchanged.
// T = 1 (decode), both dtypes: one CTA of 256 threads per (batch, head), in
//   f32 as the plain version: thread (e, quarter) reads 16 entries S[d, e]
//   (coalesced along e), adds r[d] (S[d, e] + u[d] k[d] v[e]) to its part of
//   y[e] and writes S'[d, e] = e^{log_w[d]} S[d, e] + k[d] v[e]; the four
//   parts of y[e] are summed in shared memory in a fixed order.  It moves the
//   state in and out once: 2 x 16 KB a head.
// Every sum runs in a fixed order: two runs give the same bits.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

#include "launch.cuh"
#include "tensor_core.cuh"
#include "wkv6_chunk.cuh"

namespace {

using bf16 = __nv_bfloat16;

using wkv6_chunk::kChunk;
using wkv6_chunk::kMaxDim;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(bf16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) { return x; }
template <> __device__ __forceinline__ bf16 from_float<bf16>(float x) {
  return __float2bfloat16(x);
}

// Row t of the lower triangle entry p = t (t + 1) / 2 + j, 0 <= j <= t.
__device__ __forceinline__ int tri_row(int p) {
  int t = static_cast<int>((sqrtf(8.f * p + 1.f) - 1.f) * 0.5f);
  while ((t + 1) * (t + 2) / 2 <= p) ++t;
  while (t * (t + 1) / 2 > p) --t;
  return t;
}

// Inclusive prefix sum over the lanes of a warp.
__device__ __forceinline__ float warp_inclusive_sum(float x, int lane) {
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float y = __shfl_up_sync(kFull, x, o);
    if (lane >= o) x += y;
  }
  return x;
}

// ---- f32, T > 1: one CTA per (batch, head) (the first design) ---------------------
//
// One CTA walks T in chunks; the TPU kernel's VMEM carry along its
// "arbitrary" time axis becomes that loop, with S in shared memory.  The TPU
// kernel materialises the (L, L, dk) decay tensor (1 MB at L = dk = 64), which
// does not fit in shared memory: here each A[t, j] is one thread's dot product
// over d, with the decay computed on the fly.  Threads take A's entries from
// the lower triangle only (p -> (t, j)), so all do the same work.  The ragged
// last chunk is a bound on t, not padding.  Tiles are kept in f32, rows of r,
// k and c padded to 65 floats so that a warp reading one column of 32 rows
// hits 32 banks.
namespace f32 {

constexpr int kThreads = 256;
constexpr int kPad = kMaxDim + 1;    // row stride of the r, k, c tiles (floats)
constexpr int kAStride = kChunk + 1;  // row stride of A (floats)
constexpr size_t kSmemFloats =
    kMaxDim * kMaxDim + 3 * kChunk * kPad + kChunk * kMaxDim + kChunk * kAStride;
constexpr size_t kSmemBytes = kSmemFloats * sizeof(float);  // 99,328 bytes

__global__ void __launch_bounds__(kThreads)
wkv6_f32_kernel(const float* __restrict__ r, const float* __restrict__ k,
                const float* __restrict__ v, const float* __restrict__ log_w,
                const float* __restrict__ u, const float* __restrict__ s0,
                float* __restrict__ y, float* __restrict__ s_last, int heads, int steps, int dk,
                int dv) {
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
      rs[at] = r[kc + i];
      ks[at] = k[kc + i];
      cs[at] = log_w[kc + i];
    }
    const int64_t vc = v_off + static_cast<int64_t>(t0) * dv;
    for (int i = tid; i < len * dv; i += kThreads) vs[(i / dv) * kMaxDim + i % dv] = v[vc + i];
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
      y[vc + i] = acc;
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

cudaError_t launch(const void* r, const void* k, const void* v, const void* log_w, const void* u,
                   const void* s0, void* y, void* s_last, int batch_heads, int heads, int steps,
                   int dk, int dv, cudaStream_t stream) {
  static std::atomic<unsigned long long> smem_set{0};
  const cudaError_t err = launch::max_dynamic_smem_once(
      smem_set, reinterpret_cast<const void*>(wkv6_f32_kernel), static_cast<int>(kSmemBytes));
  if (err != cudaSuccess) return err;
  wkv6_f32_kernel<<<batch_heads, kThreads, kSmemBytes, stream>>>(
      static_cast<const float*>(r), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const float*>(log_w), static_cast<const float*>(u),
      static_cast<const float*>(s0), static_cast<float*>(y), static_cast<float*>(s_last), heads,
      steps, dk, dv);
  return cudaGetLastError();
}

}  // namespace f32

// ---- bf16, T > 1: state pass and output pass --------------------------------------

namespace chunked {

constexpr int kWarps = 4;                  // output pass: warp w owns rows [16 w, 16 w + 16)
constexpr int kThreads = 32 * kWarps;
constexpr int kStateWarps = 8;             // state pass: rows 16 (w % 4) .., columns 32 (w / 4) ..
constexpr int kStateThreads = 32 * kStateWarps;
constexpr int kSub = 16;                   // steps per sub-block of the output pass
// Row strides, chosen so that a warp's mma fragment reads hit 32 banks: A
// operands read (row g, column t) and want a stride of 4 mod 32 words, B
// operands read (row t, column g) and want 8 mod 32.
constexpr int kBStride = kMaxDim + 8;      // output pass: bf16 tiles r, k, v, log_w
constexpr int kCStride = kMaxDim + 4;      // f32 c and A; the state pass's c, then k~
constexpr int kSStride = kMaxDim + 8;      // output pass: f32 S_in
constexpr int kVStride = kMaxDim + 8;      // state pass: bf16 v
using wkv6_chunk::bf16_bits;
using wkv6_chunk::chunk_cumsum;
using wkv6_chunk::kLog2e;
using wkv6_chunk::load_chunk;
using wkv6_chunk::tf32_value;
// State pass: two stages of (log_w, k, v) chunks in bf16, then c (then k~)
// in f32 and c_last.
constexpr int kStageElems = 2 * kChunk * kMaxDim + kChunk * kVStride;
constexpr size_t kStateSmemBytes =
    2 * sizeof(bf16) * kStageElems + sizeof(float) * (kChunk * kCStride + kMaxDim);  // 68,864
// Output pass: r, k, v, log_w chunks (bf16), c (65 rows), S_in then A.
constexpr size_t kOutSmemBytes = 4 * sizeof(bf16) * kChunk * kBStride +
                                 sizeof(float) * (kChunk + 1) * kCStride +
                                 sizeof(float) * kMaxDim * kSStride;  // 72,976 bytes

// State pass.  grid = (B*H), 8 warps.  Carries S (64 x 64) in f32 through
// the chunks, in the C fragments of the mma tiles: warp w holds rows
// [16 (w % 4), + 16) and columns [32 (w / 4), + 32).  The next chunk's log_w,
// k and v are copied in while this one is computed.  Per chunk it writes the
// state entering it, rounded to TF32, to s_in (B*H, n_chunks, 64, 64); at the
// end s_last.  c is kept in log2 units.  S <- e^{c_last} S + k~^T V runs on
// TF32 mma.sync with k~ split into its TF32 value and the TF32 value of the
// rest (3xTF32 with a vanishing third product: v is bf16, exact in TF32),
// which keeps ~21 bits of k~.
__global__ void __launch_bounds__(kStateThreads)
wkv6_state_kernel(const bf16* __restrict__ k, const bf16* __restrict__ v,
                  const bf16* __restrict__ log_w, const float* __restrict__ s0,
                  float* __restrict__ s_in, float* __restrict__ s_last, int steps, int dk,
                  int dv, bool vec) {
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* staging = reinterpret_cast<bf16*>(smem);      // stage s at staging + s kStageElems
  float* ks = reinterpret_cast<float*>(staging + 2 * kStageElems);  // [t][d]: c, then k~
  float* clast = ks + kChunk * kCStride;              // c of the chunk's last step
  __shared__ float totals[(kStateThreads / kMaxDim) * kMaxDim];

  const int bh = blockIdx.x;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int t4 = lane % 4;
  const int drow = (warp % 4) * 16 + g;               // this lane's rows of S: drow, drow + 8
  const int e_base = (warp / 4) * 32;                 // and its warp's columns
  const int n_chunks = (steps + kChunk - 1) / kChunk;
  const int64_t s_off = static_cast<int64_t>(bh) * dk * dv;
  const bf16* k_g = k + static_cast<int64_t>(bh) * steps * dk;
  const bf16* lw_g = log_w + static_cast<int64_t>(bh) * steps * dk;
  const bf16* v_g = v + static_cast<int64_t>(bh) * steps * dv;

  // S[n][2 h + i]: row drow + 8 h, column e_base + 8 n + 2 t4 + i
  float S[4][4];
#pragma unroll
  for (int n = 0; n < 4; ++n) {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int d = drow + 8 * (q / 2), e = e_base + 8 * n + 2 * t4 + q % 2;
      S[n][q] = s0 != nullptr && d < dk && e < dv ? s0[s_off + static_cast<int64_t>(d) * dv + e]
                                                  : 0.f;
    }
  }

  auto load = [&](int c) {  // chunk c's log_w, k and v into stage c % 2
    bf16* lb = staging + (c & 1) * kStageElems;
    const int64_t t0 = static_cast<int64_t>(c) * kChunk;
    const int len = min(kChunk, steps - c * kChunk);
    load_chunk<kStateThreads>(lb, kMaxDim, lw_g + t0 * dk, len, dk, 0, kMaxDim, vec);
    load_chunk<kStateThreads>(lb + kChunk * kMaxDim, kMaxDim, k_g + t0 * dk, len, dk, 0, kMaxDim,
                              vec);
    load_chunk<kStateThreads>(lb + 2 * kChunk * kMaxDim, kVStride, v_g + t0 * dv, len, dv, 0,
                              kMaxDim, vec);
    tc::cp_async_commit();
  };
  load(0);

  for (int c = 0; c < n_chunks; ++c) {
    const int len = min(kChunk, steps - c * kChunk);
    // the state entering this chunk, for the output pass (rows past dk are 0)
    float* out = s_in + (static_cast<int64_t>(bh) * n_chunks + c) * kMaxDim * kMaxDim;
#pragma unroll
    for (int n = 0; n < 4; ++n) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        *reinterpret_cast<float2*>(out + (drow + 8 * h) * kMaxDim + e_base + 8 * n + 2 * t4) =
            make_float2(tf32_value(S[n][2 * h]), tf32_value(S[n][2 * h + 1]));
      }
    }
    tc::cp_async_wait<0>();
    __syncthreads();  // chunk c has landed; the previous chunk is done with ks and its stage
    if (c + 1 < n_chunks) load(c + 1);  // the next chunk's copy flies while this one is computed
    const bf16* lb = staging + (c & 1) * kStageElems;
    const bf16* kb = lb + kChunk * kMaxDim;
    const bf16* vb = kb + kChunk * kMaxDim;
    chunk_cumsum<kStateThreads / kMaxDim>(lb, kMaxDim, ks, kCStride, kLog2e, totals);
    if (threadIdx.x < kMaxDim) clast[threadIdx.x] = ks[(len - 1) * kCStride + threadIdx.x];
    __syncthreads();
    // k_j <- k_j e^{c_last - c_j}: the decay from step j to the chunk's end (0 past len)
    for (int i = threadIdx.x; i < kChunk * kMaxDim; i += kStateThreads) {
      const int t = i / kMaxDim, d = i % kMaxDim;
      float* at = ks + t * kCStride + d;
      *at = t < len ? __bfloat162float(kb[i]) * tc::ex2(clast[d] - *at) : 0.f;
    }
    __syncthreads();
    // S <- e^{c_last} S + k~^T V: A = k~^T (rows d, k-columns j), B = v
    const float decay0 = tc::ex2(clast[drow]), decay1 = tc::ex2(clast[drow + 8]);
#pragma unroll
    for (int n = 0; n < 4; ++n) {
      S[n][0] *= decay0;
      S[n][1] *= decay0;
      S[n][2] *= decay1;
      S[n][3] *= decay1;
    }
#pragma unroll 2
    for (int kk = 0; kk < kChunk / 8; ++kk) {
      const int j = kk * 8 + t4;
      const float x[4] = {ks[j * kCStride + drow], ks[j * kCStride + drow + 8],
                          ks[(j + 4) * kCStride + drow], ks[(j + 4) * kCStride + drow + 8]};
      uint32_t big[4], small[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        big[q] = tc::to_tf32(x[q]);
        small[q] = tc::to_tf32(x[q] - __uint_as_float(big[q]));
      }
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        const uint32_t b0 = bf16_bits(vb[j * kVStride + e_base + 8 * n + g]);
        const uint32_t b1 = bf16_bits(vb[(j + 4) * kVStride + e_base + 8 * n + g]);
        tc::mma_tf32(S[n], big, b0, b1);
        tc::mma_tf32(S[n], small, b0, b1);
      }
    }
  }
#pragma unroll
  for (int n = 0; n < 4; ++n) {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int d = drow + 8 * (q / 2), e = e_base + 8 * n + 2 * t4 + q % 2;
      if (d < dk && e < dv) s_last[s_off + static_cast<int64_t>(d) * dv + e] = S[n][q];
    }
  }
}

// The two f32 values in a word of two bf16 (the low half first).
__device__ __forceinline__ float lo_bf16(uint32_t w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float hi_bf16(uint32_t w) { return __uint_as_float(w & 0xffff0000u); }

// sum_d r[d] k[d] 2^(ct[d] - cj[d]) over d < dk (rows of the output pass's
// tiles; columns past dk are zero in r and k and flat in c), 8 at a time.
__device__ __forceinline__ float decayed_dot(const bf16* r, const bf16* k, const float* ct,
                                             const float* cj, int dk) {
  float acc = 0.f;
  for (int d = 0; d < dk; d += 8) {
    const uint4 rv = *reinterpret_cast<const uint4*>(r + d);
    const uint4 kv = *reinterpret_cast<const uint4*>(k + d);
    const float4 ct0 = *reinterpret_cast<const float4*>(ct + d);
    const float4 ct1 = *reinterpret_cast<const float4*>(ct + d + 4);
    const float4 cj0 = *reinterpret_cast<const float4*>(cj + d);
    const float4 cj1 = *reinterpret_cast<const float4*>(cj + d + 4);
    acc += lo_bf16(rv.x) * lo_bf16(kv.x) * tc::ex2(ct0.x - cj0.x);
    acc += hi_bf16(rv.x) * hi_bf16(kv.x) * tc::ex2(ct0.y - cj0.y);
    acc += lo_bf16(rv.y) * lo_bf16(kv.y) * tc::ex2(ct0.z - cj0.z);
    acc += hi_bf16(rv.y) * hi_bf16(kv.y) * tc::ex2(ct0.w - cj0.w);
    acc += lo_bf16(rv.z) * lo_bf16(kv.z) * tc::ex2(ct1.x - cj1.x);
    acc += hi_bf16(rv.z) * hi_bf16(kv.z) * tc::ex2(ct1.y - cj1.y);
    acc += lo_bf16(rv.w) * lo_bf16(kv.w) * tc::ex2(ct1.z - cj1.z);
    acc += hi_bf16(rv.w) * hi_bf16(kv.w) * tc::ex2(ct1.w - cj1.w);
  }
  return acc;
}

// Output pass.  grid = (B*H, n_chunks), 4 warps; warp w owns steps
// [16 w, 16 w + 16) of the chunk.
__global__ void __launch_bounds__(kThreads, 3)
wkv6_output_kernel(const bf16* __restrict__ r, const bf16* __restrict__ k,
                   const bf16* __restrict__ v, const bf16* __restrict__ log_w,
                   const float* __restrict__ u, const float* __restrict__ s_in,
                   bf16* __restrict__ y, int heads, int steps, int dk, int dv, bool vec) {
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* rs = reinterpret_cast<bf16*>(smem);               // [t][d]
  bf16* ks = rs + kChunk * kBStride;                      // [t][d]
  bf16* vs = ks + kChunk * kBStride;                      // [t][e]
  bf16* ls = vs + kChunk * kBStride;                      // [t][d], log_w
  float* cs = reinterpret_cast<float*>(ls + kChunk * kBStride);  // row i: c_{i-1} log2e
  float* sa = cs + (kChunk + 1) * kCStride;  // S_in [d][e] (kSStride), then A [t][j] (kCStride)
  __shared__ __align__(16) float us[kMaxDim];
  __shared__ float totals[(kThreads / kMaxDim) * kMaxDim];

  const int bh = blockIdx.x;
  const int chunk = blockIdx.y;
  const int t0 = chunk * kChunk;
  const int len = min(kChunk, steps - t0);
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane / 4;                                 // fragment row (and row + 8)
  const int t4 = lane % 4;                                // fragment column (and + 4)
  const int64_t row0 = static_cast<int64_t>(bh) * steps + t0;  // the chunk's first step

  load_chunk<kThreads>(rs, kBStride, r + row0 * dk, len, dk, 0, kMaxDim, vec);
  load_chunk<kThreads>(ks, kBStride, k + row0 * dk, len, dk, 0, kMaxDim, vec);
  load_chunk<kThreads>(ls, kBStride, log_w + row0 * dk, len, dk, 0, kMaxDim, vec);
  load_chunk<kThreads>(vs, kBStride, v + row0 * dv, len, dv, 0, kMaxDim, vec);
  const float* sg = s_in + (static_cast<int64_t>(bh) * gridDim.y + chunk) * kMaxDim * kMaxDim;
  for (int i = tid; i < kMaxDim * kMaxDim / 4; i += kThreads) {
    const int row = i / (kMaxDim / 4), c4 = (i % (kMaxDim / 4)) * 4;
    tc::cp_async16(sa + row * kSStride + c4, sg + row * kMaxDim + c4, 16);
  }
  tc::cp_async_commit();
  if (tid < kMaxDim) us[tid] = tid < dk ? u[(bh % heads) * dk + tid] : 0.f;
  tc::cp_async_wait<0>();
  __syncthreads();

  // c in log2 units: row i of cs holds c_{i-1} log2e, row 0 is 0
  if (tid < kMaxDim) cs[tid] = 0.f;
  chunk_cumsum<kThreads / kMaxDim>(ls, kBStride, cs + kCStride, kCStride, kLog2e, totals);

  auto r_at = [&](int t, int d) { return __bfloat162float(rs[t * kBStride + d]); };
  auto k_at = [&](int t, int d) { return __bfloat162float(ks[t * kBStride + d]); };
  const int s = warp * kSub;                              // the sub-block's first step
  const int trow = s + g;                                 // this lane's rows: trow, trow + 8

  // y = (r_t e^{c_{t-1}}) S_in: 16 rows x 64 columns a warp, TF32 products
  float yacc[kMaxDim / 8][4];
#pragma unroll
  for (int n = 0; n < kMaxDim / 8; ++n) yacc[n][0] = yacc[n][1] = yacc[n][2] = yacc[n][3] = 0.f;
#pragma unroll 2
  for (int kk = 0; kk < kMaxDim / 8; ++kk) {
    const int d = kk * 8 + t4;
    uint32_t a[4];
    a[0] = tc::to_tf32(r_at(trow, d) * tc::ex2(cs[trow * kCStride + d]));
    a[1] = tc::to_tf32(r_at(trow + 8, d) * tc::ex2(cs[(trow + 8) * kCStride + d]));
    a[2] = tc::to_tf32(r_at(trow, d + 4) * tc::ex2(cs[trow * kCStride + d + 4]));
    a[3] = tc::to_tf32(r_at(trow + 8, d + 4) * tc::ex2(cs[(trow + 8) * kCStride + d + 4]));
#pragma unroll
    for (int n = 0; n < kMaxDim / 8; ++n) {  // S_in was rounded to TF32 by the state pass
      tc::mma_tf32(yacc[n], a, __float_as_uint(sa[d * kSStride + n * 8 + g]),
                   __float_as_uint(sa[(d + 4) * kSStride + n * 8 + g]));
    }
  }
  __syncthreads();  // every warp is done with S_in: A takes its place
  float* A = sa;

  // A left of the warp's diagonal sub-block (j < s): r~_t . k~_j against
  // step s - 1, TF32 products
  if (warp > 0) {
    const float* cref = cs + s * kCStride;                // c_{s-1} log2e
    float off[2 * (kWarps - 1)][4];                       // n-tiles of j < s
#pragma unroll
    for (int n = 0; n < 2 * (kWarps - 1); ++n) off[n][0] = off[n][1] = off[n][2] = off[n][3] = 0.f;
#pragma unroll 2
    for (int kk = 0; kk < kMaxDim / 8; ++kk) {
      const int d = kk * 8 + t4;
      const float c0 = cref[d], c1 = cref[d + 4];
      uint32_t a[4];
      a[0] = tc::to_tf32(r_at(trow, d) * tc::ex2(cs[trow * kCStride + d] - c0));
      a[1] = tc::to_tf32(r_at(trow + 8, d) * tc::ex2(cs[(trow + 8) * kCStride + d] - c0));
      a[2] = tc::to_tf32(r_at(trow, d + 4) * tc::ex2(cs[trow * kCStride + d + 4] - c1));
      a[3] = tc::to_tf32(r_at(trow + 8, d + 4) * tc::ex2(cs[(trow + 8) * kCStride + d + 4] - c1));
#pragma unroll
      for (int n = 0; n < 2 * (kWarps - 1); ++n) {
        if (n < 2 * warp) {  // warp-uniform
          const int j = n * 8 + g;                        // c_j is row j + 1 of cs
          const uint32_t b0 = tc::to_tf32(k_at(j, d) * tc::ex2(c0 - cs[(j + 1) * kCStride + d]));
          const uint32_t b1 =
              tc::to_tf32(k_at(j, d + 4) * tc::ex2(c1 - cs[(j + 1) * kCStride + d + 4]));
          tc::mma_tf32(off[n], a, b0, b1);
        }
      }
    }
#pragma unroll
    for (int n = 0; n < 2 * (kWarps - 1); ++n) {
      if (n < 2 * warp) {
        *reinterpret_cast<float2*>(A + trow * kCStride + n * 8 + 2 * t4) =
            make_float2(off[n][0], off[n][1]);
        *reinterpret_cast<float2*>(A + (trow + 8) * kCStride + n * 8 + 2 * t4) =
            make_float2(off[n][2], off[n][3]);
      }
    }
  }
  // The diagonal sub-block.  Its lower-left 8 x 8 quarter (rows s + 8 ..,
  // columns s .. s + 7) from factored operands against step s + 7, a TF32
  // product whose A rows s .. s + 7 are zero; both exponents are <= 0.
  {
    const float* cref = cs + (s + 8) * kCStride;          // c_{s+7} log2e
    const int j = s + g;                                  // column of this lane's B values
    float q[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 2
    for (int kk = 0; kk < kMaxDim / 8; ++kk) {
      const int d = kk * 8 + t4;
      const float c0 = cref[d], c1 = cref[d + 4];
      const uint32_t a[4] = {
          0u, tc::to_tf32(r_at(trow + 8, d) * tc::ex2(cs[(trow + 8) * kCStride + d] - c0)),
          0u, tc::to_tf32(r_at(trow + 8, d + 4) * tc::ex2(cs[(trow + 8) * kCStride + d + 4] - c1))};
      const uint32_t b0 = tc::to_tf32(k_at(j, d) * tc::ex2(c0 - cs[(j + 1) * kCStride + d]));
      const uint32_t b1 =
          tc::to_tf32(k_at(j, d + 4) * tc::ex2(c1 - cs[(j + 1) * kCStride + d + 4]));
      tc::mma_tf32(q, a, b0, b1);
    }
    *reinterpret_cast<float2*>(A + (trow + 8) * kCStride + s + 2 * t4) = make_float2(q[2], q[3]);
  }
  // its two diagonal 8 x 8 quarters per element: 2 x 28 strict pairs (t, j),
  // one a lane
  for (int p = lane; p < 2 * 28; p += 32) {
    const int quarter = p / 28, pq = p % 28;
    const int a = tri_row(pq) + 1;                        // pq = a (a - 1) / 2 + b, b < a
    const int t = s + 8 * quarter + a, j = s + 8 * quarter + pq - a * (a - 1) / 2;
    A[t * kCStride + j] = decayed_dot(rs + t * kBStride, ks + j * kBStride,
                                      cs + t * kCStride, cs + (j + 1) * kCStride, dk);
  }
  // the bonus on the diagonal, and zeros above it
  if (lane < kSub) {
    const int t = s + lane;
    const bf16* rt = rs + t * kBStride;
    const bf16* kt = ks + t * kBStride;
    float acc = 0.f;
    for (int d = 0; d < dk; d += 8) {
      const uint4 rv = *reinterpret_cast<const uint4*>(rt + d);
      const uint4 kv = *reinterpret_cast<const uint4*>(kt + d);
      const float4 u0 = *reinterpret_cast<const float4*>(us + d);
      const float4 u1 = *reinterpret_cast<const float4*>(us + d + 4);
      acc += lo_bf16(rv.x) * u0.x * lo_bf16(kv.x) + hi_bf16(rv.x) * u0.y * hi_bf16(kv.x);
      acc += lo_bf16(rv.y) * u0.z * lo_bf16(kv.y) + hi_bf16(rv.y) * u0.w * hi_bf16(kv.y);
      acc += lo_bf16(rv.z) * u1.x * lo_bf16(kv.z) + hi_bf16(rv.z) * u1.y * hi_bf16(kv.z);
      acc += lo_bf16(rv.w) * u1.z * lo_bf16(kv.w) + hi_bf16(rv.w) * u1.w * hi_bf16(kv.w);
    }
    A[t * kCStride + t] = acc;
  }
  for (int p = lane; p < kSub * kSub; p += 32) {
    const int tl = p / kSub, jl = p % kSub;
    if (jl > tl) A[(s + tl) * kCStride + s + jl] = 0.f;
  }
  __syncwarp();  // the warp reads back only the rows it wrote

  // y += A V over j < s + 16, TF32 products (V is bf16, exact in TF32)
  for (int kk = 0; kk < 2 * (warp + 1); ++kk) {  // warp-uniform bound
    const int j = kk * 8 + t4;
    uint32_t a[4];
    a[0] = tc::to_tf32(A[trow * kCStride + j]);
    a[1] = tc::to_tf32(A[(trow + 8) * kCStride + j]);
    a[2] = tc::to_tf32(A[trow * kCStride + j + 4]);
    a[3] = tc::to_tf32(A[(trow + 8) * kCStride + j + 4]);
#pragma unroll
    for (int n = 0; n < kMaxDim / 8; ++n) {
      tc::mma_tf32(yacc[n], a, __float_as_uint(__bfloat162float(vs[j * kBStride + n * 8 + g])),
                   __float_as_uint(__bfloat162float(vs[(j + 4) * kBStride + n * 8 + g])));
    }
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int t = trow + 8 * h;
    if (t >= len) continue;
    bf16* y_row = y + (row0 + t) * dv;
#pragma unroll
    for (int n = 0; n < kMaxDim / 8; ++n) {
      const int e = n * 8 + 2 * t4;
      if (dv % 2 == 0 && e + 1 < dv) {
        *reinterpret_cast<__nv_bfloat162*>(y_row + e) =
            __floats2bfloat162_rn(yacc[n][2 * h], yacc[n][2 * h + 1]);
      } else {
        if (e < dv) y_row[e] = __float2bfloat16(yacc[n][2 * h]);
        if (e + 1 < dv) y_row[e + 1] = __float2bfloat16(yacc[n][2 * h + 1]);
      }
    }
  }
}

using wkv6_chunk::aligned16;

cudaError_t launch(const void* r, const void* k, const void* v, const void* log_w, const void* u,
                   const void* s0, void* y, void* s_last, void* workspace, int batch_heads,
                   int heads, int steps, int dk, int dv, cudaStream_t stream) {
  if (workspace == nullptr || !aligned16(workspace)) return cudaErrorInvalidValue;
  static std::atomic<unsigned long long> state_set{0}, out_set{0};
  cudaError_t err = launch::max_dynamic_smem_once(
      state_set, reinterpret_cast<const void*>(wkv6_state_kernel),
      static_cast<int>(kStateSmemBytes), true);
  if (err != cudaSuccess) return err;
  err = launch::max_dynamic_smem_once(out_set, reinterpret_cast<const void*>(wkv6_output_kernel),
                                      static_cast<int>(kOutSmemBytes), true);
  if (err != cudaSuccess) return err;
  const bf16* kb = static_cast<const bf16*>(k);
  const bf16* vb = static_cast<const bf16*>(v);
  const bf16* lb = static_cast<const bf16*>(log_w);
  const bool vec = dk % 8 == 0 && dv % 8 == 0 && aligned16(r) && aligned16(k) && aligned16(v) &&
                   aligned16(log_w);
  wkv6_state_kernel<<<batch_heads, kStateThreads, kStateSmemBytes, stream>>>(
      kb, vb, lb, static_cast<const float*>(s0), static_cast<float*>(workspace),
      static_cast<float*>(s_last), steps, dk, dv, vec);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  wkv6_output_kernel<<<dim3(batch_heads, (steps + kChunk - 1) / kChunk), kThreads,
                       kOutSmemBytes, stream>>>(
      static_cast<const bf16*>(r), kb, vb, lb, static_cast<const float*>(u),
      static_cast<const float*>(workspace), static_cast<bf16*>(y), heads, steps, dk, dv, vec);
  return cudaGetLastError();
}

}  // namespace chunked

// ---- T = 1, both dtypes: the decode step -----------------------------------------

namespace step {

constexpr int kThreads = 256;                 // (e, quarter): 64 columns x 4 quarters of d
constexpr int kQuarter = kMaxDim / 4;

template <typename T>
__global__ void __launch_bounds__(kThreads)
wkv6_step_kernel(const T* __restrict__ r, const T* __restrict__ k, const T* __restrict__ v,
                 const T* __restrict__ log_w, const float* __restrict__ u,
                 const float* __restrict__ s0, T* __restrict__ y, float* __restrict__ s_last,
                 int heads, int dk, int dv) {
  __shared__ float rd[kMaxDim], kd[kMaxDim], wd[kMaxDim], ud[kMaxDim];
  __shared__ float part[4][kMaxDim];
  const int bh = blockIdx.x;
  const int tid = threadIdx.x;
  if (tid < dk) {
    const int64_t i = static_cast<int64_t>(bh) * dk + tid;
    rd[tid] = to_float(r[i]);
    kd[tid] = to_float(k[i]);
    wd[tid] = expf(to_float(log_w[i]));
    ud[tid] = u[(bh % heads) * dk + tid];
  }
  __syncthreads();
  const int e = tid % kMaxDim;
  const int quarter = tid / kMaxDim;
  float acc = 0.f;
  if (e < dv) {
    const float ve = to_float(v[static_cast<int64_t>(bh) * dv + e]);
    const int64_t base = static_cast<int64_t>(bh) * dk * dv + e;
#pragma unroll
    for (int i = 0; i < kQuarter; ++i) {
      const int d = quarter * kQuarter + i;
      if (d < dk) {
        const int64_t at = base + static_cast<int64_t>(d) * dv;
        const float s = s0 != nullptr ? s0[at] : 0.f;
        const float kv = kd[d] * ve;
        acc += rd[d] * (s + ud[d] * kv);
        s_last[at] = wd[d] * s + kv;
      }
    }
  }
  part[quarter][e] = acc;
  __syncthreads();
  if (tid < dv) {
    y[static_cast<int64_t>(bh) * dv + tid] =
        from_float<T>(part[0][tid] + part[1][tid] + part[2][tid] + part[3][tid]);
  }
}

template <typename T>
cudaError_t launch(const void* r, const void* k, const void* v, const void* log_w, const void* u,
                   const void* s0, void* y, void* s_last, int batch_heads, int heads, int dk,
                   int dv, cudaStream_t stream) {
  wkv6_step_kernel<T><<<batch_heads, kThreads, 0, stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(log_w), static_cast<const float*>(u), static_cast<const float*>(s0),
      static_cast<T*>(y), static_cast<float*>(s_last), heads, dk, dv);
  return cudaGetLastError();
}

}  // namespace step

}  // namespace

// r, k, log_w (B, H, T, dk), v (B, H, T, dv) contiguous, all f32 (is_bf16 = 0) or
// all bf16; u (H, dk) f32; s0 (B, H, dk, dv) f32 or null (zeros); 1 <= dk, dv
// <= 64.  Writes y (B, H, T, dv) in the input type and s_last (B, H, dk, dv)
// f32.  bf16 with T > 1 needs `workspace`, (B*H, ceil(T / 64), 64, 64) f32 and
// 16-byte aligned (null otherwise).  Launches on `stream` (two kernels for bf16
// with T > 1, else one) and returns the first launch error (0 on success).
extern "C" int wkv6_fwd(const void* r, const void* k, const void* v, const void* log_w,
                        const void* u, const void* s0, void* y, void* s_last, void* workspace,
                        int batch_heads, int heads, int steps, int dk, int dv, int is_bf16,
                        void* stream) {
  if (dk < 1 || dk > kMaxDim || dv < 1 || dv > kMaxDim || steps < 1) {
    return cudaErrorInvalidValue;
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (steps == 1) {
    return is_bf16 ? step::launch<bf16>(r, k, v, log_w, u, s0, y, s_last, batch_heads, heads, dk,
                                        dv, s)
                   : step::launch<float>(r, k, v, log_w, u, s0, y, s_last, batch_heads, heads,
                                         dk, dv, s);
  }
  if (is_bf16) {
    return chunked::launch(r, k, v, log_w, u, s0, y, s_last, workspace, batch_heads, heads, steps,
                           dk, dv, s);
  }
  return f32::launch(r, k, v, log_w, u, s0, y, s_last, batch_heads, heads, steps, dk, dv, s);
}
