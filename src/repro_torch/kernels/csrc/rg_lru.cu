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
// at 3.35 TB/s.  To reach that rate the card needs ~2-3 MB of loads in flight
// (the rate times ~0.7 us of loaded DRAM latency).  The dependent chain along
// T, one multiply and one add a step, costs ~3 us at 512 steps and bounds
// nothing, so the design is about loads in flight, not about the order of
// the recurrence.
//
// Design, T > 1 (`rg_lru_scan_kernel`).  A CTA takes the lanes of one batch
// row that make one 128-byte row of a step (32 lanes in f32, 64 in bf16), one
// thread a lane, and walks T through a ring of kStages stages in shared
// memory, each holding kSteps steps of a and b for those lanes.  The copy of
// stage s + kStages - 1 (cp.async, 16 bytes a copy where the rows and
// pointers allow, else one element a thread) is issued before the chain of
// stage s runs, so kStages - 1 stages of every CTA (12 KB) are in flight
// while it computes: ~6 MB over the card at the serving shape, whose 512
// CTAs are all resident, ~4 an SM.  Each lane walks its own T in order, h in
// a register from h0 or 0.  Its y goes into a stage of y in shared memory,
// which the CTA then writes with 16-byte stores (4 rows a warp's store in
// f32): on the card the writes, not the loads or the chain, held the first
// version back, which stored each step's y from the chain, 4 bytes a thread.
// Where the rows are not 16-byte aligned, each lane stores its own y.
//
// Design, T = 1 (`rg_lru_step_kernel`), a decode step: no ring.  Each thread
// takes 4 lanes with 16-byte loads (8-byte in bf16) where the lane count and
// the pointers allow, one lane otherwise.
//
// Multiply and add are rounded one by one (no FMA contraction), as the plain
// version computes them, and every lane keeps its order along T, so in f32
// the kernel and the plain version agree bit for bit.  The TPU kernel's
// padding (a = 1, b = 0) becomes a bound on t and d, its VMEM carry along the
// "arbitrary" time axis the register.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tensor_core.cuh"

namespace {

constexpr int kRowBytes = 128;  // a CTA's lanes of one step
constexpr int kSteps = 16;      // steps a stage
constexpr int kStages = 4;      // stages in the ring
constexpr int kStepThreads = 128;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float step(float a, float h, float b) {
  return __fadd_rn(__fmul_rn(a, h), b);
}

// Copies steps [t0, t0 + kSteps) of a and b, lanes [d0, d0 + kLanes) of the
// rows from `row0` on, into one stage (sa, sb: kSteps x kLanes each).  Steps
// past T and lanes past D are zero-filled (kVec) or left as they are; the
// chain never reads them into a stored value.
template <typename T, bool kVec>
__device__ __forceinline__ void load_stage(T* sa, T* sb, const T* __restrict__ a,
                                           const T* __restrict__ b, int64_t row0, int t0,
                                           int steps, int d, int d0) {
  constexpr int kLanes = kRowBytes / sizeof(T);
  if constexpr (kVec) {  // rows of D elements are 16-byte aligned
    constexpr int kPer = 16 / sizeof(T);     // elements a copy
    constexpr int kCopies = kLanes / kPer;   // copies a row
    for (int c = threadIdx.x; c < 2 * kSteps * kCopies; c += kLanes) {
      const int row = c / kCopies;           // a's steps first, then b's
      const int i = row % kSteps;
      const int col = (c % kCopies) * kPer;
      const bool ok = t0 + i < steps && d0 + col < d;
      const int64_t at = ok ? (row0 + t0 + i) * d + d0 + col : 0;
      T* dst = (row < kSteps ? sa : sb) + i * kLanes + col;
      tc::cp_async16(dst, (row < kSteps ? a : b) + at, ok ? 16 : 0);
    }
  } else {  // each thread its own lane
    const int lane = threadIdx.x;
    for (int i = 0; i < kSteps; ++i) {
      const bool ok = t0 + i < steps && d0 + lane < d;
      const int64_t at = ok ? (row0 + t0 + i) * d + d0 + lane : 0;
      if constexpr (sizeof(T) == 4) {
        tc::cp_async4(sa + i * kLanes + lane, a + at, ok ? 4 : 0);
        tc::cp_async4(sb + i * kLanes + lane, b + at, ok ? 4 : 0);
      } else if (ok) {  // no 2-byte cp.async: a plain copy
        sa[i * kLanes + lane] = a[at];
        sb[i * kLanes + lane] = b[at];
      }
    }
  }
}

// One CTA: batch row blockIdx.x / d_tiles, lanes d0 .. d0 + kLanes - 1.
template <typename T, bool kVec>
__global__ void __launch_bounds__(kRowBytes / sizeof(T))
rg_lru_scan_kernel(const T* __restrict__ a, const T* __restrict__ b,
                   const float* __restrict__ h0, T* __restrict__ y, float* __restrict__ h_last,
                   int steps, int d, int d_tiles) {
  constexpr int kLanes = kRowBytes / sizeof(T);
  __shared__ __align__(16) T sa[kStages][kSteps * kLanes];
  __shared__ __align__(16) T sb[kStages][kSteps * kLanes];
  __shared__ __align__(16) T sy[kSteps * kLanes];  // a stage of y (kVec)
  const int bi = blockIdx.x / d_tiles;
  const int d0 = (blockIdx.x - bi * d_tiles) * kLanes;
  const int lane = threadIdx.x;
  const bool live = d0 + lane < d;
  const int64_t row0 = static_cast<int64_t>(bi) * steps;  // row (bi, t = 0) of (B*T, D)
  const int64_t at = static_cast<int64_t>(bi) * d + d0 + lane;  // (bi, d) in (B, D)
  const int groups = (steps + kSteps - 1) / kSteps;
  float h = live && h0 != nullptr ? h0[at] : 0.f;

  // group j of this thread's cp.async copies holds stage j
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < groups) load_stage<T, kVec>(sa[s], sb[s], a, b, row0, s * kSteps, steps, d, d0);
    tc::cp_async_commit();
  }
  for (int g = 0; g < groups; ++g) {
    const int next = g + kStages - 1;  // the copy flies while stage g's chain runs
    if (next < groups) {
      load_stage<T, kVec>(sa[next % kStages], sb[next % kStages], a, b, row0, next * kSteps,
                          steps, d, d0);
    }
    tc::cp_async_commit();
    tc::cp_async_wait<kStages - 1>();
    __syncthreads();  // every thread's copies of stage g have landed
    const T* ra = sa[g % kStages];
    const T* rb = sb[g % kStages];
    const int t0 = g * kSteps;
    const int n = min(kSteps, steps - t0);
    T* yp = y + (row0 + t0) * d + d0 + lane;
#pragma unroll
    for (int i = 0; i < kSteps; ++i) {
      if (i < n) {
        h = step(to_float(ra[i * kLanes + lane]), h, to_float(rb[i * kLanes + lane]));
        if constexpr (kVec) {
          sy[i * kLanes + lane] = from_float<T>(h);
        } else if (live) {
          yp[static_cast<int64_t>(i) * d] = from_float<T>(h);
        }
      }
    }
    if constexpr (kVec) {  // the stage's y rows, 16 bytes a store
      constexpr int kPer = 16 / sizeof(T);
      constexpr int kCopies = kLanes / kPer;
      __syncthreads();
      for (int c = lane; c < n * kCopies; c += kLanes) {
        const int i = c / kCopies;
        const int col = (c % kCopies) * kPer;
        if (d0 + col < d) {
          *reinterpret_cast<uint4*>(y + (row0 + t0 + i) * d + d0 + col) =
              *reinterpret_cast<const uint4*>(sy + i * kLanes + col);
        }
      }
    }
    __syncthreads();  // stage g (and y's stage) is read before it is refilled
  }
  if (live) h_last[at] = h;
}

__device__ __forceinline__ void load4(const float* p, float (&v)[4]) {
  const float4 x = *reinterpret_cast<const float4*>(p);
  v[0] = x.x, v[1] = x.y, v[2] = x.z, v[3] = x.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float (&v)[4]) {
  const uint2 x = *reinterpret_cast<const uint2*>(p);
  const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&x.x));
  const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&x.y));
  v[0] = lo.x, v[1] = lo.y, v[2] = hi.x, v[3] = hi.y;
}
__device__ __forceinline__ void store4(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, const float (&v)[4]) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(v[0], v[1]);
  const __nv_bfloat162 hi = __floats2bfloat162_rn(v[2], v[3]);
  uint2 x;
  x.x = *reinterpret_cast<const uint32_t*>(&lo);
  x.y = *reinterpret_cast<const uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(p) = x;
}

// T = 1 over n = B * D lanes: 4 lanes a thread (kVec) or one.
template <typename T, bool kVec>
__global__ void __launch_bounds__(kStepThreads)
rg_lru_step_kernel(const T* __restrict__ a, const T* __restrict__ b,
                   const float* __restrict__ h0, T* __restrict__ y, float* __restrict__ h_last,
                   int64_t n) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kStepThreads + threadIdx.x;
  if constexpr (kVec) {
    const int64_t e = i * 4;
    if (e >= n) return;
    float av[4], bv[4], hv[4] = {0.f, 0.f, 0.f, 0.f};
    load4(a + e, av);
    load4(b + e, bv);
    if (h0 != nullptr) load4(h0 + e, hv);
#pragma unroll
    for (int k = 0; k < 4; ++k) hv[k] = step(av[k], hv[k], bv[k]);
    store4(y + e, hv);
    store4(h_last + e, hv);
  } else {
    if (i >= n) return;
    const float h = step(to_float(a[i]), h0 != nullptr ? h0[i] : 0.f, to_float(b[i]));
    y[i] = from_float<T>(h);
    h_last[i] = h;
  }
}

// ---- The backward (B4'): B4's ring walked backwards ----------------------------
//
// The JAX op has no backward kernel: its custom_vjp differentiates the jnp
// reference scan (src/repro/kernels/rg_lru/ops.py:24).  With dh_t the
// gradient of h_t, dh_{T-1} = gy_{T-1} + gh_last and dh_t = gy_t + a_{t+1}
// dh_{t+1}; da_t = dh_t h_{t-1} (h_{-1} = h0, or 0), db_t = dh_t and
// dh0 = a_0 dh_0.  h is the forward's y, saved by the op: in f32 it is h
// itself, in bf16 h rounded (one bf16 step in h_{t-1}, under the bf16 bound
// of da).
//
// What bounds it on the H100: bytes.  It reads a, y and gy once and writes
// da and db once: 5 x 67.1 MB at the training shape (8, 512, 4096, f32),
// 0.100 ms at 3.35 TB/s; one add and two multiplies a step bound nothing.
// Design: the forward's ring, walked from the end of T to 0.  A CTA takes
// one 128-byte row of lanes (32 in f32, 64 in bf16), a thread a lane; a
// kStages-stage cp.async ring of kSteps steps holds a, gy and y shifted one
// step back (the stage of steps [t0, t0 + kSteps) holds y rows [t0 - 1,
// t0 + kSteps - 1), and h0 or 0 stands in at t = 0), kStages - 1 stages in
// flight while a stage's chain runs.  The chain writes db and da over the
// stage's gy and a, each lane its own entries once it has read them, and
// the CTA stores them with 16-byte stores; where the rows are not 16-byte
// aligned each lane copies and stores its own values.  So a CTA holds 24 KB
// of shared memory, 9 an SM: the 1,024 CTAs of the training shape (f32)
// run in one wave (a separate da/db stage, 28 KB, left 7 an SM and two
// waves).  Adds and multiplies are rounded one by one, in the plain
// version's order, so in f32 the two agree bit for bit.

// Copies steps [t0, t0 + kSteps) of a and gy and rows [t0 - 1, t0 + kSteps -
// 1) of y, lanes [d0, d0 + kLanes), into one stage of each (kSteps x kLanes).
// Steps past T, lanes past D and y's row -1 are zero-filled (kVec) or left as
// they are; the chain never reads them into a stored value.
template <typename T, bool kVec>
__device__ __forceinline__ void load_bwd_stage(T* sa, T* sg, T* sh, const T* __restrict__ a,
                                               const T* __restrict__ gy, const T* __restrict__ y,
                                               int64_t row0, int t0, int steps, int d, int d0) {
  constexpr int kLanes = kRowBytes / sizeof(T);
  if constexpr (kVec) {  // rows of D elements are 16-byte aligned
    constexpr int kPer = 16 / sizeof(T);     // elements a copy
    constexpr int kCopies = kLanes / kPer;   // copies a row
    for (int c = threadIdx.x; c < 3 * kSteps * kCopies; c += kLanes) {
      const int row = c / kCopies;           // a's steps, then gy's, then y's
      const int which = row / kSteps, i = row % kSteps;
      const int col = (c % kCopies) * kPer;
      const int t = t0 + i - (which == 2);   // y one step back
      const bool ok = t >= 0 && t0 + i < steps && d0 + col < d;
      const int64_t at = ok ? (row0 + t) * d + d0 + col : 0;
      T* dst = (which == 0 ? sa : which == 1 ? sg : sh) + i * kLanes + col;
      tc::cp_async16(dst, (which == 0 ? a : which == 1 ? gy : y) + at, ok ? 16 : 0);
    }
  } else {  // each thread its own lane
    const int lane = threadIdx.x;
    for (int i = 0; i < kSteps; ++i) {
      const bool ok = t0 + i < steps && d0 + lane < d;
      const bool ok_y = ok && t0 + i > 0;
      const int64_t at = ok ? (row0 + t0 + i) * d + d0 + lane : 0;
      const int64_t at_y = ok_y ? at - d : 0;
      if constexpr (sizeof(T) == 4) {
        tc::cp_async4(sa + i * kLanes + lane, a + at, ok ? 4 : 0);
        tc::cp_async4(sg + i * kLanes + lane, gy + at, ok ? 4 : 0);
        tc::cp_async4(sh + i * kLanes + lane, y + at_y, ok_y ? 4 : 0);
      } else if (ok) {  // no 2-byte cp.async: a plain copy
        sa[i * kLanes + lane] = a[at];
        sg[i * kLanes + lane] = gy[at];
        if (ok_y) sh[i * kLanes + lane] = y[at_y];
      }
    }
  }
}

// One CTA: batch row blockIdx.x / d_tiles, lanes d0 .. d0 + kLanes - 1.
template <typename T, bool kVec>
__global__ void __launch_bounds__(kRowBytes / sizeof(T))
rg_lru_bwd_kernel(const T* __restrict__ a, const T* __restrict__ y,
                  const float* __restrict__ h0, const T* __restrict__ gy,
                  const float* __restrict__ gh_last, T* __restrict__ da, T* __restrict__ db,
                  float* __restrict__ dh0, int steps, int d, int d_tiles) {
  constexpr int kLanes = kRowBytes / sizeof(T);
  __shared__ __align__(16) T sa[kStages][kSteps * kLanes];
  __shared__ __align__(16) T sg[kStages][kSteps * kLanes];
  __shared__ __align__(16) T sh[kStages][kSteps * kLanes];
  const int bi = blockIdx.x / d_tiles;
  const int d0 = (blockIdx.x - bi * d_tiles) * kLanes;
  const int lane = threadIdx.x;
  const bool live = d0 + lane < d;
  const int64_t row0 = static_cast<int64_t>(bi) * steps;  // row (bi, t = 0) of (B*T, D)
  const int64_t at = static_cast<int64_t>(bi) * d + d0 + lane;  // (bi, d) in (B, D)
  const int groups = (steps + kSteps - 1) / kSteps;
  const float h_init = live && h0 != nullptr ? h0[at] : 0.f;
  float dh = live && gh_last != nullptr ? gh_last[at] : 0.f;

  // the k-th group from the end, steps [(groups - 1 - k) kSteps, + kSteps),
  // sits in stage k % kStages; group j of this thread's copies holds the j-th
  auto load = [&](int k) {
    load_bwd_stage<T, kVec>(sa[k % kStages], sg[k % kStages], sh[k % kStages], a, gy, y, row0,
                            (groups - 1 - k) * kSteps, steps, d, d0);
  };
  for (int k = 0; k < kStages - 1; ++k) {
    if (k < groups) load(k);
    tc::cp_async_commit();
  }
  for (int k = 0; k < groups; ++k) {
    if (k + kStages - 1 < groups) load(k + kStages - 1);  // flies while this stage's chain runs
    tc::cp_async_commit();
    tc::cp_async_wait<kStages - 1>();
    __syncthreads();  // every thread's copies of this stage have landed
    T* ra = sa[k % kStages];  // a, then da
    T* rg = sg[k % kStages];  // gy, then db
    const T* rh = sh[k % kStages];
    const int t0 = (groups - 1 - k) * kSteps;
    const int n = min(kSteps, steps - t0);
    T* dap = da + (row0 + t0) * d + d0 + lane;
    T* dbp = db + (row0 + t0) * d + d0 + lane;
#pragma unroll
    for (int i = kSteps - 1; i >= 0; --i) {
      if (i < n) {
        const float hv = t0 + i == 0 ? h_init : to_float(rh[i * kLanes + lane]);
        const float av = to_float(ra[i * kLanes + lane]);
        dh = __fadd_rn(dh, to_float(rg[i * kLanes + lane]));
        const float dav = __fmul_rn(dh, hv);
        if constexpr (kVec) {
          rg[i * kLanes + lane] = from_float<T>(dh);
          ra[i * kLanes + lane] = from_float<T>(dav);
        } else if (live) {
          dbp[static_cast<int64_t>(i) * d] = from_float<T>(dh);
          dap[static_cast<int64_t>(i) * d] = from_float<T>(dav);
        }
        dh = __fmul_rn(av, dh);
      }
    }
    if constexpr (kVec) {  // the stage's da and db rows, 16 bytes a store
      constexpr int kPer = 16 / sizeof(T);
      constexpr int kCopies = kLanes / kPer;
      __syncthreads();
      for (int c = lane; c < n * kCopies; c += kLanes) {
        const int i = c / kCopies;
        const int col = (c % kCopies) * kPer;
        if (col < d - d0) {
          const int64_t o = (row0 + t0 + i) * d + d0 + col;
          *reinterpret_cast<uint4*>(da + o) = *reinterpret_cast<const uint4*>(ra + i * kLanes + col);
          *reinterpret_cast<uint4*>(db + o) = *reinterpret_cast<const uint4*>(rg + i * kLanes + col);
        }
      }
    }
    __syncthreads();  // the stage is read before it is refilled
  }
  if (live) dh0[at] = dh;
}

bool aligned(const void* p, size_t bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

template <typename T>
cudaError_t launch(const void* a, const void* b, const void* h0, void* y, void* h_last,
                   int batch, int steps, int d, cudaStream_t stream) {
  const T* ta = static_cast<const T*>(a);
  const T* tb = static_cast<const T*>(b);
  const float* th0 = static_cast<const float*>(h0);
  T* ty = static_cast<T*>(y);
  float* th = static_cast<float*>(h_last);
  if (steps == 1) {
    const int64_t n = static_cast<int64_t>(batch) * d;
    const bool vec = n % 4 == 0 && aligned(a, 4 * sizeof(T)) && aligned(b, 4 * sizeof(T)) &&
                     aligned(y, 4 * sizeof(T)) && aligned(h_last, 16) &&
                     (h0 == nullptr || aligned(h0, 16));
    const int64_t threads = vec ? n / 4 : n;
    const unsigned blocks = static_cast<unsigned>((threads + kStepThreads - 1) / kStepThreads);
    if (vec) {
      rg_lru_step_kernel<T, true><<<blocks, kStepThreads, 0, stream>>>(ta, tb, th0, ty, th, n);
    } else {
      rg_lru_step_kernel<T, false><<<blocks, kStepThreads, 0, stream>>>(ta, tb, th0, ty, th, n);
    }
  } else {
    constexpr int kLanes = kRowBytes / sizeof(T);
    const int d_tiles = (d + kLanes - 1) / kLanes;
    const int64_t blocks = static_cast<int64_t>(batch) * d_tiles;
    if (blocks > 0x7fffffff) return cudaErrorInvalidConfiguration;
    const bool vec = (static_cast<size_t>(d) * sizeof(T)) % 16 == 0 && aligned(a, 16) &&
                     aligned(b, 16);
    if (vec) {
      rg_lru_scan_kernel<T, true><<<static_cast<unsigned>(blocks), kLanes, 0, stream>>>(
          ta, tb, th0, ty, th, steps, d, d_tiles);
    } else {
      rg_lru_scan_kernel<T, false><<<static_cast<unsigned>(blocks), kLanes, 0, stream>>>(
          ta, tb, th0, ty, th, steps, d, d_tiles);
    }
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_bwd(const void* a, const void* y, const void* h0, const void* gy,
                       const void* gh_last, void* da, void* db, void* dh0, int batch, int steps,
                       int d, cudaStream_t stream) {
  constexpr int kLanes = kRowBytes / sizeof(T);
  const int d_tiles = (d + kLanes - 1) / kLanes;
  const int64_t blocks = static_cast<int64_t>(batch) * d_tiles;
  if (steps < 1 || blocks < 1 || blocks > 0x7fffffff) return cudaErrorInvalidConfiguration;
  const bool vec = (static_cast<size_t>(d) * sizeof(T)) % 16 == 0 && aligned(a, 16) &&
                   aligned(y, 16) && aligned(gy, 16) && aligned(da, 16) && aligned(db, 16);
  const T* ta = static_cast<const T*>(a);
  const T* ty = static_cast<const T*>(y);
  const T* tg = static_cast<const T*>(gy);
  const float* th0 = static_cast<const float*>(h0);
  const float* tgh = static_cast<const float*>(gh_last);
  if (vec) {
    rg_lru_bwd_kernel<T, true><<<static_cast<unsigned>(blocks), kLanes, 0, stream>>>(
        ta, ty, th0, tg, tgh, static_cast<T*>(da), static_cast<T*>(db),
        static_cast<float*>(dh0), steps, d, d_tiles);
  } else {
    rg_lru_bwd_kernel<T, false><<<static_cast<unsigned>(blocks), kLanes, 0, stream>>>(
        ta, ty, th0, tg, tgh, static_cast<T*>(da), static_cast<T*>(db),
        static_cast<float*>(dh0), steps, d, d_tiles);
  }
  return cudaGetLastError();
}

}  // namespace

// a, b (B, T, D) contiguous, both f32 (is_bf16 = 0) or both bf16; h0 (B, D) f32
// or null (zeros).  Writes y (B, T, D) in the input type and h_last (B, D) f32.
// T = 1 launches the step kernel, T > 1 the ring.  Launches on `stream` and
// returns the launch's cudaError_t (0 on success).
extern "C" int rg_lru_fwd(const void* a, const void* b, const void* h0, void* y, void* h_last,
                          int batch, int steps, int d, int is_bf16, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) return launch<__nv_bfloat16>(a, b, h0, y, h_last, batch, steps, d, s);
  return launch<float>(a, b, h0, y, h_last, batch, steps, d, s);
}

// The backward.  a, y (the forward's output), gy (B, T, D) contiguous, all f32
// (is_bf16 = 0) or all bf16; h0, gh_last (B, D) f32 or null (zeros).  Writes
// da, db (B, T, D) in the input type and dh0 (B, D) f32.  Launches on `stream`
// and returns the launch's cudaError_t (0 on success).
extern "C" int rg_lru_bwd(const void* a, const void* y, const void* h0, const void* gy,
                          const void* gh_last, void* da, void* db, void* dh0, int batch,
                          int steps, int d, int is_bf16, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    return launch_bwd<__nv_bfloat16>(a, y, h0, gy, gh_last, da, db, dh0, batch, steps, d, s);
  }
  return launch_bwd<float>(a, y, h0, gy, gh_last, da, db, dh0, batch, steps, d, s);
}
