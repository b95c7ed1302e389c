// Certified fabric playback (kernel B6) for NVIDIA Hopper (sm_90a), hand-written CUDA C++.
//
// Replaces the jitted XLA playback `_kernel` of src/repro/core/batchsim_jax.py:75-131
// (`jax.jit` of a `vmap` over lanes: a `lax.scan` over steps, a `while_loop`
// over hops, a `scan` over chunks).  No `pl.pallas_call` lies behind it: the
// reference leaves the loop nest to XLA, which fuses it into one program.  In
// plain PyTorch the same playback launches several kernels for every (step,
// hop, chunk), thousands a batch at the reference's own n = 32768 grid, so
// the port writes it by hand.
//
// What it computes, per certified (uniform) lane, in float64: for each step k,
// F += delta_eff where changed[k]; the injection recv + alpha_s; tau =
// (nb[k] / C) * beta; then for each of hops[k] hops, at every port p and for
// each chunk c in order, f = max(f, arrival[c][p]) + tau, comp[c][p] = f,
// where hop 0's arrivals are the injection and a later hop's are
// comp[c][(p - g[k]) mod n] of the hop before plus alpha_h.  The last hop's
// chunk C - 1, gathered the same way, plus alpha_h, is recv; step_done[k] is
// its maximum over the ports.  A step with no hops (or a negative count)
// leaves recv as it was.
//
// What bounds it on the H100.  Each lane is a serial chain: a hop's arrivals
// are the previous hop's completions on another port, and each port's chunks
// depend one on the next.  Two bounds, which chip_smoke.py prints: the FP64
// work (a max and an add a chunk service, n * C * sum(hops) services a lane)
// at the FP64 peak of 34 TFLOP/s, and the longest lane's chain, sum(hops) * C
// dependent max-and-add pairs plus one barrier a hop (a cluster's exchange
// where the lane spans CTAs).  The bytes (the tapes in, three float64 arrays
// out) bound nothing.
//
// Design: the slot frame.  Within a step the offset g is fixed, so the train
// of C chunks that enters port s at hop 0 sits at port s + j * g at hop j.
// The state follows the train, not the port: slot s keeps its train (its
// chunks' arrival times at its next port, comp + alpha_h) where it lives for
// the whole step, and each hop needs only the clock F of the port it has
// reached.  That clock was left by the slot that served the port the hop
// before, slot s + g; so each hop a slot serves its C chunks on the clock it
// was handed, pushes the new clock (one double) to slot s - g, and adds
// alpha_h to its train while the pushes land.  What crosses threads a
// hop is 8 bytes a port, where the first design gathered 8 * C.  After a step of h
// hops slot s holds recv and F of port s + h * g: the kernel keeps a frame
// offset (slot s is port s + off mod n) instead of moving state back, so a
// step costs nothing at its boundary but the maximum behind step_done, and
// only the last write-out puts the ports in order.
//
// Design: the lane on chip.  `launch_plan` (kernels/playback/kernel.py)
// splits a lane's n slots into `cluster` contiguous ranges, one a CTA of a
// thread-block cluster (up to 16, non-portable), a thread owning slots i,
// i + T, ... of its CTA's range.  The clocks live in shared memory,
// double-buffered.  On a cluster a push is an st.async into the owning
// CTA's buffer through distributed shared memory, which counts its 8 bytes
// on that CTA's mbarrier; each CTA waits for the bytes its own slots receive
// (`Exchange`).  The hop's cluster barrier only guards a buffer against
// pushes while its owners still read it, so it is relaxed (no fence) and
// split: a thread arrives once it has used the hop's clocks and waits before
// its next pushes, a hop later.  A lane of one CTA pushes with plain stores
// and ends its hop with __syncthreads.  The trains live in registers
// (`playback_reg_kernel`, for C a power of two up to 16, 8 to 32 doubles a
// thread) on the fewest CTAs that hold them there; else in the CTA's shared
// memory, or where even that does not fit in a workspace in device memory
// that only the owning thread touches (`playback_mem_kernel`).  A train
// never crosses a barrier.  step_done's maximum is a block reduction and one
// push a CTA to rank 0, once a step.  The wrapper orders the lanes longest
// first, so the longest starts at once and the short ones fill the other
// SMs; results are written in lane order.  A cluster that cannot be placed,
// or shared memory beyond the limit, makes the launch fail, and the wrapper
// raises.  On an H100 the exchange costs about 1 % of a hop; the chunks'
// compares (a DSETP and two selects on each link of the chain) take 40-66 %.
//
// The first design: one CTA a lane (at most 1024 threads), threads
// striding over the ports, F, recv and a double-buffered comp (B x 2 x C x n)
// in global memory, every hop gathering C values of another port's comp
// through L2, then __syncthreads().  On an H100 80GB HBM3 at 700 W it took
// 0.5056 ms (n = 1536 x 256 lanes, C = 4), 1.3997 ms (8192 x 64, C = 2),
// 12.0769 ms (32768 x 32, C = 2), 4.6191 ms (the planner's a2a set at
// n = 1536, C = 8) and 1889 ms (that set at n = 32768, 58 us a hop).
//
// Bit-exactness with NumPy's `_play` and the XLA kernel.  The arithmetic is
// written with __ddiv_rn, __dmul_rn and __dadd_rn, which nvcc never
// contracts into an FMA (the shared build flags keep -fmad=true for the
// other kernels); max is exact in any order.  The per-(port, chunk) sequence
// of operations is the first design's; only where each value is stored
// changed.
// The scalars come in as doubles.  The push target is Python's modulo for
// any int g: g is reduced to [0, n) once a step and s - g wrapped by one add.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <atomic>

#include "launch.cuh"

namespace {

constexpr int kRegThreads = 512;   // the register kernels' launch bound
constexpr int kMemThreads = 1024;  // the memory kernel's
constexpr int kMaxCluster = 16;
constexpr int kMaxima = 32 + kMaxCluster;   // doubles: warp maxima, the cluster's CTA maxima
constexpr int kScratch = kMaxima + 2;       // and the exchange's two mbarriers
constexpr int kSmemLimit = 232448;          // dynamic shared memory a CTA may have

// Everything a kernel reads, by value.  A lane's CTAs are blocks
// [p * K, (p + 1) * K) of the grid; launch position p plays lane order[p].
struct Tape {
  const double* nb;
  const int* g;
  const int* hops;
  const uint8_t* changed;
  const double* delta_eff;
  const int* order;
  double alpha_s, alpha_h, beta;
  int n, C, S;
  int K, L;  // CTAs a lane (the cluster), slots a CTA
  bool comp_in_smem;  // memory kernel: trains in shared memory, else in `comp`
  double* node_done;
  double* step_done;
  double* port_free;
  double* comp;
};

struct Step {
  bool changed;
  int hops, g;
  double tau;
};

__device__ __forceinline__ Step read_step(const Tape& t, int64_t at) {
  Step s;
  s.changed = t.changed[at] != 0;
  s.hops = t.hops[at];
  s.g = ((t.g[at] % t.n) + t.n) % t.n;
  s.tau = __dmul_rn(__ddiv_rn(t.nb[at], static_cast<double>(t.C)), t.beta);
  return s;
}

// Where slot s pushes its clock in a step of offset g: slot (s - g) mod n, as
// (owning CTA's rank << 16) | its offset in that CTA's range.
__device__ __forceinline__ uint32_t target_of(int s, int g, int n, int L) {
  int u = s - g;
  u += u < 0 ? n : 0;
  const int rank = u / L;
  return (static_cast<uint32_t>(rank) << 16) | static_cast<uint32_t>(u - rank * L);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// The address in the cluster's shared window of this CTA's `addr` in CTA `rank`.
__device__ __forceinline__ uint32_t map_to(uint32_t addr, uint32_t rank) {
  uint32_t out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(out) : "r"(addr), "r"(rank));
  return out;
}

// A whole barrier of the lane's CTAs (release, acquire).
__device__ __forceinline__ void lane_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n\t"
               "barrier.cluster.wait.acquire.aligned;" ::: "memory");
}

// The lane's exchange of clocks.  Each CTA holds two buffers of L doubles and
// an mbarrier each; a hop's pushes into a buffer are st.async stores that
// count their bytes on its owner's mbarrier, so a CTA waits for exactly the
// 8 * len bytes its slots receive, not for its peers.  The buffer a hop
// fills was read by its owners the hop before; the hop's cluster barrier,
// split and relaxed (no fence: the data's ordering is the mbarrier's), keeps
// a push out of it until they have: a thread arrives once it has used this
// hop's clocks and waits before its next pushes.  A lane of one CTA makes the
// same calls with plain stores and __syncthreads (`local`).
struct Exchange {
  double* buf;     // [2][L]
  uint64_t* bar;   // [2]
  int L;
  uint32_t bytes;  // pushed into this CTA's buffer each hop: 8 * its slots
  uint32_t phase;  // bit b: the parity bar[b] is in
  bool pending;    // an arrive on the hop barrier not yet waited for
  bool local;      // one CTA: plain stores, __syncthreads

  __device__ Exchange(double* smem, int L_, int len, int K)
      : buf(smem), bar(reinterpret_cast<uint64_t*>(smem + 2 * L_ + kMaxima)), L(L_),
        bytes(8u * static_cast<uint32_t>(len)), phase(0), pending(false), local(K == 1) {}

  // Initialises the mbarriers; returns once every CTA of the lane runs.
  __device__ void start() {
    if (local) {
      __syncthreads();
      return;
    }
    if (threadIdx.x == 0) {
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n\t"
                   "mbarrier.init.shared::cta.b64 [%1], 1;\n\t"
                   "fence.mbarrier_init.release.cluster;"
                   :: "r"(smem_u32(bar)), "r"(smem_u32(bar + 1)) : "memory");
    }
    lane_sync();
  }
  // Thread 0, once a hop: the bytes buffer b receives this hop.
  __device__ void expect(int b) const {
    if (local) return;
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
                 :: "r"(smem_u32(bar + b)), "r"(bytes) : "memory");
  }
  // Before a hop's pushes: the peers have read the buffer they fill.
  __device__ void ready_to_push() {
    if (pending) asm volatile("barrier.cluster.wait.aligned;" ::: "memory");
    pending = false;
  }
  __device__ void push(int b, uint32_t target, double f) const {
    if (local) {
      buf[b * L + target] = f;
      return;
    }
    const uint32_t rank = target >> 16;
    const uint32_t at = map_to(smem_u32(buf + b * L + (target & 0xffffu)), rank);
    asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes.b64 [%0], %1, [%2];"
                 :: "r"(at), "l"(__double_as_longlong(f)), "r"(map_to(smem_u32(bar + b), rank))
                 : "memory");
  }
  // After a hop's pushes: this thread has used the clocks it read.
  __device__ void arrive() {
    if (local) return;
    asm volatile("barrier.cluster.arrive.relaxed.aligned;" ::: "memory");
    pending = true;
  }
  // Until buffer b holds every clock pushed into it this hop.
  __device__ void wait(int b) {
    if (local) {
      __syncthreads();
      return;
    }
    asm volatile("{\n\t.reg .pred ready;\n\t"
                 "WAIT:\n\t"
                 "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 ready, [%0], %1;\n\t"
                 "@!ready bra WAIT;\n\t}"
                 :: "r"(smem_u32(bar + b)), "r"((phase >> b) & 1u) : "memory");
    phase ^= 1u << b;
  }
  // A whole barrier of the lane (the hop barrier's arrive waited for first).
  __device__ void sync() {
    ready_to_push();
    if (local) __syncthreads(); else lane_sync();
  }
};

// The lane's maximum of each thread's `m`, returned at rank 0's thread 0
// (partial elsewhere): warp maxima, the CTA's in warp 0, pushed to rank 0.
__device__ __forceinline__ double lane_max(double m, double* maxima, Exchange& ex, int K,
                                           int rank) {
  double* warp_max = maxima;
  double* cta_max = maxima + 32;
  const int warp = threadIdx.x >> 5;
  for (int o = 16; o > 0; o >>= 1) m = fmax(m, __shfl_xor_sync(0xffffffffu, m, o));
  if ((threadIdx.x & 31) == 0) warp_max[warp] = m;
  __syncthreads();
  if (warp == 0) {
    m = threadIdx.x < (blockDim.x >> 5) ? warp_max[threadIdx.x] : -INFINITY;
    for (int o = 16; o > 0; o >>= 1) m = fmax(m, __shfl_xor_sync(0xffffffffu, m, o));
    if (threadIdx.x == 0 && rank > 0) {
      asm volatile("st.shared::cluster.f64 [%0], %1;"
                   :: "r"(map_to(smem_u32(cta_max + rank), 0)), "d"(m) : "memory");
    }
  }
  if (K > 1) {
    ex.sync();
    if (rank == 0 && threadIdx.x == 0)
      for (int r = 1; r < K; ++r) m = fmax(m, cta_max[r]);
  }
  return m;
}

// max(f, a) as a compare and a select: the clocks are finite, so this is
// the plain version's maximum, in fewer instructions than fmax (which also
// orders NaNs).
__device__ __forceinline__ double later(double f, double a) { return a > f ? a : f; }

// The trains in registers: C = kC chunks a slot (a power of two; C is a
// template argument so that the train's registers are indexed only by
// constants), kSlots slots a thread.  Within a hop the kSlots chains of a
// thread run interleaved (chunk-major).
template <int kC, int kSlots>
__global__ void __launch_bounds__(kRegThreads) playback_reg_kernel(const Tape t) {
  extern __shared__ double smem[];
  const int K = t.K, L = t.L, n = t.n, T = blockDim.x, tid = threadIdx.x;
  const int rank = static_cast<int>(blockIdx.x) % K;
  const int lane = t.order[blockIdx.x / K];
  const int first = rank * L;
  const int len = max(0, min(L, n - first));
  Exchange ex(smem, L, len, K);
  double* maxima = smem + 2 * L;
  const double de = t.delta_eff[lane];
  double a[kSlots][kC];  // each slot's train: its chunks' arrivals at its next port
  uint32_t tgt[kSlots];
#pragma unroll
  for (int i = 0; i < kSlots; ++i) {
    if (tid + i * T < len) ex.buf[tid + i * T] = 0.0;
    tgt[i] = 0;
#pragma unroll
    for (int c = 0; c < kC; ++c) a[i][c] = 0.0;
  }
  int par = 0;     // the buffer holding the clocks the next hop reads
  int off = 0;     // slot s holds port (s + off) mod n
  bool played = false;  // a hop has run: recv is the trains' last chunk, else 0
  double done = 0.0;    // step_done of the last step (at rank 0's thread 0)
  ex.start();
  for (int k = 0; k < t.S; ++k) {
    const int64_t at = static_cast<int64_t>(lane) * t.S + k;
    const Step st = read_step(t, at);
    if (st.hops <= 0) {  // the boundary charges even a step with no hops
      if (st.changed) {
#pragma unroll
        for (int i = 0; i < kSlots; ++i)
          if (tid + i * T < len)
            ex.buf[par * L + tid + i * T] = __dadd_rn(ex.buf[par * L + tid + i * T], de);
      }
      if (rank == 0 && tid == 0) t.step_done[at] = done;
      continue;
    }
#pragma unroll
    for (int i = 0; i < kSlots; ++i) {  // hop 0's arrivals: the injection
      const double inj = __dadd_rn(played ? a[i][kC - 1] : 0.0, t.alpha_s);
#pragma unroll
      for (int c = 0; c < kC; ++c) a[i][c] = inj;
      tgt[i] = target_of(first + tid + i * T, st.g, n, L);
    }
    for (int j = 0; j < st.hops; ++j) {
      const int fill = par ^ 1;
      if (tid == 0) ex.expect(fill);
      double f[kSlots];
#pragma unroll
      for (int i = 0; i < kSlots; ++i) {
        f[i] = tid + i * T < len ? ex.buf[par * L + tid + i * T] : 0.0;
        if (j == 0 && st.changed) f[i] = __dadd_rn(f[i], de);
      }
#pragma unroll
      for (int c = 0; c < kC; ++c) {
#pragma unroll
        for (int i = 0; i < kSlots; ++i) {
          f[i] = __dadd_rn(later(f[i], a[i][c]), st.tau);
          a[i][c] = f[i];
        }
      }
      ex.ready_to_push();
#pragma unroll
      for (int i = 0; i < kSlots; ++i)
        if (tid + i * T < len) ex.push(fill, tgt[i], f[i]);
      ex.arrive();
#pragma unroll
      for (int i = 0; i < kSlots; ++i)
#pragma unroll
        for (int c = 0; c < kC; ++c) a[i][c] = __dadd_rn(a[i][c], t.alpha_h);
      ex.wait(fill);
      par = fill;
    }
    played = true;
    off = static_cast<int>((off + static_cast<int64_t>(st.hops) * st.g) % n);
    double m = -INFINITY;
#pragma unroll
    for (int i = 0; i < kSlots; ++i)
      if (tid + i * T < len) m = fmax(m, a[i][kC - 1]);
    m = lane_max(m, maxima, ex, K, rank);
    if (rank == 0 && tid == 0) t.step_done[at] = done = m;
  }
#pragma unroll
  for (int i = 0; i < kSlots; ++i) {  // the ports in order
    if (tid + i * T < len) {
      int p = first + tid + i * T + off;
      p -= p >= n ? n : 0;
      t.node_done[static_cast<int64_t>(lane) * n + p] = played ? a[i][kC - 1] : 0.0;
      t.port_free[static_cast<int64_t>(lane) * n + p] = ex.buf[par * L + tid + i * T];
    }
  }
  ex.sync();  // no CTA leaves while a peer may still push into it
}

// The trains in memory, chunk-major a CTA (train of slot l: comp[c * L + l]),
// in the CTA's shared memory or its own block of the device workspace; only
// the owning thread touches them.  Any C; the slots of a thread in turn,
// each served by the parent's chain.
__global__ void __launch_bounds__(kMemThreads) playback_mem_kernel(const Tape t) {
  extern __shared__ double smem[];
  const int K = t.K, L = t.L, n = t.n, C = t.C, T = blockDim.x, tid = threadIdx.x;
  const int rank = static_cast<int>(blockIdx.x) % K;
  const int lane = t.order[blockIdx.x / K];
  const int first = rank * L;
  const int len = max(0, min(L, n - first));
  Exchange ex(smem, L, len, K);
  double* maxima = smem + 2 * L;
  double* comp = t.comp_in_smem ? smem + 2 * L + kScratch
                                : t.comp + static_cast<int64_t>(blockIdx.x) * C * L;
  const double de = t.delta_eff[lane];
  for (int l = tid; l < len; l += T) ex.buf[l] = 0.0;
  int par = 0, off = 0;
  bool played = false;
  double done = 0.0;
  ex.start();
  for (int k = 0; k < t.S; ++k) {
    const int64_t at = static_cast<int64_t>(lane) * t.S + k;
    const Step st = read_step(t, at);
    if (st.hops <= 0) {
      if (st.changed)
        for (int l = tid; l < len; l += T) ex.buf[par * L + l] = __dadd_rn(ex.buf[par * L + l], de);
      if (rank == 0 && tid == 0) t.step_done[at] = done;
      continue;
    }
    for (int l = tid; l < len; l += T) {
      const double inj = __dadd_rn(played ? comp[(C - 1) * L + l] : 0.0, t.alpha_s);
      for (int c = 0; c < C; ++c) comp[c * L + l] = inj;
    }
    for (int j = 0; j < st.hops; ++j) {
      const int fill = par ^ 1;
      if (tid == 0) ex.expect(fill);
      ex.ready_to_push();
      for (int l = tid; l < len; l += T) {
        double f = ex.buf[par * L + l];
        if (j == 0 && st.changed) f = __dadd_rn(f, de);
        for (int c = 0; c < C; ++c) {
          f = __dadd_rn(later(f, comp[c * L + l]), st.tau);
          comp[c * L + l] = f;
        }
        ex.push(fill, target_of(first + l, st.g, n, L), f);
      }
      ex.arrive();
      for (int l = tid; l < len; l += T)
        for (int c = 0; c < C; ++c) comp[c * L + l] = __dadd_rn(comp[c * L + l], t.alpha_h);
      ex.wait(fill);
      par = fill;
    }
    played = true;
    off = static_cast<int>((off + static_cast<int64_t>(st.hops) * st.g) % n);
    double m = -INFINITY;
    for (int l = tid; l < len; l += T) m = fmax(m, comp[(C - 1) * L + l]);
    m = lane_max(m, maxima, ex, K, rank);
    if (rank == 0 && tid == 0) t.step_done[at] = done = m;
  }
  for (int l = tid; l < len; l += T) {
    int p = first + l + off;
    p -= p >= n ? n : 0;
    t.node_done[static_cast<int64_t>(lane) * n + p] = played ? comp[(C - 1) * L + l] : 0.0;
    t.port_free[static_cast<int64_t>(lane) * n + p] = ex.buf[par * L + l];
  }
  ex.sync();
}

using KernelFn = void (*)(Tape);

// The kernel of (comp_mode, C), its slots a thread (0: any) and its index,
// or null: 0 the register kernels by C (slots a thread as the wrapper's
// REG_SLOTS), 1 and 2 the memory kernel.  A launch above a kernel's launch
// bound is refused.
struct Variant {
  KernelFn fn;
  int spt, index;
};

Variant variant(int comp_mode, int C) {
  if (comp_mode == 1 || comp_mode == 2) return {playback_mem_kernel, 0, 5};
  if (comp_mode != 0) return {nullptr, 0, -1};
  switch (C) {
    case 1: return {playback_reg_kernel<1, 8>, 8, 0};
    case 2: return {playback_reg_kernel<2, 8>, 8, 1};
    case 4: return {playback_reg_kernel<4, 8>, 8, 2};
    case 8: return {playback_reg_kernel<8, 4>, 4, 3};
    case 16: return {playback_reg_kernel<16, 2>, 2, 4};
    default: return {nullptr, 0, -1};
  }
}

// The kernels' attributes (the shared-memory limit, clusters of up to 16),
// set once per kernel and device.
std::atomic<unsigned long long> attributes_set[6];

cudaError_t prepare(const Variant& v) {
  return launch::max_dynamic_smem_once(attributes_set[v.index],
                                       reinterpret_cast<const void*>(v.fn), kSmemLimit,
                                       /*max_carveout=*/false, /*large_clusters=*/true);
}

// A launch of `blocks` CTAs in clusters of `cluster` (a lane of one CTA is
// a cluster of one: the kernels use the cluster's barrier and mbarriers).
cudaLaunchConfig_t lane_config(int blocks, int cluster, int threads, int smem,
                               cudaStream_t stream, cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = cluster;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

}  // namespace

// nb (B, S) float64, g_step and hops (B, S) int32, changed (B, S) uint8,
// delta_eff (B,) float64, order (B,) int32 (the launch order of the lanes),
// all contiguous on one device; the layout (cluster, slots, threads, spt,
// comp_mode 0 registers / 1 shared / 2 global, smem_bytes) is the wrapper's
// `launch_plan`.  Writes node_done (B, n), step_done (B, S)
// and port_free (B, n) float64 in lane order; comp is the workspace of
// comp_mode 2 (B * cluster * C * slots float64), else unused.  Launches on
// `stream` and returns the cudaError_t (0 on success): a layout that does
// not cover the lane is refused before the launch, and the launch itself
// refuses a cluster it cannot place or shared memory beyond the limit.
extern "C" int fabric_playback(const void* nb, const void* g_step, const void* hops,
                               const void* changed, const void* delta_eff, const void* order,
                               double alpha_s, double alpha_h, double beta, int batch, int n,
                               int C, int S, int cluster, int slots, int threads, int spt,
                               int comp_mode, int smem_bytes, void* node_done,
                               void* step_done, void* port_free, void* comp, void* stream) {
  if (batch == 0) return 0;
  const Variant v = variant(comp_mode, C);
  const long long need = 8LL * (2LL * slots + kScratch) + (comp_mode == 1 ? 8LL * C * slots : 0);
  if (v.fn == nullptr || n < 1 || C < 1 || cluster < 1 || slots < 1 || slots >= 65536 ||
      threads < 32 || threads % 32 != 0 || spt < 1 || (v.spt && spt != v.spt) ||
      static_cast<long long>(slots) * cluster < n ||
      static_cast<long long>(threads) * spt < slots || smem_bytes < need || static_cast<long long>(batch) * cluster >= (1LL << 31) ||
      (comp_mode == 2 && comp == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = prepare(v);
  if (err != cudaSuccess) {
    cudaGetLastError();  // a refused call leaves no error behind for the next one to report
    return static_cast<int>(err);
  }
  const Tape t{static_cast<const double*>(nb), static_cast<const int*>(g_step),
               static_cast<const int*>(hops), static_cast<const uint8_t*>(changed),
               static_cast<const double*>(delta_eff), static_cast<const int*>(order),
               alpha_s, alpha_h, beta, n, C, S, cluster, slots, comp_mode == 1,
               static_cast<double*>(node_done), static_cast<double*>(step_done),
               static_cast<double*>(port_free), static_cast<double*>(comp)};
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = lane_config(batch * cluster, cluster, threads, smem_bytes,
                                             static_cast<cudaStream_t>(stream), &attr);
  err = cudaLaunchKernelEx(&cfg, v.fn, t);
  const cudaError_t last = cudaGetLastError();  // and clears a refused launch's error
  return static_cast<int>(err != cudaSuccess ? err : last);
}

// How many clusters of the layout (cluster, threads, comp_mode, C,
// smem_bytes) the device holds at once, into *out.  Returns the cudaError_t.
extern "C" int fabric_playback_max_clusters(int cluster, int threads, int comp_mode, int C,
                                            int smem_bytes, int* out) {
  const Variant v = variant(comp_mode, C);
  if (v.fn == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = prepare(v);
  if (err == cudaSuccess) {
    cudaLaunchAttribute attr;
    const cudaLaunchConfig_t cfg =
        lane_config(cluster, cluster, threads, smem_bytes, nullptr, &attr);
    err = cudaOccupancyMaxActiveClusters(out, v.fn, &cfg);
  }
  cudaGetLastError();
  return static_cast<int>(err);
}
