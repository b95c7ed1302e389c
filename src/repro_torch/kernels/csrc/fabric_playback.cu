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
// What bounds it on the H100.  Each lane is a serial chain: every hop's
// arrivals are the previous hop's completions on another port, so a CTA
// waits at a barrier a hop, and each port's chunks depend one on the next.
// The float64 work (a max and an add a chunk service, n * C * sum(hops)
// services a lane) at the FP64 peak, and that chain (sum(hops) * C dependent
// max-and-add pairs plus a barrier a hop), are the two bounds chip_smoke.py
// prints; the bytes (the tapes in, three float64 arrays out) bound nothing.
//
// Design.  One CTA a lane; its threads stride over the n ports, so each
// thread owns the same ports in every hop and keeps their F and recv in the
// lane's rows of port_free and node_done (global, B x n) without a barrier.
// comp lives in a double-buffered global workspace (B x 2 x C x n): hop j
// writes buffer j & 1 and gathers from the other, so one __syncthreads() a
// hop separates both the reads after writes and the writes after reads.
// Each CTA walks its own lane's hop counts: there is no padding to the
// longest lane, which is what the reference's hop bucketing was for.  A
// block max reduction gives step_done.  Simple, and right first: at n =
// 32768 the 32 lanes of the reference's grid fill 32 of 132 SMs, and comp
// is read from L2 rather than shared memory (ROADMAP B lists both).
//
// Bit-exactness with NumPy's `_play` and the XLA kernel.  The arithmetic is
// written with __ddiv_rn, __dmul_rn and __dadd_rn, which nvcc never
// contracts into an FMA (the shared build flags keep -fmad=true for the
// other kernels); max is exact in any order.  The scalars come in as
// doubles.  The gather index is Python's modulo for any int g: g is reduced
// to [0, n) once a step and p - g wrapped by one add.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 1024;

__global__ void __launch_bounds__(kMaxThreads)
fabric_playback_kernel(const double* __restrict__ nb, const int* __restrict__ g_step,
                       const int* __restrict__ hops, const uint8_t* __restrict__ changed,
                       const double* __restrict__ delta_eff, double alpha_s, double alpha_h,
                       double beta, int n, int C, int S, double* __restrict__ node_done,
                       double* __restrict__ step_done, double* __restrict__ port_free,
                       double* __restrict__ comp) {
  const int64_t lane = blockIdx.x;
  double* F = port_free + lane * n;
  double* recv = node_done + lane * n;
  double* ws = comp + lane * 2 * C * static_cast<int64_t>(n);
  const int64_t buf = static_cast<int64_t>(C) * n;
  const double de = delta_eff[lane];
  __shared__ double warp_max[kMaxThreads / 32];

  for (int p = threadIdx.x; p < n; p += blockDim.x) {
    F[p] = 0.0;
    recv[p] = 0.0;
  }
  int par = 0;  // the buffer the next hop writes
  for (int k = 0; k < S; ++k) {
    const int64_t at = lane * S + k;
    const bool chk = changed[at] != 0;
    const int hk = hops[at];
    const int gk = ((g_step[at] % n) + n) % n;
    const double tau = __dmul_rn(__ddiv_rn(nb[at], static_cast<double>(C)), beta);
    for (int j = 0; j < hk; ++j) {
      double* cur = ws + par * buf;
      const double* prev = ws + (par ^ 1) * buf;
      for (int p = threadIdx.x; p < n; p += blockDim.x) {
        double f = F[p];
        if (j == 0) {
          if (chk) f = __dadd_rn(f, de);
          const double inj = __dadd_rn(recv[p], alpha_s);
          for (int c = 0; c < C; ++c) {
            f = __dadd_rn(fmax(f, inj), tau);
            cur[c * static_cast<int64_t>(n) + p] = f;
          }
        } else {
          int q = p - gk;
          q += q < 0 ? n : 0;
          for (int c = 0; c < C; ++c) {
            const double a = __dadd_rn(prev[c * static_cast<int64_t>(n) + q], alpha_h);
            f = __dadd_rn(fmax(f, a), tau);
            cur[c * static_cast<int64_t>(n) + p] = f;
          }
        }
        F[p] = f;
      }
      __syncthreads();
      par ^= 1;
    }
    if (hk <= 0 && chk) {  // the boundary charges even a step with no hops
      for (int p = threadIdx.x; p < n; p += blockDim.x) F[p] = __dadd_rn(F[p], de);
    }
    double m = -INFINITY;
    const double* last = ws + (par ^ 1) * buf + (C - 1) * static_cast<int64_t>(n);
    for (int p = threadIdx.x; p < n; p += blockDim.x) {
      if (hk > 0) {
        int q = p - gk;
        q += q < 0 ? n : 0;
        recv[p] = __dadd_rn(last[q], alpha_h);
      }
      m = fmax(m, recv[p]);
    }
    for (int off = 16; off > 0; off >>= 1) m = fmax(m, __shfl_xor_sync(0xffffffffu, m, off));
    if ((threadIdx.x & 31) == 0) warp_max[threadIdx.x >> 5] = m;
    __syncthreads();
    if (threadIdx.x == 0) {
      for (int w = 1; w < static_cast<int>(blockDim.x >> 5); ++w) m = fmax(m, warp_max[w]);
      step_done[at] = m;
    }
    __syncthreads();  // warp_max is written again next step
  }
}

}  // namespace

// nb (B, S) float64, g_step and hops (B, S) int32, changed (B, S) uint8,
// delta_eff (B,) float64, all contiguous on one device.  Writes node_done
// (B, n), step_done (B, S) and port_free (B, n) float64, using comp
// (B, 2, C, n) float64 as scratch.  Launches on `stream` and returns the
// launch's cudaError_t (0 on success).
extern "C" int fabric_playback(const void* nb, const void* g_step, const void* hops,
                               const void* changed, const void* delta_eff, double alpha_s,
                               double alpha_h, double beta, int batch, int n, int C, int S,
                               void* node_done, void* step_done, void* port_free, void* comp,
                               void* stream) {
  if (batch == 0) return 0;
  int threads = (n + 31) / 32 * 32;
  threads = threads < 32 ? 32 : (threads > kMaxThreads ? kMaxThreads : threads);
  fabric_playback_kernel<<<batch, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const double*>(nb), static_cast<const int*>(g_step),
      static_cast<const int*>(hops), static_cast<const uint8_t*>(changed),
      static_cast<const double*>(delta_eff), alpha_s, alpha_h, beta, n, C, S,
      static_cast<double*>(node_done), static_cast<double*>(step_done),
      static_cast<double*>(port_free), static_cast<double*>(comp));
  return static_cast<int>(cudaGetLastError());
}
