// Host-side launch helpers shared by the kernel sources.
#pragma once

#include <cuda_runtime.h>

#include <atomic>

namespace launch {

// Raises a kernel's dynamic shared-memory limit to `bytes` once per device
// (and, with `max_carveout`, asks for the largest shared-memory share of the
// SM's L1, so that as many CTAs fit as the limit allows; with
// `large_clusters`, allows thread-block clusters above the portable 8 CTAs,
// up to 16 on an H100).  `done` is the caller's function-local static (one
// per kernel instantiation), one bit per device: cudaFuncSetAttribute then
// costs its host time on a kernel's first launch on a device, not on every
// launch.
inline cudaError_t max_dynamic_smem_once(std::atomic<unsigned long long>& done,
                                         const void* kernel, int bytes,
                                         bool max_carveout = false,
                                         bool large_clusters = false) {
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  const unsigned long long bit = 1ull << (device & 63);
  if (done.load(std::memory_order_acquire) & bit) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess && max_carveout) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  }
  if (err == cudaSuccess && large_clusters) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  }
  if (err == cudaSuccess) done.fetch_or(bit, std::memory_order_release);
  return err;
}

}  // namespace launch
