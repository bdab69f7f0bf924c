// Host and device constants shared by the port's kernels: the -1e30 lse of
// a fully masked attention row (K1), and, for every kernel that takes more
// than 48 KB of shared memory (the flash kernels, the grouped GEMMs and the
// fused norm backward), the once-per-device opt-in.  The Hopper pieces
// (TMA, mbarriers, wgmma) are in flash_hopper.cuh.
//
// kernel_lib hashes every header in csrc/ into each library's name, so a
// change here rebuilds every kernel.

#pragma once

#include <cuda_runtime.h>

namespace flash {

constexpr float NEG_INF = -1e30f;

// Above 48 KB of dynamic shared memory a kernel needs an opt-in, once per
// device: kept out of the per-launch path, and so out of CUDA graph
// capture.  `done` is the caller's per-kernel flag array.
template <typename Kernel>
inline cudaError_t opt_in_smem(Kernel kernel, size_t bytes, bool* done) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 64 && done[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(bytes));
  if (err == cudaSuccess && dev < 64) done[dev] = true;
  return err;
}

}  // namespace flash
