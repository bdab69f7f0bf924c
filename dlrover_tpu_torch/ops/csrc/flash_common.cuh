// Device helpers of the split flash-attention backward's dq kernel (K2a in
// flash_attention_bwd.cu): the 64-row tile geometry, strided tile loads
// into padded shared memory and warp reductions; for every flash kernel,
// the -1e30 of a fully masked row; and, for every kernel that takes more
// than 48 KB of shared memory (the grouped GEMMs too), the once-per-device
// opt-in.  K1, K2b and K3 take their Hopper pieces from
// flash_hopper.cuh.
//
// kernel_lib hashes every header in csrc/ into each library's name, so a
// change here rebuilds both kernels.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace flash {

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

constexpr int BLOCK_M = 64;  // q rows per tile
constexpr int BLOCK_N = 64;  // kv rows per tile
constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;
constexpr int ROWS_PER_WARP = BLOCK_M / WARPS;  // 16: one wmma row tile
constexpr float NEG_INF = -1e30f;

// Copy rows [row0, row0 + ROWS) of a [rows, D] strided view into a shared
// tile with leading dimension LD, 16 bytes per thread per step; rows past
// n_rows are zeroed (a masked probability times a garbage value could
// still give NaN in a product).
template <int D, int ROWS, int LD>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src,
                                          long long row_stride, int row0,
                                          int n_rows, int tid) {
  constexpr int VEC = D / 8;
  for (int i = tid; i < ROWS * VEC; i += THREADS) {
    const int r = i / VEC;
    const int c = (i % VEC) * 8;
    const int gr = row0 + r;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (gr < n_rows) {
      val = *reinterpret_cast<const uint4*>(src + gr * row_stride + c);
    }
    *reinterpret_cast<uint4*>(dst + r * LD + c) = val;
  }
}

__device__ __forceinline__ float warp_max(float x) {
  for (int off = 16; off > 0; off >>= 1) {
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  }
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
  for (int off = 16; off > 0; off >>= 1) {
    x += __shfl_xor_sync(0xffffffffu, x, off);
  }
  return x;
}

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
