// Identity copy into the dense row-major layout on Hopper (sm_90a).
//
// Replaces the TPU kernel of dlrover_tpu/ops/layout_pin.py:
//   K11 _identity_kernel  out = x, block by block, so that the result has
//       the default row-major layout whatever layout x had.
// On the TPU the call was a layout firewall for the compiler; PyTorch has
// no layout assignment to fight, so what the port keeps is the function:
// a strided view in, a contiguous tensor out, bit for bit.
//
// What bounds it on this card: bytes, each element read once and written
// once (the transformer block's [16, 1024, 1600] bf16: 104.9 MB moved,
// 0.0313 ms at 3.35 TB/s).  What the design does about it, for a dense,
// 16-byte-aligned input (the block's case): the blocks of the host plan
// (ops/layout_pin.pin_launch_plan) sweep the tensor together in steps of
// THREADS * UNROLL 16-byte vectors, block b taking every gridDim.x-th
// step, and a thread issues its UNROLL loads before its stores, so each SM
// keeps many bytes in flight.  Tried and slower on an H100 (PERF.md): one
// contiguous chunk a block, fewer blocks than the SMs oversubscribed,
// streaming or non-coherent cache hints, and a shared-memory ring of TMA
// bulk copies.  Any other input goes element by element, the thread of an
// output element finding its source through the input's strides (up to 4
// dims; the wrapper merges what it can).  The TPU kernel's search for a
// 4 MiB block is gone.

#include <cuda_runtime.h>
#include <stdint.h>

// ops/layout_pin.py PinPlan, field for field (outside the unnamed
// namespace: the C entry takes it, and must keep its external name).
struct PinPlan {
  long long route;   // 0 strided, 1 vectors
  long long blocks;  // the grid
  long long unroll;  // route 1: loads a thread issues before its stores
};

namespace {

constexpr int THREADS = 256;
constexpr int UNROLL = 8;

__global__ void __launch_bounds__(THREADS)
copy_vec_kernel(const uint4* __restrict__ src, uint4* __restrict__ dst,
                long long n_vec) {
  constexpr long long STEP = static_cast<long long>(THREADS) * UNROLL;
  const long long stride = STEP * gridDim.x;
  for (long long i = blockIdx.x * STEP + threadIdx.x; i < n_vec;
       i += stride) {
    uint4 r[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const long long j = i + u * THREADS;
      if (j < n_vec) r[u] = src[j];
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const long long j = i + u * THREADS;
      if (j < n_vec) dst[j] = r[u];
    }
  }
}

struct Dims {
  long long size[4];
  long long stride[4];  // in elements
};

template <typename U>
__global__ void __launch_bounds__(THREADS)
copy_strided_kernel(const U* __restrict__ src, U* __restrict__ dst,
                    long long n, Dims d) {
  const long long step = static_cast<long long>(gridDim.x) * THREADS;
  for (long long i = static_cast<long long>(blockIdx.x) * THREADS +
                     threadIdx.x;
       i < n; i += step) {
    long long rest = i, off = 0;
#pragma unroll
    for (int k = 3; k >= 0; --k) {
      const long long idx = rest % d.size[k];
      rest /= d.size[k];
      off += idx * d.stride[k];
    }
    dst[i] = src[off];
  }
}

template <typename U>
int launch_strided(const void* src, void* dst, long long n, const Dims& d,
                   unsigned blocks, cudaStream_t s) {
  copy_strided_kernel<U><<<blocks, THREADS, 0, s>>>(
      static_cast<const U*>(src), static_cast<U*>(dst), n, d);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// K11.  src: a view of sizes[4] elements of elem_bytes (1, 2, 4 or 8) with
// strides[4] in elements (leading dims of size 1 pad a lower rank); dst:
// the same elements, contiguous in row-major order.  plan: the host plan
// (route 1 only for a dense row-major src whose bytes are a multiple of
// 16, both pointers 16-byte aligned); a plan the kernels are not built for
// is refused.  Returns cudaGetLastError() after the launch (0 = ok).
extern "C" int pin_copy(const void* src, void* dst, const long long* sizes,
                        const long long* strides, int elem_bytes,
                        const PinPlan* plan, void* stream) {
  constexpr int kInvalid = static_cast<int>(cudaErrorInvalidValue);
  Dims d;
  long long n = 1;
  for (int k = 0; k < 4; ++k) {
    if (sizes[k] <= 0) return kInvalid;
    d.size[k] = sizes[k];
    d.stride[k] = strides[k];
    n *= sizes[k];
  }
  if (plan->blocks < 1 || plan->blocks > 0x7fffffffll) return kInvalid;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long bytes = n * elem_bytes;
  if (plan->route == 1) {
    if (bytes % 16 != 0 || plan->unroll != UNROLL) return kInvalid;
    copy_vec_kernel<<<static_cast<unsigned>(plan->blocks), THREADS, 0, s>>>(
        static_cast<const uint4*>(src), static_cast<uint4*>(dst), bytes / 16);
    return static_cast<int>(cudaGetLastError());
  }
  if (plan->route != 0) return kInvalid;
  const unsigned blocks = static_cast<unsigned>(plan->blocks);
  switch (elem_bytes) {
    case 1: return launch_strided<uint8_t>(src, dst, n, d, blocks, s);
    case 2: return launch_strided<uint16_t>(src, dst, n, d, blocks, s);
    case 4: return launch_strided<uint32_t>(src, dst, n, d, blocks, s);
    case 8: return launch_strided<uint64_t>(src, dst, n, d, blocks, s);
    default: return kInvalid;
  }
}
