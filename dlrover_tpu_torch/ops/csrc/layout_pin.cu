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
// once.  What the design does about it: a contiguous, 16-byte-aligned
// input (the transformer block's case) is copied 16 bytes a thread in a
// grid-stride loop; any other input goes element by element, the thread
// of an output element finding its source through the input's strides (up
// to 4 dims; the wrapper merges what it can).  The TPU kernel's search
// for a 4 MiB block is gone.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int MAX_BLOCKS = 132 * 16;

__global__ void __launch_bounds__(THREADS)
copy_vec_kernel(const uint4* __restrict__ src, uint4* __restrict__ dst,
                long long n_vec) {
  const long long stride = static_cast<long long>(gridDim.x) * THREADS;
  for (long long i = static_cast<long long>(blockIdx.x) * THREADS +
                     threadIdx.x;
       i < n_vec; i += stride) {
    dst[i] = src[i];
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

inline unsigned grid_for(long long n) {
  const long long blocks = (n + THREADS - 1) / THREADS;
  return static_cast<unsigned>(blocks < MAX_BLOCKS ? blocks : MAX_BLOCKS);
}

template <typename U>
int launch_strided(const void* src, void* dst, long long n, const Dims& d,
                   cudaStream_t s) {
  copy_strided_kernel<U><<<grid_for(n), THREADS, 0, s>>>(
      static_cast<const U*>(src), static_cast<U*>(dst), n, d);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// K11.  src: a view of sizes[4] elements of elem_bytes (1, 2, 4 or 8) with
// strides[4] in elements (leading dims of size 1 pad a lower rank); dst:
// the same elements, contiguous in row-major order.  `contiguous` says that
// src is itself dense row-major, and both pointers 16-byte aligned.
// Returns cudaGetLastError() after the launch (0 = ok).
extern "C" int pin_copy(const void* src, void* dst, const long long* sizes,
                        const long long* strides, int elem_bytes,
                        int contiguous, void* stream) {
  Dims d;
  long long n = 1;
  for (int k = 0; k < 4; ++k) {
    if (sizes[k] <= 0) return static_cast<int>(cudaErrorInvalidValue);
    d.size[k] = sizes[k];
    d.stride[k] = strides[k];
    n *= sizes[k];
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long bytes = n * elem_bytes;
  if (contiguous && bytes % 16 == 0) {
    const long long n_vec = bytes / 16;
    copy_vec_kernel<<<grid_for(n_vec), THREADS, 0, s>>>(
        static_cast<const uint4*>(src), static_cast<uint4*>(dst), n_vec);
    return static_cast<int>(cudaGetLastError());
  }
  switch (elem_bytes) {
    case 1: return launch_strided<uint8_t>(src, dst, n, d, s);
    case 2: return launch_strided<uint16_t>(src, dst, n, d, s);
    case 4: return launch_strided<uint32_t>(src, dst, n, d, s);
    case 8: return launch_strided<uint64_t>(src, dst, n, d, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
