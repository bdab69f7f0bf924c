// Per-leaf raw-byte sums of a train state on Hopper (sm_90a): the device
// half of the silent-data-corruption digest (trainer/state_digest.py).
//
// Replaces the reference's jit-fused reduction of
// dlrover_tpu/trainer/state_digest.py:39 (_leaf_sum: each leaf's raw bits
// summed), which XLA fuses into one pass; it is no Pallas kernel.  The
// port's plain version sums 128-byte rows widened to int16, a launch for
// each large leaf, and reads the widened copy back (about 12 ms for the
// 3.37 GB GPT-2 1.5B state, against a 1 ms bound).
//
// One launch covers every leaf.  The host lays the leaves out as chunks of
// at most CHUNK_BYTES (a table of (address, bytes, leaf)); each block walks
// the chunks grid-stride, each thread adds its 16-byte words with __vsadu4
// (a word's four bytes summed) and the bytes before the first 16-byte
// boundary and after the last one one at a time; the block reduces in 64
// bits and adds its total to its leaf's sum with one atomicAdd.  The sums
// are integers, so the order of the additions does not change them: two
// runs are bit-equal.  Bound: bytes, each byte read once.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;

struct Chunk {
  unsigned long long addr;  // first byte
  long long nbytes;         // at most the host's chunk size
  long long leaf;           // index into sums
};

__device__ __forceinline__ unsigned word_sum(unsigned w) {
  return __vsadu4(w, 0u);
}

__global__ void __launch_bounds__(THREADS)
byte_sums_kernel(const Chunk* __restrict__ chunks, long long n_chunks,
                 unsigned long long* __restrict__ sums) {
  __shared__ unsigned long long part[THREADS / 32];
  for (long long c = blockIdx.x; c < n_chunks; c += gridDim.x) {
    const Chunk ch = chunks[c];
    const unsigned char* p = reinterpret_cast<const unsigned char*>(ch.addr);
    long long head = static_cast<long long>((16 - (ch.addr & 15)) & 15);
    if (head > ch.nbytes) head = ch.nbytes;
    const long long words = (ch.nbytes - head) / 16;
    unsigned long long acc = 0;
    for (long long i = threadIdx.x; i < head; i += THREADS) acc += p[i];
    const uint4* v = reinterpret_cast<const uint4*>(p + head);
    for (long long i = threadIdx.x; i < words; i += THREADS) {
      const uint4 w = v[i];
      acc += word_sum(w.x) + word_sum(w.y) + word_sum(w.z) + word_sum(w.w);
    }
    for (long long i = head + words * 16 + threadIdx.x; i < ch.nbytes;
         i += THREADS) {
      acc += p[i];
    }
    for (int o = 16; o > 0; o >>= 1) {
      acc += __shfl_down_sync(0xffffffffu, acc, o);
    }
    if ((threadIdx.x & 31) == 0) part[threadIdx.x >> 5] = acc;
    __syncthreads();
    if (threadIdx.x == 0) {
      unsigned long long total = 0;
      for (int w = 0; w < THREADS / 32; ++w) total += part[w];
      if (total) atomicAdd(sums + ch.leaf, total);
    }
    __syncthreads();
  }
}

}  // namespace

// sums[leaf] += the bytes of every chunk of that leaf.  ``chunks`` and
// ``sums`` are device pointers (``sums`` zeroed by the caller); ``grid``
// blocks walk the chunks.  Returns a cudaError_t.
extern "C" int leaf_byte_sums(const void* chunks, long long n_chunks,
                              void* sums, int grid, void* stream) {
  if (n_chunks < 0 || grid <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n_chunks == 0) return 0;
  byte_sums_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const Chunk*>(chunks), n_chunks,
      static_cast<unsigned long long*>(sums));
  return static_cast<int>(cudaGetLastError());
}
