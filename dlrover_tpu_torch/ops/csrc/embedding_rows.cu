// Row gather and row scatter of the embedding plane's hot-row cache on
// Hopper (sm_90a).
//
// Replaces the TPU kernels of dlrover_tpu/embedding/kernels.py:
//   K10a _gather_kernel   out[i] = cache[slots[i]]
//   K10b _scatter_kernel  cache[slots[i]] = rows[i], the cache aliased in
//        place (input_output_aliases on the TPU).
// On the TPU each grid step DMAs one (1, dim) row block, the slots arriving
// by scalar prefetch.  Here each kernel is a plain GPU copy: a group of
// threads (a warp, or a quarter-warp for rows narrower than 128 values)
// owns one row at a time and walks the rows grid-stride; it reads its
// slot itself (int32) and copies the row 16 bytes a thread when dim % 4 ==
// 0 and both base pointers are 16-byte aligned, 4 bytes a thread otherwise
// (dim 129 works).  Rows are fp32, as the cache holds them.
//
// What bounds them on this card: bytes (each row read once and written
// once, 4 bytes of slot per row).  At the training loop's shape (32,768
// slots of 128 values) that is about 34 MB, some 10 us at 3.35 TB/s, so a
// launch's fixed cost is as large as the copy itself.
//
// K10b: duplicate targets occur only at the scratch slot 0, and the rows
// written there are identical (the cache pads with zero rows), so two
// threads writing slot 0 write the same bytes: no ordering is needed.
// Of a run of equal consecutive slots only the last row is written: the
// padded tail (some 15,000 rows at slot 0 in the training loop) costs one
// row's write instead of 15,000 writes to the same 512 bytes, which
// serialized in L2 and made the first version 4.5x its bound.  Where
// consecutive duplicates differ, the last one wins.
// Slots are range-checked by the caller on the host before the upload.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr long long MAX_BLOCKS = 132 * 16;

// dst[i] = src[idx[i]] row by row (gather), or dst[idx[i]] = src[i]
// (scatter).  T is float4 or float; width is the row's length in T.
template <typename T, bool SCATTER>
__global__ void __launch_bounds__(THREADS)
copy_rows_kernel(const T* __restrict__ src, const int* __restrict__ idx,
                 T* __restrict__ dst, long long n, int width, int tpr) {
  const long long t = static_cast<long long>(blockIdx.x) * THREADS +
                      threadIdx.x;
  const int lane = static_cast<int>(t % tpr);
  const long long groups = static_cast<long long>(gridDim.x) * THREADS / tpr;
  for (long long i = t / tpr; i < n; i += groups) {
    // Scatter: of a run of equal consecutive slots only the last row is
    // written (the padded tail's rows all target slot 0).
    if (SCATTER && i + 1 < n && idx[i + 1] == idx[i]) continue;
    const long long slot = static_cast<long long>(idx[i]) * width;
    const long long row = i * width;
    const T* s = src + (SCATTER ? row : slot);
    T* d = dst + (SCATTER ? slot : row);
    for (int c = lane; c < width; c += tpr) d[c] = s[c];
  }
}

template <bool SCATTER>
int launch(const float* src, const int* idx, float* dst, long long n,
           int dim, cudaStream_t stream) {
  if (n < 0 || dim <= 0) return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  const bool vec = dim % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(src) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(dst) % 16 == 0;
  const int width = vec ? dim / 4 : dim;
  const int tpr = width >= 32 ? 32 : 8;
  const long long rows_per_block = THREADS / tpr;
  long long blocks = (n + rows_per_block - 1) / rows_per_block;
  if (blocks > MAX_BLOCKS) blocks = MAX_BLOCKS;
  const unsigned grid = static_cast<unsigned>(blocks);
  if (vec) {
    copy_rows_kernel<float4, SCATTER><<<grid, THREADS, 0, stream>>>(
        reinterpret_cast<const float4*>(src), idx,
        reinterpret_cast<float4*>(dst), n, width, tpr);
  } else {
    copy_rows_kernel<float, SCATTER><<<grid, THREADS, 0, stream>>>(
        src, idx, dst, n, width, tpr);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// K10a.  cache [capacity, dim] fp32, slots int32 [n] (each in
// [0, capacity)), out [n, dim] fp32, all contiguous.  Returns
// cudaGetLastError() after the launch (0 = ok).
extern "C" int embed_gather(const float* cache, const int* slots, float* out,
                            long long n, int dim, void* stream) {
  return launch<false>(cache, slots, out, n, dim,
                       static_cast<cudaStream_t>(stream));
}

// K10b.  cache [capacity, dim] fp32 written in place at slots int32 [n]
// from rows [n, dim] fp32, all contiguous.  Returns cudaGetLastError()
// after the launch (0 = ok).
extern "C" int embed_scatter(float* cache, const int* slots,
                             const float* rows, long long n, int dim,
                             void* stream) {
  return launch<true>(rows, slots, cache, n, dim,
                      static_cast<cudaStream_t>(stream));
}
