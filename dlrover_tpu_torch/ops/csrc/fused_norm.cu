// LayerNorm / RMSNorm backward in one pass on Hopper (sm_90a).
//
// Replaces the TPU kernel of dlrover_tpu/ops/fused_norm.py:
//   K4  _make_bwd_kernel(center)  from x, dy [n, D], scale [D] and the
//       forward's saved row statistics mean, rstd [n]:
//         xhat = (x - mean) * rstd          (RMSNorm: x * rstd)
//         g    = dy * scale
//         dx   = rstd * (g - xhat * mean(g * xhat) - mean(g))
//                                           (RMSNorm: without mean(g))
//         dscale partial = sum over the block's rows of dy * xhat
//         dbias  partial = sum over the block's rows of dy
//       dx in x's dtype; one fp32 [D] partial row per block, summed
//       outside as the TPU kernel's per-grid-step partials are.
//
// What bounds it on this card: bytes.  x and dy are read and dx written
// once (6 bytes per element in bf16) against some 12 flops.  What the
// design does about it: one pass, with a row held in registers between
// its two reductions and its dx, so nothing is read twice.
//
// Layout.  A block of 256 threads owns a run of consecutive rows and
// takes them one at a time; a thread owns the same columns of every row
// (chunks of 8 consecutive columns, chunk c of thread t at column
// 8 (t + 256 c)), so its dy * xhat and dy column sums stay in registers
// for the whole run and the partial row is written once, without atomics:
// dscale and dbias are deterministic.  The two row sums (g * xhat and g)
// go through a warp shuffle and one shared-memory exchange per row
// (double-buffered by row parity: one barrier a row).  The TPU kernel's
// 256-row tiles and its zero-padded last tile are gone: the last block's
// run is simply shorter.  When D is a multiple of 8 a chunk is one
// 16-byte load (two for fp32); otherwise its elements are loaded one by
// one behind a mask.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int CHUNK = 8;  // consecutive columns a thread loads at once

__device__ __forceinline__ float warp_sum(float x) {
  for (int off = 16; off > 0; off >>= 1) {
    x += __shfl_xor_sync(0xffffffffu, x, off);
  }
  return x;
}

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(bf16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void from_float(float x, float* out) { *out = x; }
__device__ __forceinline__ void from_float(float x, bf16* out) {
  *out = __float2bfloat16_rn(x);
}

// Columns [col, col + 8) of one row (row points at its first element) as
// floats, 0 past D.  `vec`: D is a multiple of 8 and the base is 16-byte
// aligned, so the chunk is whole and aligned.
template <typename T>
__device__ __forceinline__ void load_chunk(const T* row, int col, int D,
                                           bool vec, float (&out)[CHUNK]) {
  if (vec) {
    __align__(16) T tmp[CHUNK];
    constexpr int VECS = sizeof(T) * CHUNK / 16;
    const uint4* src = reinterpret_cast<const uint4*>(row + col);
#pragma unroll
    for (int v = 0; v < VECS; ++v) reinterpret_cast<uint4*>(tmp)[v] = src[v];
#pragma unroll
    for (int k = 0; k < CHUNK; ++k) out[k] = to_float(tmp[k]);
  } else {
#pragma unroll
    for (int k = 0; k < CHUNK; ++k) {
      out[k] = (col + k < D) ? to_float(row[col + k]) : 0.0f;
    }
  }
}

template <typename T>
__device__ __forceinline__ void store_chunk(T* row, int col, int D, bool vec,
                                            const float (&val)[CHUNK]) {
  if (vec) {
    __align__(16) T tmp[CHUNK];
#pragma unroll
    for (int k = 0; k < CHUNK; ++k) from_float(val[k], &tmp[k]);
    constexpr int VECS = sizeof(T) * CHUNK / 16;
    uint4* dst = reinterpret_cast<uint4*>(row + col);
#pragma unroll
    for (int v = 0; v < VECS; ++v) dst[v] = reinterpret_cast<uint4*>(tmp)[v];
  } else {
#pragma unroll
    for (int k = 0; k < CHUNK; ++k) {
      if (col + k < D) from_float(val[k], &row[col + k]);
    }
  }
}

// NCH: chunks per thread, ceil(ceil(D / 8) / 256).
template <typename T, bool CENTER, int NCH>
__global__ void __launch_bounds__(THREADS)
norm_bwd_kernel(const T* __restrict__ x, const T* __restrict__ dy,
                const float* __restrict__ scale,
                const float* __restrict__ mean,
                const float* __restrict__ rstd, T* __restrict__ dx,
                float* __restrict__ dscale_parts,
                float* __restrict__ dbias_parts, int n, int D,
                int rows_per_block, int vec) {
  __shared__ float red[2][WARPS][2];
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int row0 = blockIdx.x * rows_per_block;
  const int row1 = min(row0 + rows_per_block, n);
  const bool vec_ok = vec != 0;
  const float inv_d = 1.0f / static_cast<float>(D);

  float sc[NCH][CHUNK], acc_s[NCH][CHUNK], acc_b[NCH][CHUNK];
#pragma unroll
  for (int c = 0; c < NCH; ++c) {
    const int col = (tid + c * THREADS) * CHUNK;
#pragma unroll
    for (int k = 0; k < CHUNK; ++k) {
      sc[c][k] = (col + k < D) ? scale[col + k] : 0.0f;
      acc_s[c][k] = 0.0f;
      acc_b[c][k] = 0.0f;
    }
  }

  for (int row = row0; row < row1; ++row) {
    const long long off = static_cast<long long>(row) * D;
    const float r = rstd[row];
    const float mu = CENTER ? mean[row] : 0.0f;
    float xhat[NCH][CHUNK], g[NCH][CHUNK];
    float sum_gx = 0.0f, sum_g = 0.0f;
#pragma unroll
    for (int c = 0; c < NCH; ++c) {
      const int col = (tid + c * THREADS) * CHUNK;
      if (col < D) {
        float xv[CHUNK], dyv[CHUNK];
        load_chunk(x + off, col, D, vec_ok, xv);
        load_chunk(dy + off, col, D, vec_ok, dyv);
#pragma unroll
        for (int k = 0; k < CHUNK; ++k) {
          // Past D: x = dy = scale = 0, and with CENTER xhat = -mu * r,
          // which only ever multiplies a 0 and is not stored.
          xhat[c][k] = (xv[k] - mu) * r;
          g[c][k] = dyv[k] * sc[c][k];
          sum_gx += g[c][k] * xhat[c][k];
          sum_g += g[c][k];
          acc_s[c][k] += dyv[k] * xhat[c][k];
          acc_b[c][k] += dyv[k];
        }
      }
    }
    sum_gx = warp_sum(sum_gx);
    if (CENTER) sum_g = warp_sum(sum_g);
    const int buf = (row - row0) & 1;
    if (lane == 0) {
      red[buf][warp][0] = sum_gx;
      red[buf][warp][1] = sum_g;
    }
    __syncthreads();
    float tot_gx = 0.0f, tot_g = 0.0f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      tot_gx += red[buf][w][0];
      tot_g += red[buf][w][1];
    }
    const float proj = tot_gx * inv_d;
    const float mean_g = CENTER ? tot_g * inv_d : 0.0f;
#pragma unroll
    for (int c = 0; c < NCH; ++c) {
      const int col = (tid + c * THREADS) * CHUNK;
      if (col < D) {
        float out[CHUNK];
#pragma unroll
        for (int k = 0; k < CHUNK; ++k) {
          out[k] = r * (g[c][k] - xhat[c][k] * proj - mean_g);
        }
        store_chunk(dx + off, col, D, vec_ok, out);
      }
    }
  }

  const long long part = static_cast<long long>(blockIdx.x) * D;
#pragma unroll
  for (int c = 0; c < NCH; ++c) {
    const int col = (tid + c * THREADS) * CHUNK;
#pragma unroll
    for (int k = 0; k < CHUNK; ++k) {
      if (col + k < D) {
        dscale_parts[part + col + k] = acc_s[c][k];
        dbias_parts[part + col + k] = acc_b[c][k];
      }
    }
  }
}

template <typename T, bool CENTER, int NCH>
int launch(const void* x, const void* dy, const float* scale,
           const float* mean, const float* rstd, void* dx, float* ds,
           float* db, int n, int D, int rows_per_block, int vec,
           cudaStream_t stream) {
  const int blocks = (n + rows_per_block - 1) / rows_per_block;
  norm_bwd_kernel<T, CENTER, NCH><<<blocks, THREADS, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(dy), scale, mean, rstd,
      static_cast<T*>(dx), ds, db, n, D, rows_per_block, vec);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, bool CENTER>
int launch_nch(int nch, const void* x, const void* dy, const float* scale,
               const float* mean, const float* rstd, void* dx, float* ds,
               float* db, int n, int D, int rpb, int vec, cudaStream_t s) {
  switch (nch) {
    case 1:
      return launch<T, CENTER, 1>(x, dy, scale, mean, rstd, dx, ds, db, n, D,
                                  rpb, vec, s);
    case 2:
      return launch<T, CENTER, 2>(x, dy, scale, mean, rstd, dx, ds, db, n, D,
                                  rpb, vec, s);
    case 3:
    case 4:
      return launch<T, CENTER, 4>(x, dy, scale, mean, rstd, dx, ds, db, n, D,
                                  rpb, vec, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// K4.  x, dy, dx: [n, D] contiguous, fp32 (is_bf16 0) or bf16 (1); scale
// fp32 [D]; mean (read only with center) and rstd fp32 [n]; dscale_parts
// and dbias_parts fp32 [ceil(n / rows_per_block), D], every element
// written.  D at most 8192.  Chunks are loaded as 16-byte vectors when D is
// a multiple of 8 and x, dy, dx are 16-byte aligned, else element by
// element.  Returns cudaGetLastError() after the launch (0 = ok).
extern "C" int norm_bwd(const void* x, const void* dy, const void* scale,
                        const void* mean, const void* rstd, void* dx,
                        void* dscale_parts, void* dbias_parts, int n, int D,
                        int rows_per_block, int center, int is_bf16,
                        void* stream) {
  if (n <= 0 || D <= 0 || rows_per_block <= 0 || D > 8192) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int chunks = (D + CHUNK - 1) / CHUNK;
  const int nch = (chunks + THREADS - 1) / THREADS;
  const bool aligned =
      ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(dy) |
        reinterpret_cast<uintptr_t>(dx)) & 15) == 0;
  const int vec = (D % CHUNK == 0 && aligned) ? 1 : 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* sc = static_cast<const float*>(scale);
  const float* mu = static_cast<const float*>(mean);
  const float* rs = static_cast<const float*>(rstd);
  float* ds = static_cast<float*>(dscale_parts);
  float* db = static_cast<float*>(dbias_parts);
  if (is_bf16) {
    return center ? launch_nch<bf16, true>(nch, x, dy, sc, mu, rs, dx, ds, db,
                                           n, D, rows_per_block, vec, s)
                  : launch_nch<bf16, false>(nch, x, dy, sc, mu, rs, dx, ds,
                                            db, n, D, rows_per_block, vec, s);
  }
  return center ? launch_nch<float, true>(nch, x, dy, sc, mu, rs, dx, ds, db,
                                          n, D, rows_per_block, vec, s)
                : launch_nch<float, false>(nch, x, dy, sc, mu, rs, dx, ds, db,
                                           n, D, rows_per_block, vec, s);
}
