// LayerNorm / RMSNorm backward in one pass on Hopper (sm_90a).
//
// Replaces the TPU kernel of dlrover_tpu/ops/fused_norm.py:
//   K4  _make_bwd_kernel(center)  from x, dy [n, D], scale [D] and the
//       forward's saved row statistics mean, rstd [n]:
//         xhat = (x - mean) * rstd          (RMSNorm: x * rstd)
//         g    = dy * scale
//         dx   = rstd * (g - xhat * mean(g * xhat) - mean(g))
//                                           (RMSNorm: without mean(g))
//         dscale = sum over rows of dy * xhat
//         dbias  = sum over rows of dy
//       dx in x's dtype; dscale and dbias fp32 [D].
//
// What bounds it on this card: bytes.  x and dy are read and dx written
// once (6 bytes an element in bf16) against some 14 flops; at the training
// step's [16384, 1600] bf16 that is 157 MB, 0.047 ms at 3.35 TB/s.
//
// The design (the host plan is ops/fused_norm.py norm_launch_plan):
// * A row belongs to a group of W warps (W = 1, 2, 4 or 8: the fewest
//   that leave a lane at most NCH chunks of 8 columns; a pair at D 1600),
//   so a row's two sums are warp shuffles and, for W > 1, one exchange
//   through shared memory behind a barrier of the group's warps alone.
//   The row loop has no block barrier.  A 256-thread block holds 8 / W
//   groups; each group takes a run of consecutive rows.
// * The rows reach shared memory by bulk copies (cp.async.bulk, counted on
//   mbarriers) into a ring of three (x, dy) row pairs a group.  At the top
//   of row i the group's first thread refills the stage of row i - 2 with
//   row i + 1, so the next row's loads are in flight while the group
//   reduces and writes this row, whatever the registers hold; every warp
//   of the group freed that stage before the group's barrier of row i - 1,
//   so the refill never waits for the group's slowest warp (refilling row
//   i - 1's stage from a ring of two did, and read slower: PERF.md).  The
//   row's values are read from shared memory twice, once for the sums and
//   once for dx.
//   Rows whose width is no multiple of 8, or whose tensors are not 16-byte
//   aligned, are read from device memory directly, element by element
//   behind a mask, with no ring.
// * A lane's dscale and dbias partials stay in registers over its group's
//   rows; at the end the block's groups add theirs through shared memory
//   in group order into one partial row per block, and a second kernel of
//   this file sums the partial rows in a fixed order (eight runs of
//   consecutive blocks, then the runs in order).  So dscale and dbias are
//   the same bit for bit from run to run, with no atomics, and no further
//   launch is needed outside the library.
// * The blocks an SM come from the registers (at most 128 a thread, two
//   blocks) and the ring's shared memory, not a fixed count.
// What holds it back still: each row's two reductions stand between its
// loads and its stores, and a lane at D 1600 holds four chunks where the
// average is 3.1.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_common.cuh"
#include "flash_hopper.cuh"

using namespace hopper;

// The host plan (ops/fused_norm.py norm_launch_plan; a ctypes mirror, field
// for field).  Outside the unnamed namespace: the C entry takes it.
struct NormPlan {
  int blocks;          // grid of the main kernel: one partial row each
  int warps_per_row;   // W
  int rows_per_group;  // consecutive rows a group takes
  int smem_bytes;      // a block's dynamic shared memory
  int reduce_blocks;   // grid of the partial-row reduction
};

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int CHUNK = 8;       // consecutive columns a lane loads at once
constexpr int NCH = 4;         // most chunks a lane holds
constexpr int STAGES = 3;      // (x, dy) row pairs of a group's ring
constexpr int AHEAD = 1;       // rows a group's loads run ahead of its work
// At the top of row i the stage of row i + AHEAD - STAGES is refilled, a
// row already read; with AHEAD + 2 <= STAGES every warp of the group has
// freed it before the group's barrier of row i - 1, so the refill never
// waits.
static_assert(AHEAD >= 1 && AHEAD < STAGES, "a refilled stage must be read");
constexpr int MIN_BLOCKS = 2;  // blocks an SM the registers must allow
constexpr int RED_COLS = 32;   // the reduction: columns a block
constexpr int RED_RUNS = THREADS / RED_COLS;  // runs of partial rows

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
// floats, 0 past D.  `vec`: D is a multiple of 8 and the row 16-byte
// aligned, so the chunk is whole and aligned.
template <typename T, bool VEC>
__device__ __forceinline__ void load_chunk(const T* row, int col, int D,
                                           float (&out)[CHUNK]) {
  if constexpr (VEC) {
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

template <typename T, bool VEC>
__device__ __forceinline__ void store_chunk(T* row, int col, int D,
                                            const float (&val)[CHUNK]) {
  if constexpr (VEC) {
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

// Shared memory of a block, for D columns of T, W warps a row and `stages`
// row pairs a group (STAGES with the ring, 0 without).  ops/fused_norm.py's
// norm_smem_bytes mirrors it.
struct NormSmem {
  uint32_t scale_off, red_off, bar_off, bytes;
  __host__ __device__ NormSmem(int D, int elem, int W, int stages) {
    const int groups = WARPS / W;
    const uint32_t row_bytes = (D * elem + 15) / 16 * 16;
    // The ring; after the row loop it holds the groups' partial rows.
    uint32_t ring = groups * stages * 2 * row_bytes;
    const uint32_t partials = (groups * 2 * D * 4 + 15) / 16 * 16;
    ring = ring > partials ? ring : partials;
    scale_off = ring;
    red_off = scale_off + (D * 4 + 15) / 16 * 16;  // scale, fp32 [D]
    bar_off = red_off + 16 * groups * W;  // [group][parity][warp][2] sums
    bytes = bar_off + 16 * groups * stages;  // full, empty [group][stage]
  }
};

template <typename T, bool CENTER, int W, bool VEC>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
norm_bwd_kernel(const T* __restrict__ x, const T* __restrict__ dy,
                const float* __restrict__ scale,
                const float* __restrict__ mean,
                const float* __restrict__ rstd, T* __restrict__ dx,
                float* __restrict__ parts, int n, int D, int rows_per_group) {
  constexpr int GROUPS = WARPS / W;
  constexpr int stages = VEC ? STAGES : 0;
  constexpr int GT = 32 * W;  // threads a group
  extern __shared__ __align__(16) unsigned char smem[];
  const NormSmem L(D, sizeof(T), W, stages);
  float* scale_s = reinterpret_cast<float*>(smem + L.scale_off);
  float* red = reinterpret_cast<float*>(smem + L.red_off);
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int grp = warp / W, gwarp = warp % W, gt = tid % GT;
  const uint32_t row_bytes = (D * sizeof(T) + 15) / 16 * 16;
  const long long first =
      static_cast<long long>(blockIdx.x * GROUPS + grp) * rows_per_group;
  const int r0 = static_cast<int>(min(first, static_cast<long long>(n)));
  const int nrows = min(r0 + rows_per_group, n) - r0;
  unsigned char* ring = smem + grp * stages * 2 * row_bytes;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L.bar_off) +
                   grp * 2 * stages;
  uint64_t* empty = full + stages;
  const float inv_d = 1.0f / static_cast<float>(D);

  if (VEC && gt == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], W);  // one arrival per warp
    }
    mbar_init_fence();
  }
  for (int c = tid; c < D; c += THREADS) scale_s[c] = scale[c];
  __syncthreads();

  // The group's first thread issues every load: the first STAGES rows
  // now, each later one at the top of the row after its stage's last.
  auto load_row = [&](int i) {
    const int s = i % STAGES;
    const long long off = static_cast<long long>(r0 + i) * D;
    const uint32_t bytes = static_cast<uint32_t>(D * sizeof(T));
    mbar_expect_tx(&full[s], 2 * bytes);
    bulk_load(ring + (2 * s) * row_bytes, x + off, bytes, &full[s]);
    bulk_load(ring + (2 * s + 1) * row_bytes, dy + off, bytes, &full[s]);
  };
  if (VEC && gt == 0) {
    for (int i = 0; i < min(STAGES, nrows); ++i) load_row(i);
  }

  float acc_s[NCH][CHUNK], acc_b[NCH][CHUNK];
#pragma unroll
  for (int c = 0; c < NCH; ++c) {
#pragma unroll
    for (int k = 0; k < CHUNK; ++k) acc_s[c][k] = acc_b[c][k] = 0.0f;
  }
  float r_next = nrows > 0 ? rstd[r0] : 0.0f;
  float mu_next = CENTER && nrows > 0 ? mean[r0] : 0.0f;
  for (int i = 0; i < nrows; ++i) {
    const float r = r_next, mu = mu_next;
    if (i + 1 < nrows) {  // the next row's statistics, a row ahead
      r_next = rstd[r0 + i + 1];
      if (CENTER) mu_next = mean[r0 + i + 1];
    }
    const int s = VEC ? i % STAGES : 0;
    const long long off = static_cast<long long>(r0 + i) * D;
    const T* xr = x + off;
    const T* dyr = dy + off;
    if constexpr (VEC) {
      // Row i + AHEAD takes the stage of row rr = i + AHEAD - STAGES
      // before row i is awaited.
      const int rr = i + AHEAD - STAGES;
      if (gt == 0 && rr >= 0 && rr + STAGES < nrows) {
        mbar_wait(&empty[rr % STAGES], (rr / STAGES) & 1);
        load_row(rr + STAGES);
      }
      mbar_wait(&full[s], (i / STAGES) & 1);
      xr = reinterpret_cast<const T*>(ring + (2 * s) * row_bytes);
      dyr = reinterpret_cast<const T*>(ring + (2 * s + 1) * row_bytes);
    }
    float sum_gx = 0.0f, sum_g = 0.0f;
#pragma unroll
    for (int c = 0; c < NCH; ++c) {
      const int col = (gt + c * GT) * CHUNK;
      if (col < D) {
        float xv[CHUNK], dyv[CHUNK], sc[CHUNK];
        load_chunk<T, VEC>(xr, col, D, xv);
        load_chunk<T, VEC>(dyr, col, D, dyv);
        load_chunk<float, VEC>(scale_s, col, D, sc);
#pragma unroll
        for (int k = 0; k < CHUNK; ++k) {
          // Past D: x = dy = scale = 0, and with CENTER xhat = -mu * r,
          // which only ever multiplies a 0 and is not stored.
          const float xhat = (xv[k] - mu) * r;
          const float g = dyv[k] * sc[k];
          sum_gx += g * xhat;
          sum_g += g;
          acc_s[c][k] += dyv[k] * xhat;
          acc_b[c][k] += dyv[k];
        }
      }
    }
    sum_gx = warp_sum(sum_gx);
    if (CENTER) sum_g = warp_sum(sum_g);
    if constexpr (W > 1) {
      // The group's warps exchange their sums, double-buffered by row
      // parity: one barrier of the group's warps a row.
      float* slot = red + ((grp * 2 + (i & 1)) * W) * 2;
      if (lane == 0) {
        slot[2 * gwarp] = sum_gx;
        slot[2 * gwarp + 1] = sum_g;
      }
      named_barrier(1 + grp, GT);
      sum_gx = 0.0f;
      sum_g = 0.0f;
#pragma unroll
      for (int w = 0; w < W; ++w) {
        sum_gx += slot[2 * w];
        sum_g += slot[2 * w + 1];
      }
    }
    const float proj = sum_gx * inv_d;
    const float mean_g = CENTER ? sum_g * inv_d : 0.0f;
#pragma unroll
    for (int c = 0; c < NCH; ++c) {
      const int col = (gt + c * GT) * CHUNK;
      if (col < D) {
        float xv[CHUNK], dyv[CHUNK], sc[CHUNK], out[CHUNK];
        load_chunk<T, VEC>(xr, col, D, xv);
        load_chunk<T, VEC>(dyr, col, D, dyv);
        load_chunk<float, VEC>(scale_s, col, D, sc);
#pragma unroll
        for (int k = 0; k < CHUNK; ++k) {
          const float xhat = (xv[k] - mu) * r;
          const float g = dyv[k] * sc[k];
          out[k] = r * (g - xhat * proj - mean_g);
        }
        store_chunk<T, VEC>(dx + off, col, D, out);
      }
    }
    if constexpr (VEC) {
      // Every warp frees row i's stage after its last read.
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[s]);
    }
  }

  // The block's partial row: every group's in shared memory (over its
  // ring, idle now), then summed in group order.
  __syncthreads();
  float* mine = reinterpret_cast<float*>(smem) + grp * 2 * D;
#pragma unroll
  for (int c = 0; c < NCH; ++c) {
    const int col = (gt + c * GT) * CHUNK;
#pragma unroll
    for (int k = 0; k < CHUNK; ++k) {
      if (col + k < D) {
        mine[col + k] = acc_s[c][k];
        mine[D + col + k] = acc_b[c][k];
      }
    }
  }
  __syncthreads();
  const float* all = reinterpret_cast<const float*>(smem);
  float* part = parts + static_cast<long long>(blockIdx.x) * 2 * D;
  for (int j = tid; j < 2 * D; j += THREADS) {
    float v = all[j];
#pragma unroll
    for (int gg = 1; gg < GROUPS; ++gg) v += all[gg * 2 * D + j];
    part[j] = v;
  }
}

// sums[j] = sum over the `blocks` partial rows of parts[., j] (j < 2 D:
// dscale then dbias), in a fixed order: RED_RUNS runs of consecutive rows,
// each summed in row order, then the runs' sums in run order.
__global__ void __launch_bounds__(THREADS)
norm_param_reduce_kernel(const float* __restrict__ parts,
                         float* __restrict__ sums, int blocks, int cols) {
  __shared__ float run_sum[RED_RUNS][RED_COLS];
  const int c = threadIdx.x % RED_COLS;
  const int run = threadIdx.x / RED_COLS;
  const int col = blockIdx.x * RED_COLS + c;
  const int per_run = (blocks + RED_RUNS - 1) / RED_RUNS;
  const int b0 = min(run * per_run, blocks);
  const int b1 = min(b0 + per_run, blocks);
  float acc = 0.0f;
  if (col < cols) {
    for (int b = b0; b < b1; ++b) {
      acc += parts[static_cast<long long>(b) * cols + col];
    }
  }
  run_sum[run][c] = acc;
  __syncthreads();
  if (run == 0 && col < cols) {
    float total = run_sum[0][c];
#pragma unroll
    for (int k = 1; k < RED_RUNS; ++k) total += run_sum[k][c];
    sums[col] = total;
  }
}

template <typename T, bool CENTER, int W, bool VEC>
int launch(const void* x, const void* dy, const float* scale,
           const float* mean, const float* rstd, void* dx, float* parts,
           float* sums, int n, int D, const NormPlan& plan,
           cudaStream_t stream) {
  static bool opted_in[64] = {};
  cudaError_t err = flash::opt_in_smem(norm_bwd_kernel<T, CENTER, W, VEC>,
                                       232448, opted_in);
  if (err != cudaSuccess) return static_cast<int>(err);
  norm_bwd_kernel<T, CENTER, W, VEC>
      <<<plan.blocks, THREADS, plan.smem_bytes, stream>>>(
          static_cast<const T*>(x), static_cast<const T*>(dy), scale, mean,
          rstd, static_cast<T*>(dx), parts, n, D, plan.rows_per_group);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  norm_param_reduce_kernel<<<plan.reduce_blocks, THREADS, 0, stream>>>(
      parts, sums, plan.blocks, 2 * D);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, bool CENTER, bool VEC>
int launch_w(const void* x, const void* dy, const float* scale,
             const float* mean, const float* rstd, void* dx, float* parts,
             float* sums, int n, int D, const NormPlan& plan,
             cudaStream_t s) {
  switch (plan.warps_per_row) {
    case 1:
      return launch<T, CENTER, 1, VEC>(x, dy, scale, mean, rstd, dx, parts,
                                       sums, n, D, plan, s);
    case 2:
      return launch<T, CENTER, 2, VEC>(x, dy, scale, mean, rstd, dx, parts,
                                       sums, n, D, plan, s);
    case 4:
      return launch<T, CENTER, 4, VEC>(x, dy, scale, mean, rstd, dx, parts,
                                       sums, n, D, plan, s);
    default:
      return launch<T, CENTER, 8, VEC>(x, dy, scale, mean, rstd, dx, parts,
                                       sums, n, D, plan, s);
  }
}

template <typename T>
int launch_t(int center, int vec, const void* x, const void* dy,
             const float* scale, const float* mean, const float* rstd,
             void* dx, float* parts, float* sums, int n, int D,
             const NormPlan& plan, cudaStream_t s) {
  if (center) {
    return vec ? launch_w<T, true, true>(x, dy, scale, mean, rstd, dx, parts,
                                         sums, n, D, plan, s)
               : launch_w<T, true, false>(x, dy, scale, mean, rstd, dx,
                                          parts, sums, n, D, plan, s);
  }
  return vec ? launch_w<T, false, true>(x, dy, scale, mean, rstd, dx, parts,
                                        sums, n, D, plan, s)
             : launch_w<T, false, false>(x, dy, scale, mean, rstd, dx, parts,
                                         sums, n, D, plan, s);
}

}  // namespace

// K4.  x, dy, dx: [n, D] contiguous, fp32 (is_bf16 0) or bf16 (1); scale
// fp32 [D]; mean (read only with center) and rstd fp32 [n]; parts fp32
// [plan.blocks, 2, D] scratch; sums fp32 [2, D] out (dscale, dbias).  D
// at most 8192.  Rows go through the ring when D is a multiple of 8 and
// x, dy, dx are 16-byte aligned, else element by element.  A plan whose
// warps a row or shared-memory bytes do not fit D and the route is
// refused.  Two launches (the row pass, then the partial rows'
// reduction); returns cudaGetLastError() after them (0 = ok).
extern "C" int norm_bwd(const void* x, const void* dy, const void* scale,
                        const void* mean, const void* rstd, void* dx,
                        void* parts, void* sums, int n, int D, int center,
                        int is_bf16, const NormPlan* plan, void* stream) {
  constexpr int kInvalid = static_cast<int>(cudaErrorInvalidValue);
  if (plan == nullptr || n <= 0 || D <= 0 || D > 8192) return kInvalid;
  const int elem = is_bf16 ? 2 : 4;
  const bool aligned =
      ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(dy) |
        reinterpret_cast<uintptr_t>(dx)) & 15) == 0;
  const int vec = (D % CHUNK == 0 && aligned) ? 1 : 0;
  const int W = plan->warps_per_row;
  const int chunks = (D + CHUNK - 1) / CHUNK;
  const int groups = WARPS / (W > 0 ? W : 1);
  if ((W != 1 && W != 2 && W != 4 && W != 8) ||
      (chunks + 32 * W - 1) / (32 * W) > NCH ||
      static_cast<int>(NormSmem(D, elem, W, vec ? STAGES : 0).bytes) !=
          plan->smem_bytes ||
      plan->blocks < 1 ||
      static_cast<long long>(plan->blocks) * groups * plan->rows_per_group <
          n ||
      plan->reduce_blocks != (2 * D + RED_COLS - 1) / RED_COLS) {
    return kInvalid;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* sc = static_cast<const float*>(scale);
  const float* mu = static_cast<const float*>(mean);
  const float* rs = static_cast<const float*>(rstd);
  float* pp = static_cast<float*>(parts);
  float* ss = static_cast<float*>(sums);
  if (is_bf16) {
    return launch_t<bf16>(center, vec, x, dy, sc, mu, rs, dx, pp, ss, n, D,
                          *plan, s);
  }
  return launch_t<float>(center, vec, x, dy, sc, mu, rs, dx, pp, ss, n, D,
                         *plan, s);
}
