// Grouped (ragged) matmul for dropless MoE on Hopper (sm_90a): bf16 in,
// fp32 accumulate, bf16 out.
//
// Replaces the TPU kernels of dlrover_tpu/ops/grouped_matmul.py:
//   K8  _gmm_kernel     out[r] = x[r] @ w[expert(r)], and with the
//                       transposed-w flag the dx of the backward,
//                       dx[r] = dy[r] @ w[expert(r)]^T (_gmm_bwd :129);
//   K9  _gmm_dw_kernel  dw[e] = sum over e's rows r of x[r]^T dy[r].
// Rows are sorted by expert; group_sizes[e] consecutive rows belong to e.
// A row past sum(group_sizes) belongs to the last expert, as the TPU
// kernel's clamped block->expert map has it (_expert_of_block :37-43), and
// an expert that owns no rows gets dw = 0 (_gmm_bwd :159-160).
//
// What bounds it on this card: at the MoE training shapes (33,792 rows,
// d_model 1600, expert d_ff 3200) one launch is 3.46e11 FLOP against
// about 0.4 GB of operands, so the tensor cores bound it (0.35 ms at 989
// TFLOP/s against 0.12 ms for the bytes).  What the design does about it:
// every product runs on tensor cores (nvcuda::wmma bf16 16x16x16, fp32
// accumulators in registers), operand tiles stream into shared memory
// through a 4-stage cp.async ring so loads overlap the products, and a
// 128 x 128 output tile reuses each loaded element 128 times.  wgmma, TMA
// and warp specialisation are left for a performance pass.
//
// Layout.  One block of 8 warps computes a 128 x 128 output tile; warp w
// owns rows 64 (w / 4) .. +64 and columns 32 (w % 4) .. +32 of it (4 x 2
// accumulator fragments).  The reduction runs in steps of 32.
//  K8: one block per (128-row tile, 128-column tile).  The TPU grid's one
//      row block per step becomes the block's row tile; it lies inside one
//      expert because every group size is a multiple of block_rows and
//      block_rows is a multiple of 128 (the wrapper checks the latter).
//      The block finds its expert by a scan over group_sizes (E values);
//      the block->expert map never reaches the host.
//  K9: one block per (expert, 128 tile of x's columns, 128 tile of dy's
//      columns), looping over that expert's rows.  The TPU kernel carried
//      the sum across sequential grid steps; here the loop inside the
//      block does, so there are no atomics and dw is deterministic.
// Ragged edges: columns and the reduction are masked in steps of 8
// elements (cp.async zero-fills what lies outside), so widths must be
// multiples of 8; rows outside the range are zero-filled too.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace {

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

constexpr int BM = 128;      // output tile rows
constexpr int BN = 128;      // output tile columns
constexpr int BK = 32;       // reduction step
constexpr int STAGES = 4;    // cp.async ring depth
constexpr int THREADS = 256; // 8 warps: 2 (rows) x 4 (columns)
constexpr int WM = 64;       // warp tile rows
constexpr int WN = 32;       // warp tile columns
constexpr int FM = WM / 16;  // accumulator fragments per warp, rows
constexpr int FN = WN / 16;  // and columns

// Shared-memory tiles, leading dimensions padded by 8 bf16 (16 bytes):
// every row stays 16-byte aligned for cp.async, every wmma pointer 32-byte
// aligned, and the row walks spread over the banks.
constexpr int LD_ROW = BK + 8;   // [128][32] tile, the reduction contiguous
constexpr int LD_COL = BN + 8;   // [32][128] tile, the output dim contiguous
constexpr int TILE_ROW_BYTES = BM * LD_ROW * 2;  // 10,240
constexpr int TILE_COL_BYTES = BK * LD_COL * 2;  //  8,704
constexpr int STAGE_BYTES = 2 * TILE_ROW_BYTES;  // room for either pair
constexpr int LD_C = BN + 4;                     // fp32 epilogue tile
constexpr int PIPE_BYTES = STAGES * STAGE_BYTES;
constexpr int C_BYTES = BM * LD_C * 4;
constexpr int SMEM_BYTES = PIPE_BYTES > C_BYTES ? PIPE_BYTES : C_BYTES;

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int n = valid ? 16 : 0;  // 0: nothing read, 16 zero bytes written
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// A [rows, red] tile with the reduction contiguous in global memory
// (row-major A of K8; w^T of K8's dx, whose rows are output columns):
// dst[r][c] = src[(row0 + r) * ld + red0 + c], r < 128, c < 32.
__device__ __forceinline__ void load_rows(bf16* dst, const bf16* src,
                                          long long ld, int row0, int n_rows,
                                          int red0, int n_red, int tid) {
  for (int i = tid; i < BM * (BK / 8); i += THREADS) {
    const int r = i / (BK / 8);
    const int c = (i % (BK / 8)) * 8;
    const bool ok = row0 + r < n_rows && red0 + c < n_red;
    const bf16* p = ok ? src + (row0 + r) * ld + red0 + c : src;
    cp_async16(dst + r * LD_ROW + c, p, ok);
  }
}

// A [red, cols] tile with the output dim contiguous in global memory
// (row-major w of K8; x and dy of K9, whose rows are the reduction):
// dst[k][c] = src[(red0 + k) * ld + col0 + c], k < 32, c < 128.
__device__ __forceinline__ void load_cols(bf16* dst, const bf16* src,
                                          long long ld, int red0, int red_end,
                                          int col0, int n_cols, int tid) {
  for (int i = tid; i < BK * (BN / 8); i += THREADS) {
    const int k = i / (BN / 8);
    const int c = (i % (BN / 8)) * 8;
    const bool ok = red0 + k < red_end && col0 + c < n_cols;
    const bf16* p = ok ? src + (red0 + k) * ld + col0 + c : src;
    cp_async16(dst + k * LD_COL + c, p, ok);
  }
}

typedef wmma::fragment<wmma::accumulator, 16, 16, 16, float> Acc;

// Accumulators to the fp32 epilogue tile in shared memory, then bf16 to
// out[row0 + r][col0 + c] (row stride ld_out) where inside n_rows x n_cols.
__device__ __forceinline__ void store_tile(Acc (&acc)[FM][FN],
                                           unsigned char* smem, bf16* out,
                                           long long ld_out, int row0,
                                           int n_rows, int col0, int n_cols,
                                           int warp_m, int warp_n, int tid) {
  float* Cs = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int i = 0; i < FM; ++i) {
#pragma unroll
    for (int j = 0; j < FN; ++j) {
      wmma::store_matrix_sync(
          Cs + (warp_m * WM + i * 16) * LD_C + warp_n * WN + j * 16,
          acc[i][j], LD_C, wmma::mem_row_major);
    }
  }
  __syncthreads();
  for (int i = tid; i < BM * (BN / 8); i += THREADS) {
    const int r = i / (BN / 8);
    const int c = (i % (BN / 8)) * 8;
    if (row0 + r >= n_rows || col0 + c >= n_cols) continue;
    const float* src = Cs + r * LD_C + c;
    __align__(16) bf16 vals[8];
#pragma unroll
    for (int t = 0; t < 8; ++t) vals[t] = __float2bfloat16(src[t]);
    *reinterpret_cast<uint4*>(out + (row0 + r) * ld_out + col0 + c) =
        *reinterpret_cast<const uint4*>(vals);
  }
}

// The expert owning row `row`: the first e with row < sum(gs[0..e]),
// clamped to the last expert (rows past the groups are padding).
__device__ __forceinline__ int expert_of_row(const int* gs, int E, int row) {
  long long end = 0;
  for (int e = 0; e < E; ++e) {
    end += gs[e];
    if (row < end) return e;
  }
  return E - 1;
}

// K8.  out [N, n_cols] = a [N, n_red] (row stride lda) times B_e, where
// B_e[k][j] = w[e * w_se + k * ldb + j] (TRANS_W false: w [E, red, cols])
// or w[e * w_se + j * ldb + k] (TRANS_W true: w [E, cols, red], the dx
// product against w^T).
template <bool TRANS_W>
__global__ void __launch_bounds__(THREADS)
gmm_kernel(const bf16* __restrict__ a, const bf16* __restrict__ w,
           const int* __restrict__ gs, bf16* __restrict__ out, int N,
           int n_red, int n_cols, int E, long long lda, long long ldb,
           long long w_se) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int warp_m = warp / 4, warp_n = warp % 4;
  const int col0 = blockIdx.x * BN;
  const int row0 = blockIdx.y * BM;
  const int e = expert_of_row(gs, E, row0);
  const bf16* we = w + e * w_se;

  auto load_stage = [&](int stage, int kt) {
    bf16* As = reinterpret_cast<bf16*>(smem + stage * STAGE_BYTES);
    bf16* Bs = reinterpret_cast<bf16*>(smem + stage * STAGE_BYTES +
                                       TILE_ROW_BYTES);
    const int red0 = kt * BK;
    load_rows(As, a, lda, row0, N, red0, n_red, tid);
    if (TRANS_W) {
      load_rows(Bs, we, ldb, col0, n_cols, red0, n_red, tid);
    } else {
      load_cols(Bs, we, ldb, red0, n_red, col0, n_cols, tid);
    }
  };

  Acc acc[FM][FN];
#pragma unroll
  for (int i = 0; i < FM; ++i)
#pragma unroll
    for (int j = 0; j < FN; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  const int nk = (n_red + BK - 1) / BK;
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nk) load_stage(s, s);
    cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // tile kt landed; stage (kt - 1) % STAGES is free
    if (kt + STAGES - 1 < nk) {
      load_stage((kt + STAGES - 1) % STAGES, kt + STAGES - 1);
    }
    cp_async_commit();
    const int stage = kt % STAGES;
    const bf16* As = reinterpret_cast<const bf16*>(smem + stage * STAGE_BYTES);
    const bf16* Bs = reinterpret_cast<const bf16*>(smem + stage * STAGE_BYTES +
                                                   TILE_ROW_BYTES);
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa[FM];
#pragma unroll
      for (int i = 0; i < FM; ++i) {
        wmma::load_matrix_sync(
            fa[i], As + (warp_m * WM + i * 16) * LD_ROW + kk * 16, LD_ROW);
      }
#pragma unroll
      for (int j = 0; j < FN; ++j) {
        const int n = warp_n * WN + j * 16;
        if (TRANS_W) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> fb;
          wmma::load_matrix_sync(fb, Bs + n * LD_ROW + kk * 16, LD_ROW);
#pragma unroll
          for (int i = 0; i < FM; ++i) wmma::mma_sync(acc[i][j], fa[i], fb,
                                                      acc[i][j]);
        } else {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb;
          wmma::load_matrix_sync(fb, Bs + kk * 16 * LD_COL + n, LD_COL);
#pragma unroll
          for (int i = 0; i < FM; ++i) wmma::mma_sync(acc[i][j], fa[i], fb,
                                                      acc[i][j]);
        }
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // every stage read: the ring becomes the epilogue tile
  store_tile(acc, smem, out, n_cols, row0, N, col0, n_cols, warp_m, warp_n,
             tid);
}

// K9.  dw[e] [K, M] = x[rows of e]^T dy[rows of e], x [N, K] and dy [N, M]
// row-major.  Expert e owns rows [start_e, start_e + gs[e]), the last
// expert also the padding rows up to N; an expert with no rows writes 0.
__global__ void __launch_bounds__(THREADS)
gmm_dw_kernel(const bf16* __restrict__ x, const bf16* __restrict__ dy,
              const int* __restrict__ gs, bf16* __restrict__ dw, int N,
              int K, int M, int E) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int warp_m = warp / 4, warp_n = warp % 4;
  const int col0 = blockIdx.x * BN;  // over M
  const int row0 = blockIdx.y * BM;  // over K
  const int e = blockIdx.z;
  long long start = 0;
  for (int i = 0; i < e; ++i) start += gs[i];
  long long end = start + gs[e];
  if (e == E - 1 && gs[e] > 0) end = N;
  if (end > N) end = N;
  const int r_begin = static_cast<int>(start < N ? start : N);
  const int r_end = static_cast<int>(end > r_begin ? end : r_begin);

  auto load_stage = [&](int stage, int kt) {
    bf16* Xs = reinterpret_cast<bf16*>(smem + stage * STAGE_BYTES);
    bf16* Ds = reinterpret_cast<bf16*>(smem + stage * STAGE_BYTES +
                                       TILE_ROW_BYTES);
    const int red0 = r_begin + kt * BK;
    load_cols(Xs, x, K, red0, r_end, row0, K, tid);
    load_cols(Ds, dy, M, red0, r_end, col0, M, tid);
  };

  Acc acc[FM][FN];
#pragma unroll
  for (int i = 0; i < FM; ++i)
#pragma unroll
    for (int j = 0; j < FN; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  const int nk = (r_end - r_begin + BK - 1) / BK;
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nk) load_stage(s, s);
    cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    if (kt + STAGES - 1 < nk) {
      load_stage((kt + STAGES - 1) % STAGES, kt + STAGES - 1);
    }
    cp_async_commit();
    const int stage = kt % STAGES;
    const bf16* Xs = reinterpret_cast<const bf16*>(smem + stage * STAGE_BYTES);
    const bf16* Ds = reinterpret_cast<const bf16*>(smem + stage * STAGE_BYTES +
                                                   TILE_ROW_BYTES);
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      // x^T tile: element (i, k) sits at Xs[k][i], a column-major A.
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major> fa[FM];
#pragma unroll
      for (int i = 0; i < FM; ++i) {
        wmma::load_matrix_sync(
            fa[i], Xs + kk * 16 * LD_COL + warp_m * WM + i * 16, LD_COL);
      }
#pragma unroll
      for (int j = 0; j < FN; ++j) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb;
        wmma::load_matrix_sync(fb, Ds + kk * 16 * LD_COL + warp_n * WN + j * 16,
                               LD_COL);
#pragma unroll
        for (int i = 0; i < FM; ++i) wmma::mma_sync(acc[i][j], fa[i], fb,
                                                    acc[i][j]);
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();
  store_tile(acc, smem, dw + static_cast<long long>(e) * K * M, M, row0, K,
             col0, M, warp_m, warp_n, tid);
}

// Above 48 KB of dynamic shared memory a kernel needs an opt-in, once per
// device, kept off the launch path (and so out of CUDA graph capture).
template <typename Kernel>
cudaError_t opt_in_smem(Kernel kernel, bool* done) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 64 && done[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             SMEM_BYTES);
  if (err == cudaSuccess && dev < 64) done[dev] = true;
  return err;
}

template <bool TRANS_W>
int launch_gmm(const void* a, const void* w, const int* gs, void* out, int N,
               int n_red, int n_cols, int E, long long lda, long long ldb,
               long long w_se, cudaStream_t stream) {
  static bool opted_in[64] = {};
  cudaError_t err = opt_in_smem(gmm_kernel<TRANS_W>, opted_in);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((n_cols + BN - 1) / BN, (N + BM - 1) / BM);
  gmm_kernel<TRANS_W><<<grid, THREADS, SMEM_BYTES, stream>>>(
      static_cast<const bf16*>(a), static_cast<const bf16*>(w), gs,
      static_cast<bf16*>(out), N, n_red, n_cols, E, lda, ldb, w_se);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// K8.  a [N, n_red] bf16 with row stride lda (unit column stride); w bf16
// with expert stride w_se: [E, n_red, n_cols] row stride ldb (trans_w 0)
// or [E, n_cols, n_red] row stride ldb (trans_w 1, the product against
// w^T); group_sizes [E] int32 on the device; out [N, n_cols] contiguous
// bf16.  n_red, n_cols, lda, ldb and w_se multiples of 8, pointers 16-byte
// aligned, every group a multiple of 128 rows.  Returns
// cudaGetLastError() after the launch (0 = ok).
extern "C" int gmm_bf16(const void* a, const void* w, const void* group_sizes,
                        void* out, int N, int n_red, int n_cols, int E,
                        int trans_w, long long lda, long long ldb,
                        long long w_se, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* gs = static_cast<const int*>(group_sizes);
  if (N <= 0 || n_red <= 0 || n_cols <= 0 || E <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return trans_w ? launch_gmm<true>(a, w, gs, out, N, n_red, n_cols, E, lda,
                                    ldb, w_se, s)
                 : launch_gmm<false>(a, w, gs, out, N, n_red, n_cols, E, lda,
                                     ldb, w_se, s);
}

// K9.  x [N, K] and dy [N, M] contiguous bf16, group_sizes [E] int32 on
// the device, dw [E, K, M] contiguous bf16 (every element written).  K and
// M multiples of 8, pointers 16-byte aligned.  Returns cudaGetLastError()
// after the launch (0 = ok).
extern "C" int gmm_dw_bf16(const void* x, const void* dy,
                           const void* group_sizes, void* dw, int N, int K,
                           int M, int E, void* stream) {
  static bool opted_in[64] = {};
  if (N <= 0 || K <= 0 || M <= 0 || E <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = opt_in_smem(gmm_dw_kernel, opted_in);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((M + BN - 1) / BN, (K + BM - 1) / BM, E);
  gmm_dw_kernel<<<grid, THREADS, SMEM_BYTES, static_cast<cudaStream_t>(
                                                 stream)>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(dy),
      static_cast<const int*>(group_sizes), static_cast<bf16*>(dw), N, K, M,
      E);
  return static_cast<int>(cudaGetLastError());
}
