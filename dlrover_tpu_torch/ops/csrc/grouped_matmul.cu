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
// TFLOP/s against 0.12 ms for the bytes).  What the design does about it
// (gemm_hopper.cuh and flash_hopper.cuh hold the pieces):
// * Every product is a wgmma (m64nNk16, bf16 in, fp32 accumulators in
//   registers) with both operands in shared memory.  A block has three
//   warpgroups: a producer, which gives most of its registers to the two
//   consumers (setmaxnreg), and two consumers, each owning 64 rows of a
//   128 x 256 output tile.  Where at most 128 columns are left, the tile
//   is a half tile (wgmma m64n128k16 on half the accumulators, half the w
//   loads): 1600 columns are 6 whole tiles and a half, 3200 twelve and a
//   half, and an output at most 128 wide is one half tile.
// * One thread of the producer streams the operand tiles through a ring
//   of 4 stages of 128-byte-swizzled tiles (the K tile is 64 bf16, one
//   swizzle row) by TMA, on full / empty mbarrier pairs; the
//   consumers only wait, multiply and release.  The tensor maps are
//   encoded on the host per call and passed as __grid_constant__
//   parameters, so the launch can be captured in a CUDA graph; what lies
//   outside a tensor (ragged widths, the reduction's tail) arrives as
//   zeros.
// * The grid is persistent: one block per SM walks the output tiles, so
//   the producer loads the next tile while the consumers store this one.
//   The host plans the launch (ops/grouped_matmul.py gmm_launch_plan): the
//   kernel takes its tile counts and grid from the plan, and the entry
//   points refuse a plan whose tile, ring or shared memory is not the one
//   the kernel is built for.
//   Round r of the walk gives tiles r G .. r G + G - 1 to the G blocks,
//   in reverse block order on odd rounds (a snake), so a block that took
//   a costly unit in one round takes a cheap one in the next.
//   The epilogue converts to bf16 in registers, swaps pieces among the
//   four threads of a quad so each holds 8 adjacent columns, and stores 16
//   bytes at a time, masking rows and columns past the output's edge.
// * The three products read their operands with different majors:
//     K8 forward  a [N, K] K-major,  w[e] [K, M] MN-major (transpose bit);
//     K8 dx       dy [N, M] K-major, w[e] [K, M] read as [M, K]: K-major;
//     K9 dw       x^T: x [N, K] MN-major A (transpose bit), dy MN-major.
//  K8: tiles are (128-row tile, 256-column tile), row tile major, so the
//      blocks in flight share a few row tiles of a and one expert's w in
//      L2.  A row tile lies inside one expert: every group size is a
//      multiple of block_rows, a multiple of 128 (the wrapper checks the
//      latter).  The block finds the expert on the device, by a binary
//      search of the experts' row ends (the TPU kernel's searchsorted).
//  K9: work units are (expert, 128-row tile of dw, 256-column tile), the
//      largest experts' units first (each block ranks the group sizes), so
//      no long reduction is left for the end.  A unit's block sums its
//      expert's rows in steps of 64 (group boundaries are multiples of
//      128), in a fixed order and with no atomics: dw is deterministic.
// * The experts' tables (each expert's first and end row, and K9's order
//   of the experts) take any number of experts.  A one-block pre-pass in
//   the same stream writes them to a [3, E] int32 workspace in global
//   memory: the group sizes loaded by a strided loop, one prefix sum by
//   warp 0 (a chunk a lane and a shuffle scan of the chunk sums), and
//   K9's ranks by a strided loop.  The persistent blocks read them there
//   (a few hundred bytes, held in L2).
// Widths must be multiples of 8 (16-byte rows for TMA and the stores).
// What holds it back still: every block streams its own operand tiles
// from L2, 48 KB for each 4.2 MFLOP step, about 7.7 TB/s across the card
// at the measured times; sharing the w tile between the two blocks of a
// cluster (TMA multicast) would cut that, but launched in clusters both
// kernels ran slower on an H100 (PERF.md, section 6).  The epilogue does
// not overlap the products: both consumers store while the tensor cores
// wait.

#include "flash_common.cuh"
#include "gemm_hopper.cuh"

using namespace hopper;

namespace {

constexpr int BM = 128;        // output tile rows: two consumer warpgroups
constexpr int BN = 256;        // output tile columns (a half tile: 128)
constexpr int BK = 64;         // reduction step: one 128-byte swizzle row
constexpr int STAGES = 4;      // depth of the TMA ring
constexpr int THREADS = 3 * WG_THREADS;  // producer + two consumers
constexpr uint32_t SMEM_LIMIT = 232448;  // a block's most, H100
constexpr int PRODUCER_REGS = 40, CONSUMER_REGS = 232;
constexpr uint32_t A_BYTES = BM * BK * 2;          // 16 KB
constexpr uint32_t BOX_BYTES = BOX_COLS * BK * 2;  // one 64 x 64 box, 8 KB
constexpr int KIND_FWD = 0, KIND_DX = 1, KIND_DW = 2;
constexpr uint32_t B_BYTES = BN * BK * 2;          // 32 KB
constexpr uint32_t B_HALF = BN / 2 * ROW_BYTES;    // dx: 128 rows of w
constexpr uint32_t STAGE_BYTES = A_BYTES + B_BYTES;

// Shared memory of a block: the ring (stage s: the A tile, then the B
// tile), full[STAGES] and empty[STAGES] mbarriers; 1024 bytes of
// alignment slack.
constexpr uint32_t BAR_OFF = STAGES * STAGE_BYTES;
constexpr uint32_t SMEM_BYTES = BAR_OFF + 16 * STAGES + 1024;
static_assert(SMEM_BYTES <= SMEM_LIMIT, "the ring does not fit");

}  // namespace

// The launch as the host plans it (ops/grouped_matmul.py gmm_launch_plan,
// whose ctypes mirror lists these fields in this order): the tile, ring
// and shared memory the kernel is built for, which the entry points check,
// then the walk, which the kernel reads.
struct GmmPlan {
  int block_m, block_n, block_k, stages, smem_bytes;
  int row_tiles;       // ceil(output rows / block_m)
  int col_tiles;       // ceil(output columns / block_n)
  int tiles;           // K8 row_tiles * col_tiles; K9 E times that
  int grid;            // persistent blocks, at most one per SM
};

namespace {

struct GmmParams {
  const int* tables;   // [3, E] start, end, K9 order (the pre-pass's)
  bf16* out;           // K8: [N, n_cols]; K9: [E, n_rows, n_cols]
  int n_rows;          // output rows: K8 N, K9 K
  int n_cols;          // output columns
  int n_red;           // K8: the reduction; K9: N, the token rows
  int E;
  int row_tiles, col_tiles, tiles;  // from the plan
};

// Work unit of round `round` for block `block` of `blocks` (the snake).
__device__ __forceinline__ int unit_index(int round, int block, int blocks) {
  return round * blocks + (round % 2 == 0 ? block : blocks - 1 - block);
}

// The expert owning row `row`: the first e with row < end[e] (the ends
// never decrease: a binary search), clamped to the last expert (rows past
// the groups are padding).
__device__ __forceinline__ int expert_of_row(const int* end, int E, int row) {
  int lo = 0, hi = E;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (row < end[mid]) {
      hi = mid;
    } else {
      lo = mid + 1;
    }
  }
  return lo < E ? lo : E - 1;
}

// The pre-pass: one block writes the experts' tables to `tables` [3, E]
// (start, end, order): expert e owns rows [start[e], end[e]), clipped to
// the n_tok token rows; the last expert also the padding rows up to n_tok,
// unless it owns no rows (its dw is then 0).  With `rank`, order[] lists
// the experts by rows owned, largest first, ties by index (K8 reads no
// order).  The block's barriers make its global writes visible to it.
__global__ void __launch_bounds__(THREADS, 1)
expert_tables_kernel(const int* gs, int E, int n_tok, int* tables,
                     int rank) {
  int* start = tables;
  int* end = tables + E;
  int* order = tables + 2 * E;
  const int tid = threadIdx.x;
  for (int e = tid; e < E; e += THREADS) end[e] = gs[e];
  __syncthreads();
  if (tid < 32) {
    // Lane l sums the chunk [l C, l C + C); a shuffle scan gives the rows
    // before each chunk; the lane then walks its chunk once more.
    const int chunk = (E + 31) / 32;
    const int lo = min(tid * chunk, E), hi = min(lo + chunk, E);
    long long sum = 0;
    for (int e = lo; e < hi; ++e) sum += end[e];
    long long incl = sum;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const long long v = __shfl_up_sync(0xffffffffu, incl, off);
      if (tid >= off) incl += v;
    }
    long long before = incl - sum;
    for (int e = lo; e < hi; ++e) {
      const int size = end[e];
      long long stop = before + size;
      if (e == E - 1 && size > 0) stop = n_tok;
      const int first = static_cast<int>(before < n_tok ? before : n_tok);
      start[e] = first;
      end[e] = static_cast<int>(stop < first ? first
                                             : (stop < n_tok ? stop : n_tok));
      before += size;
    }
  }
  __syncthreads();
  if (!rank) return;
  for (int e = tid; e < E; e += THREADS) {
    const int own = end[e] - start[e];
    int r = 0;
    for (int i = 0; i < E; ++i) {
      const int other = end[i] - start[i];
      r += other > own || (other == own && i < e);
    }
    order[r] = e;
  }
}

// Four 4-byte pieces v[q] (piece t of chunk q, t this thread's place in its
// quad) become chunk t's four pieces, w[i] = piece i of chunk t: a 4 x 4
// transpose across the quad in two exchange rounds.
__device__ __forceinline__ void quad_transpose(const uint32_t (&v)[4],
                                               uint32_t (&w)[4], int t) {
  const bool b1 = (t >> 1) & 1, b0 = t & 1;
  uint32_t a[2][2];  // a[j][h]: chunk 2 b1 + j, piece 2 h + b0
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const uint32_t keep = b1 ? v[2 + j] : v[j];
    const uint32_t send = b1 ? v[j] : v[2 + j];
    const uint32_t got = __shfl_xor_sync(0xffffffffu, send, 2);
    a[j][0] = b1 ? got : keep;
    a[j][1] = b1 ? keep : got;
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const uint32_t keep = b0 ? a[1][h] : a[0][h];
    const uint32_t send = b0 ? a[0][h] : a[1][h];
    const uint32_t got = __shfl_xor_sync(0xffffffffu, send, 1);
    w[2 * h] = b0 ? got : keep;
    w[2 * h + 1] = b0 ? keep : got;
  }
}

// KIND_FWD / KIND_DX: out [N, n_cols] = a [N, n_red] times w[e] ([n_red,
// n_cols], or [n_cols, n_red] read transposed).  KIND_DW: dw[e] [n_rows,
// n_cols] = x[rows of e]^T dy[rows of e], x [N, n_rows], dy [N, n_cols].
// a_map / b_map: the operand maps (see the entry points).
template <int KIND>
__global__ void __launch_bounds__(THREADS, 1)
gmm_kernel(const __grid_constant__ CUtensorMap a_map,
           const __grid_constant__ CUtensorMap b_map, const GmmParams p) {
  constexpr int TRANS_A = KIND == KIND_DW ? 1 : 0;
  constexpr int TRANS_B = KIND == KIND_DX ? 0 : 1;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align_1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + BAR_OFF);
  uint64_t* empty = full + STAGES;
  const int tid = threadIdx.x;

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);  // one arrival per consumer warp
    }
    mbar_init_fence();
  }
  // The experts' first and end rows, and (K9) their order by rows owned,
  // largest first: the pre-pass's tables.
  const int* g_start = p.tables;
  const int* g_end = p.tables + p.E;
  const int* g_order = p.tables + 2 * p.E;
  __syncthreads();  // the mbarriers' init, before any thread uses them

  // The work unit `tile`: its expert, output origin and reduction range.
  struct Unit {
    int e, row0, col0, red0, steps;
    bool half;  // at most BN / 2 columns left: a half-width tile
  };
  auto unit_of = [&](int tile) {
    Unit u;
    if (KIND == KIND_DW) {
      const int per_expert = p.row_tiles * p.col_tiles;
      u.e = g_order[tile / per_expert];
      const int t = tile % per_expert;
      u.row0 = (t / p.col_tiles) * BM;
      u.col0 = (t % p.col_tiles) * BN;
      u.red0 = g_start[u.e];
      u.steps = (g_end[u.e] - u.red0 + BK - 1) / BK;
    } else {
      u.row0 = (tile / p.col_tiles) * BM;
      u.col0 = (tile % p.col_tiles) * BN;
      u.e = expert_of_row(g_end, p.E, u.row0);
      u.red0 = 0;
      u.steps = (p.n_red + BK - 1) / BK;
    }
    u.half = p.n_cols - u.col0 <= BN / 2;
    return u;
  };

  const int wg = tid / WG_THREADS;
  if (wg == 0) {
    // Producer: one thread issues every load, STAGES tiles ahead of the
    // consumers, across the block's work units.
    regs_dec<PRODUCER_REGS>();
    if (tid != 0) return;
    int it = 0;
    for (int round = 0;; ++round) {
      const int tile = unit_index(round, blockIdx.x, gridDim.x);
      if (tile >= p.tiles) break;
      const Unit u = unit_of(tile);
      for (int k = 0; k < u.steps; ++k, ++it) {
        const int s = it % STAGES;
        if (it >= STAGES) mbar_wait(&empty[s], ((it / STAGES) + 1) & 1);
        // A half tile loads the first half of the w (dy) tile only.
        const int b_parts = u.half ? 1 : 2;
        mbar_expect_tx(&full[s], A_BYTES + b_parts * B_BYTES / 2);
        unsigned char* as = smem + s * STAGE_BYTES;
        unsigned char* bs = as + A_BYTES;
        const int red = u.red0 + k * BK;
        if (KIND == KIND_DW) {
          tma_load_2d(as, &a_map, &full[s], u.row0, red);
          tma_load_2d(as + BOX_BYTES, &a_map, &full[s], u.row0 + BOX_COLS,
                      red);
        } else {
          tma_load_2d(as, &a_map, &full[s], red, u.row0);
        }
        if (KIND == KIND_DX) {
          // Two boxes of BN / 2 rows of w read as [cols, red].
          for (int j = 0; j < b_parts; ++j) {
            tma_load_3d(bs + j * B_HALF, &b_map, &full[s], red,
                        u.col0 + j * (BN / 2), u.e);
          }
        } else {
          for (int j = 0; j < b_parts * BN / BOX_COLS / 2; ++j) {
            const int col = u.col0 + j * BOX_COLS;
            if (KIND == KIND_DW) {
              tma_load_2d(bs + j * BOX_BYTES, &b_map, &full[s], col, red);
            } else {
              tma_load_3d(bs + j * BOX_BYTES, &b_map, &full[s], col, red,
                          u.e);
            }
          }
        }
      }
    }
    return;
  }

  // Consumers: warpgroup cw owns rows [64 cw, 64 cw + 64) of each tile.
  regs_inc<CONSUMER_REGS>();
  const int cw = wg - 1;
  const int warp = (tid % WG_THREADS) / 32;
  const int lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  float acc[BN / 2];
  int it = 0;
  for (int round = 0;; ++round) {
    const int tile = unit_index(round, blockIdx.x, gridDim.x);
    if (tile >= p.tiles) break;
    const Unit u = unit_of(tile);
    if (u.steps == 0) {
#pragma unroll
      for (int j = 0; j < BN / 2; ++j) acc[j] = 0.f;
    }
    for (int k = 0; k < u.steps; ++k, ++it) {
      const int s = it % STAGES;
      mbar_wait(&full[s], (it / STAGES) & 1);
      const uint32_t a_addr = smem_u32(smem + s * STAGE_BYTES) +
                              cw * (KIND == KIND_DW ? BOX_BYTES
                                                    : BOX_COLS * ROW_BYTES);
      const uint32_t b_addr = smem_u32(smem + s * STAGE_BYTES + A_BYTES);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        const uint64_t da =
            TRANS_A ? desc_mnmajor(a_addr + kk * 2048, BOX_BYTES)
                    : desc_kmajor(a_addr + kk * 32);
        const uint64_t db =
            TRANS_B ? desc_mnmajor(b_addr + kk * 2048, BOX_BYTES)
                    : desc_kmajor(b_addr + kk * 32);
        if (u.half) {
          // Columns 0-127 of the tile: the first half of the accumulators,
          // laid out as an m64n128 product's.
          wgmma_ss<TRANS_A, TRANS_B>(
              *reinterpret_cast<float(*)[BN / 4]>(acc), da, db,
              k > 0 || kk > 0);
        } else {
          wgmma_ss<TRANS_A, TRANS_B>(acc, da, db, k > 0 || kk > 0);
        }
      }
      wgmma_commit();
      if (k > 0) {
        // Step k - 1's products are done: free its stage.
        wgmma_wait<1>();
        __syncwarp();
        if (lane == 0) mbar_arrive(&empty[(it - 1) % STAGES]);
      }
    }
    wgmma_wait<0>();
    fence_regs(acc);
    if (u.steps > 0) {
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[(it - 1) % STAGES]);
    }

    // Epilogue: rows row0 + 64 cw + 16 warp + g (+ 8), columns col0 + 8 c
    // + 2 t (+ 1) of the accumulators, as bf16; after the quad transpose
    // this thread holds row r (below), columns col (below) .. + 7.
    bf16* out = p.out;
    if (KIND == KIND_DW) {
      out += static_cast<long long>(u.e) * p.n_rows * p.n_cols;
    }
    const int r = u.row0 + cw * 64 + warp * 16 + g + 8 * (t & 1);
#pragma unroll
    for (int c2 = 0; c2 < BN / 16; ++c2) {
      if (u.half && c2 == BN / 32) break;
      uint32_t v[4], w[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int j = 4 * (2 * c2 + q / 2) + 2 * (q % 2);
        v[q] = pack_bf16(acc[j], acc[j + 1]);
      }
      quad_transpose(v, w, t);
      const int col = u.col0 + 8 * (2 * c2 + (t >> 1));
      if (r < p.n_rows && col < p.n_cols) {
        *reinterpret_cast<uint4*>(out + static_cast<long long>(r) * p.n_cols +
                                  col) = make_uint4(w[0], w[1], w[2], w[3]);
      }
    }
  }
}

// The pre-pass into `tables`, then the kernel, on one stream.
template <int KIND>
int launch(const CUtensorMap& a_map, const CUtensorMap& b_map, GmmParams p,
           const void* gs, void* tables, const GmmPlan& plan,
           cudaStream_t stream) {
  if (plan.block_m != BM || plan.block_n != BN || plan.block_k != BK ||
      plan.stages != STAGES ||
      static_cast<uint32_t>(plan.smem_bytes) != SMEM_BYTES ||
      plan.tiles <= 0 || plan.grid <= 0 || plan.grid > plan.tiles) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  static bool opted_in[64] = {};
  cudaError_t err =
      flash::opt_in_smem(gmm_kernel<KIND>, SMEM_BYTES, opted_in);
  if (err != cudaSuccess) return static_cast<int>(err);
  expert_tables_kernel<<<1, THREADS, 0, stream>>>(
      static_cast<const int*>(gs), p.E,
      KIND == KIND_DW ? p.n_red : p.n_rows, static_cast<int*>(tables),
      KIND == KIND_DW);
  p.tables = static_cast<const int*>(tables);
  p.row_tiles = plan.row_tiles;
  p.col_tiles = plan.col_tiles;
  p.tiles = plan.tiles;
  gmm_kernel<KIND><<<plan.grid, THREADS, SMEM_BYTES, stream>>>(a_map, b_map,
                                                               p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// K8.  a [N, n_red] bf16 with row stride lda (unit column stride); w bf16
// with expert stride w_se: [E, n_red, n_cols] row stride ldb (trans_w 0)
// or [E, n_cols, n_red] row stride ldb (trans_w 1, the product against
// w^T); group_sizes [E] int32 on the device; tables a [3, E] int32
// workspace on the device, which the pre-pass fills; out [N, n_cols]
// contiguous bf16.  n_red, n_cols, lda, ldb and w_se multiples of
// 8, pointers 16-byte aligned, every group a multiple of 128 rows; plan
// from the host.  Returns cudaGetLastError() after the launch (0 = ok).
extern "C" int gmm_bf16(const void* a, const void* w, const void* group_sizes,
                        void* tables, void* out, int N, int n_red,
                        int n_cols, int E, int trans_w, long long lda,
                        long long ldb, long long w_se, const GmmPlan* plan,
                        void* stream) {
  if (N <= 0 || n_red <= 0 || n_cols <= 0 || E <= 0 || tables == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  CUtensorMap a_map, b_map;
  const unsigned long long a_dims[2] = {static_cast<unsigned long long>(n_red),
                                        static_cast<unsigned long long>(N)};
  const unsigned long long a_strides[1] = {
      static_cast<unsigned long long>(lda) * 2};
  const unsigned a_box[2] = {BOX_COLS, BM};
  cudaError_t err = make_tiled_map(&a_map, a, 2, a_dims, a_strides, a_box);
  if (err != cudaSuccess) return static_cast<int>(err);
  // w as 3-D (inner, outer, expert): a box never reads into the next
  // expert, and its rows past the reduction or the columns read as zeros.
  const unsigned long long inner = trans_w ? n_red : n_cols;
  const unsigned long long outer = trans_w ? n_cols : n_red;
  const unsigned long long w_dims[3] = {inner, outer,
                                        static_cast<unsigned long long>(E)};
  const unsigned long long w_strides[2] = {
      static_cast<unsigned long long>(ldb) * 2,
      static_cast<unsigned long long>(w_se) * 2};
  const unsigned w_box[3] = {BOX_COLS,
                             static_cast<unsigned>(trans_w ? BN / 2 : BK),
                             1u};
  err = make_tiled_map(&b_map, w, 3, w_dims, w_strides, w_box);
  if (err != cudaSuccess) return static_cast<int>(err);
  GmmParams p = {};
  p.out = static_cast<bf16*>(out);
  p.n_rows = N;
  p.n_cols = n_cols;
  p.n_red = n_red;
  p.E = E;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return trans_w ? launch<KIND_DX>(a_map, b_map, p, group_sizes, tables,
                                   *plan, s)
                 : launch<KIND_FWD>(a_map, b_map, p, group_sizes, tables,
                                    *plan, s);
}

// K9.  x [N, K] and dy [N, M] contiguous bf16, group_sizes [E] int32 on
// the device, tables as for K8, dw [E, K, M] contiguous bf16 (every
// element written).  K and M multiples of 8, pointers 16-byte aligned,
// every group a multiple of 128 rows; plan from the host.  Returns
// cudaGetLastError() after the launch (0 = ok).
extern "C" int gmm_dw_bf16(const void* x, const void* dy,
                           const void* group_sizes, void* tables,
                           void* dw, int N, int K, int M, int E,
                           const GmmPlan* plan, void* stream) {
  if (N <= 0 || K <= 0 || M <= 0 || E <= 0 || tables == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  CUtensorMap x_map, dy_map;
  const unsigned box[2] = {BOX_COLS, BK};
  const unsigned long long x_dims[2] = {static_cast<unsigned long long>(K),
                                        static_cast<unsigned long long>(N)};
  const unsigned long long x_strides[1] = {
      static_cast<unsigned long long>(K) * 2};
  cudaError_t err = make_tiled_map(&x_map, x, 2, x_dims, x_strides, box);
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned long long dy_dims[2] = {static_cast<unsigned long long>(M),
                                         static_cast<unsigned long long>(N)};
  const unsigned long long dy_strides[1] = {
      static_cast<unsigned long long>(M) * 2};
  err = make_tiled_map(&dy_map, dy, 2, dy_dims, dy_strides, box);
  if (err != cudaSuccess) return static_cast<int>(err);
  GmmParams p = {};
  p.out = static_cast<bf16*>(dw);
  p.n_rows = K;
  p.n_cols = M;
  p.n_red = N;
  p.E = E;
  return launch<KIND_DW>(x_map, dy_map, p, group_sizes, tables, *plan,
                         static_cast<cudaStream_t>(stream));
}
