// Flash-attention backward for Hopper (sm_90a): bf16 in and out, fp32
// products and statistics.  Three kernels behind one C entry point:
//
//   kind 0  dq     replaces dlrover_tpu/ops/flash_attention.py:246
//                  _bwd_dq_kernel (K2a, pl.pallas_call at :459)
//   kind 1  dkv    replaces dlrover_tpu/ops/flash_attention.py:278
//                  _bwd_dkv_kernel (K2b, pl.pallas_call at :496)
//   kind 2  fused  replaces dlrover_tpu/ops/flash_attention.py:318
//                  _bwd_fused_kernel (K3, pl.pallas_call at :386)
//
// Same function as the TPU kernels (_recompute_p_ds, :206): from the
// forward's lse, p = mask ? exp(q k^T * scale - lse) : 0 (the mask gates
// p, never the value of the score: a fully masked row has lse = -1e30 and
// gives exactly zero); delta = rowsum(o * do); ds = p (do v^T - delta)
// scale, rounded to bf16 like p before their products, as the TPU kernels
// round at :242 and :304; dq = ds k, dk = ds^T q, dv = p^T do, with GQA
// dk/dv summed over each kv head's group of q heads.
//
// What bounds them on this card: at the GPT-2 1.5B training shape (B 16,
// H 25, S 1024, D 64, causal) one backward does five S x S x D products
// per (b, h), halved by causality: 1.34e11 FLOP, 0.136 ms at 989 TFLOP/s;
// its bytes (q, k, v, o, do read once, dq, dk, dv written once) are about
// 0.42 GB, 0.125 ms at 3.35 TB/s.  So the bound is the tensor cores, and
// what counts is keeping the S x S matrices out of device memory and the
// five products on the tensor cores at a good rate.
//
// K3 (kind 2) is built for Hopper (flash_hopper.cuh holds the pieces):
// * A pre-pass (flash_bwd_prep_kernel) computes delta = rowsum(o * do) in
//   fp32 once per row with 16-byte loads, writes it and lse * log2(e) into
//   [B, Hq, Sq rounded up to 64] buffers (0 past Sq), and zeroes the fp32
//   dq accumulator.  (The TPU kernel computes delta inside, for a TPU
//   reason: an extra XLA fusion cost about 1 ms a layer there, :215-220.)
// * The main kernel runs one block per (batch, kv head, kv tile): 128 kv
//   rows at D 64 (two warpgroups of 64 rows), 64 at D 128 (one: its dk and
//   dv accumulators take 128 registers a thread).  The kv tiles are
//   launched first to last, the heaviest first under causal masking.  K
//   and V stay in shared memory; (Q, dO) tiles of 64 rows with their lse
//   and delta rows stream through a 3-stage ring (TMA over the strided
//   views, bulk copies for the rows, full / empty mbarriers), for every q
//   head of the group and every q tile from the diagonal on.  Thread 0
//   issues the loads, two pairs ahead of the products, so no producer warp
//   takes registers from the consumers.
// * Per (q tile, warpgroup): S^T = K Q^T and dP^T = V dO^T are wgmmas
//   from shared memory with fp32 results in registers; P^T and dS^T are
//   built there and are the register A operands of dV += P^T dO and
//   dK += dS^T Q (dO and Q through the transpose bit), so dK and dV
//   accumulate in registers over the whole loop.  Only dS^T (bf16) goes to
//   shared memory, for dQ = dS K (both operands through the transpose
//   bit); each warpgroup adds its 64 x D partial of dQ into the fp32
//   accumulator with 16-byte vector reductions (sm_90's float4
//   atomicAdd, one per thread and 8 columns), never a scalar atomic.
//   Masks are evaluated only on the causal diagonal, the ragged edges and
//   when segment ids are given; a warpgroup skips q tiles wholly above
//   its diagonal.
// dq's reductions land in varying order, so dq is reproducible only to
// fp32 rounding; dk and dv are summed in a fixed order, bit for bit.  What
// holds K3 back still: each warpgroup runs its five products and the
// elementwise work in sequence (no ping-pong between the warpgroups, no
// overlap of the next tile's S^T with this tile's dS work), the two
// warpgroups' dQ partials go to device memory separately, and one block
// fits on an SM (its registers).
//
// K2a / K2b (kinds 0 and 1, the split path) keep the first, simple design:
// wmma 16x16x16 from shared memory, scores and probabilities staged in
// shared memory, no overlap of loads with products.  Nothing carries
// across blocks on this card, so the TPU's sequential grid axis becomes a
// loop inside the block:
// * dkv: one block of 4 warps per (b, kv head, 64-row kv tile) loops over
//   its group's q heads and the q tiles that can see the tile.  Warp w owns
//   kv columns 16w..16w+15 of every (64 x 64) score tile, so s, dp, p, ds
//   and the dv += p^T do, dk += ds^T q updates are all warp-local; dk and
//   dv accumulate in registers.  delta is computed per q tile from o.
// * dq: one block per (b, q head, 64-row q tile) loops over the kv tiles
//   it can see; warp w owns q rows 16w.., so everything is warp-local and
//   dq accumulates in registers.

#include "flash_common.cuh"
#include "flash_hopper.cuh"

using namespace flash;
using namespace hopper;

namespace {

struct BwdParams {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  const bf16* o;
  const bf16* dout;
  const float* lse;    // [B, Hq, Sq]
  const int* seg_q;    // [B, Sq] or null
  const int* seg_kv;   // [B, Skv] or null
  bf16* dq;            // [B, Sq, Hq, D]
  bf16* dk;            // [B, Skv, Hkv, D]
  bf16* dv;
  int B, Sq, Skv, Hq, Hkv, group;
  long long q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh;
  long long o_sb, o_ss, o_sh, do_sb, do_ss, do_sh;
  long long segq_sb, segkv_sb;
  float scale;
  int causal;
};

// Shared-memory plan.  Four bf16 row tiles (the block's fixed pair and
// the pair streamed by its loop), fp32 scores and dp, bf16 p and ds, and
// per-row statistics.  Leading dimensions are padded as in the forward
// (wmma: multiples of 8 bf16 / 4 fp32, 32-byte aligned fragment
// pointers).  The fp32 result rows (dk, dv, dq) are staged through the
// score and dp tiles, which are contiguous and large enough.
template <int D>
struct BwdSmem {
  static constexpr int LD_T = D + 8;        // [64, D] bf16 tiles
  static constexpr int LD_S = BLOCK_N + 4;  // [64, 64] fp32 tiles
  static constexpr int LD_P = BLOCK_N + 8;  // [64, 64] bf16 tiles
  static constexpr int LD_ACC = D + 4;      // fp32 staging rows
  static constexpr size_t TILE = sizeof(bf16) * 64 * LD_T;
  static constexpr size_t A_OFF = 0;
  static constexpr size_t B_OFF = A_OFF + TILE;
  static constexpr size_t C_OFF = B_OFF + TILE;
  static constexpr size_t E_OFF = C_OFF + TILE;
  static constexpr size_t S_OFF = E_OFF + TILE;
  static constexpr size_t DP_OFF = S_OFF + sizeof(float) * 64 * LD_S;
  static constexpr size_t P_OFF = DP_OFF + sizeof(float) * 64 * LD_S;
  static constexpr size_t DS_OFF = P_OFF + sizeof(bf16) * 64 * LD_P;
  static constexpr size_t ROW_OFF = DS_OFF + sizeof(bf16) * 64 * LD_P;
  static constexpr size_t SEG_OFF = ROW_OFF + sizeof(float) * 2 * 64;
  static constexpr size_t BYTES = SEG_OFF + sizeof(int) * 2 * 64;
  static_assert(2 * sizeof(float) * 64 * LD_S >= sizeof(float) * 64 * LD_ACC,
                "staging rows must fit in the score and dp tiles");
};

typedef wmma::fragment<wmma::accumulator, 16, 16, 16, float> Acc;
typedef wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> ARow;
typedef wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major> ACol;
typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> BRow;
typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> BCol;

// lse and segment id of the q tile's rows (threads 0..63).
__device__ __forceinline__ void load_q_rows(const BwdParams& p, int b, int h,
                                            int q0, float* lse_s,
                                            int* segq_s, int tid) {
  if (tid < BLOCK_M) {
    const int qi = q0 + tid;
    const bool in = qi < p.Sq;
    lse_s[tid] =
        in ? p.lse[(static_cast<long long>(b) * p.Hq + h) * p.Sq + qi] : 0.f;
    segq_s[tid] = p.seg_q ? (in ? p.seg_q[b * p.segq_sb + qi] : -1) : 0;
  }
}

// Segment id of the kv tile's rows (threads 0..63).
__device__ __forceinline__ void load_kv_rows(const BwdParams& p, int b,
                                             int n0, int* segkv_s, int tid) {
  if (tid < BLOCK_N) {
    const int kj = n0 + tid;
    segkv_s[tid] =
        p.seg_kv ? (kj < p.Skv ? p.seg_kv[b * p.segkv_sb + kj] : -2) : 0;
  }
}

// delta = rowsum(o * do) for the 16 rows [r0, r0 + 16) of the q tile at
// q0 of head h: o read from device memory, do from its shared tile.
template <int D>
__device__ __forceinline__ void warp_delta(const BwdParams& p,
                                           const bf16* dOs, int b, int h,
                                           int q0, int r0, float* delta_s,
                                           int lane) {
  constexpr int LD_T = BwdSmem<D>::LD_T;
  const bf16* ob = p.o + b * p.o_sb + h * p.o_sh;
  for (int rr = 0; rr < ROWS_PER_WARP; ++rr) {
    const int r = r0 + rr;
    const int qi = q0 + r;
    float acc = 0.f;
    if (qi < p.Sq) {
      for (int c = lane; c < D; c += 32) {
        acc += __bfloat162float(ob[qi * p.o_ss + c]) *
               __bfloat162float(dOs[r * LD_T + c]);
      }
    }
    acc = warp_sum(acc);
    if (lane == 0) delta_s[r] = acc;
  }
}

// p and ds of one score element; writes both as bf16.
__device__ __forceinline__ void p_ds(const BwdParams& p, bool live, float s,
                                     float dp, float lse, float delta,
                                     bf16* p_out, bf16* ds_out) {
  const float pv = live ? expf(s * p.scale - lse) : 0.f;
  *p_out = __float2bfloat16(pv);
  *ds_out = __float2bfloat16(pv * (dp - delta) * p.scale);
}

__device__ __forceinline__ bool is_live(const BwdParams& p, int qi, int kj,
                                        int seg_q, int seg_kv) {
  return qi < p.Sq && kj < p.Skv && (!p.causal || kj <= qi) &&
         seg_q == seg_kv;
}

// Write 16 fp32 staging rows [r0, r0 + 16) as bf16 into a contiguous
// [B, S, H, D] output at (b, row base s0, head hh), rows below n_rows.
template <int D>
__device__ __forceinline__ void write_rows(bf16* out, const float* stage,
                                           int r0, int b, int s0, int hh,
                                           int n_rows, int n_heads,
                                           int lane) {
  constexpr int LD_ACC = BwdSmem<D>::LD_ACC;
  for (int i = lane; i < ROWS_PER_WARP * D; i += 32) {
    const int r = r0 + i / D;
    const int c = i % D;
    const int gr = s0 + r;
    if (gr < n_rows) {
      out[((static_cast<long long>(b) * n_rows + gr) * n_heads + hh) * D +
          c] = __float2bfloat16(stage[r * LD_ACC + c]);
    }
  }
}

// dkv: one block per (kv tile, kv head, batch).
template <int D>
__global__ void __launch_bounds__(THREADS)
flash_bwd_kv_kernel(const BwdParams p) {
  using L = BwdSmem<D>;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Ks = reinterpret_cast<bf16*>(smem + L::A_OFF);
  bf16* Vs = reinterpret_cast<bf16*>(smem + L::B_OFF);
  bf16* Qs = reinterpret_cast<bf16*>(smem + L::C_OFF);
  bf16* dOs = reinterpret_cast<bf16*>(smem + L::E_OFF);
  float* Ss = reinterpret_cast<float*>(smem + L::S_OFF);
  float* DPs = reinterpret_cast<float*>(smem + L::DP_OFF);
  bf16* Ps = reinterpret_cast<bf16*>(smem + L::P_OFF);
  bf16* DSs = reinterpret_cast<bf16*>(smem + L::DS_OFF);
  float* lse_s = reinterpret_cast<float*>(smem + L::ROW_OFF);
  float* delta_s = lse_s + BLOCK_M;
  int* segq_s = reinterpret_cast<int*>(smem + L::SEG_OFF);
  int* segkv_s = segq_s + BLOCK_M;
  float* stage = Ss;  // fp32 result rows, LD_ACC; aliases Ss and DPs

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int n0 = blockIdx.x * BLOCK_N;
  const int hk = blockIdx.y;
  const int b = blockIdx.z;
  const int c0 = warp * 16;  // this warp's kv columns of the tile

  load_tile<D, BLOCK_N, L::LD_T>(Ks, p.k + b * p.k_sb + hk * p.k_sh, p.k_ss,
                                 n0, p.Skv, tid);
  load_tile<D, BLOCK_N, L::LD_T>(Vs, p.v + b * p.v_sb + hk * p.v_sh, p.v_ss,
                                 n0, p.Skv, tid);
  load_kv_rows(p, b, n0, segkv_s, tid);

  Acc dk_acc[D / 16], dv_acc[D / 16];
#pragma unroll
  for (int nt = 0; nt < D / 16; ++nt) {
    wmma::fill_fragment(dk_acc[nt], 0.f);
    wmma::fill_fragment(dv_acc[nt], 0.f);
  }

  // Causal (rows >= cols, top-left aligned): q rows below n0 see nothing
  // of this tile, so the q loop starts at the diagonal tile.
  const int q_begin = p.causal ? n0 : 0;
  for (int g = 0; g < p.group; ++g) {
    const int h = hk * p.group + g;
    const bf16* qb = p.q + b * p.q_sb + h * p.q_sh;
    const bf16* dob = p.dout + b * p.do_sb + h * p.do_sh;
    for (int q0 = q_begin; q0 < p.Sq; q0 += BLOCK_M) {
      __syncthreads();  // the previous tile's reads are finished
      load_tile<D, BLOCK_M, L::LD_T>(Qs, qb, p.q_ss, q0, p.Sq, tid);
      load_tile<D, BLOCK_M, L::LD_T>(dOs, dob, p.do_ss, q0, p.Sq, tid);
      load_q_rows(p, b, h, q0, lse_s, segq_s, tid);
      __syncthreads();
      warp_delta<D>(p, dOs, b, h, q0, warp * ROWS_PER_WARP, delta_s, lane);
      __syncthreads();

      // s and dp for this warp's 16 columns, all 64 rows.
#pragma unroll
      for (int mi = 0; mi < BLOCK_M / 16; ++mi) {
        Acc acc_s, acc_dp;
        wmma::fill_fragment(acc_s, 0.f);
        wmma::fill_fragment(acc_dp, 0.f);
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          ARow a;
          BCol bt;
          wmma::load_matrix_sync(a, Qs + mi * 16 * L::LD_T + kk * 16,
                                 L::LD_T);
          wmma::load_matrix_sync(bt, Ks + c0 * L::LD_T + kk * 16, L::LD_T);
          wmma::mma_sync(acc_s, a, bt, acc_s);
          wmma::load_matrix_sync(a, dOs + mi * 16 * L::LD_T + kk * 16,
                                 L::LD_T);
          wmma::load_matrix_sync(bt, Vs + c0 * L::LD_T + kk * 16, L::LD_T);
          wmma::mma_sync(acc_dp, a, bt, acc_dp);
        }
        wmma::store_matrix_sync(Ss + mi * 16 * L::LD_S + c0, acc_s, L::LD_S,
                                wmma::mem_row_major);
        wmma::store_matrix_sync(DPs + mi * 16 * L::LD_S + c0, acc_dp,
                                L::LD_S, wmma::mem_row_major);
      }
      __syncwarp();

      for (int i = lane; i < BLOCK_M * 16; i += 32) {
        const int r = i / 16;
        const int c = c0 + i % 16;
        const bool live =
            is_live(p, q0 + r, n0 + c, segq_s[r], segkv_s[c]);
        p_ds(p, live, Ss[r * L::LD_S + c], DPs[r * L::LD_S + c], lse_s[r],
             delta_s[r], Ps + r * L::LD_P + c, DSs + r * L::LD_P + c);
      }
      __syncwarp();

      // dv += p^T do and dk += ds^T q for this warp's 16 kv rows.
#pragma unroll
      for (int nt = 0; nt < D / 16; ++nt) {
#pragma unroll
        for (int kk = 0; kk < BLOCK_M / 16; ++kk) {
          ACol at;
          BRow bm;
          wmma::load_matrix_sync(at, Ps + kk * 16 * L::LD_P + c0, L::LD_P);
          wmma::load_matrix_sync(bm, dOs + kk * 16 * L::LD_T + nt * 16,
                                 L::LD_T);
          wmma::mma_sync(dv_acc[nt], at, bm, dv_acc[nt]);
          wmma::load_matrix_sync(at, DSs + kk * 16 * L::LD_P + c0, L::LD_P);
          wmma::load_matrix_sync(bm, Qs + kk * 16 * L::LD_T + nt * 16,
                                 L::LD_T);
          wmma::mma_sync(dk_acc[nt], at, bm, dk_acc[nt]);
        }
      }
    }
  }

  // dk and dv rows [c0, c0 + 16) of the tile, staged through shared memory
  // to convert to bf16.
  __syncthreads();  // no warp still reads Ss / DPs, which stage aliases
#pragma unroll
  for (int nt = 0; nt < D / 16; ++nt) {
    wmma::store_matrix_sync(stage + c0 * L::LD_ACC + nt * 16, dk_acc[nt],
                            L::LD_ACC, wmma::mem_row_major);
  }
  __syncwarp();
  write_rows<D>(p.dk, stage, c0, b, n0, hk, p.Skv, p.Hkv, lane);
  __syncwarp();
#pragma unroll
  for (int nt = 0; nt < D / 16; ++nt) {
    wmma::store_matrix_sync(stage + c0 * L::LD_ACC + nt * 16, dv_acc[nt],
                            L::LD_ACC, wmma::mem_row_major);
  }
  __syncwarp();
  write_rows<D>(p.dv, stage, c0, b, n0, hk, p.Skv, p.Hkv, lane);
}

// dq: one block per (q tile, q head, batch).
template <int D>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dq_kernel(const BwdParams p) {
  using L = BwdSmem<D>;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem + L::A_OFF);
  bf16* dOs = reinterpret_cast<bf16*>(smem + L::B_OFF);
  bf16* Ks = reinterpret_cast<bf16*>(smem + L::C_OFF);
  bf16* Vs = reinterpret_cast<bf16*>(smem + L::E_OFF);
  float* Ss = reinterpret_cast<float*>(smem + L::S_OFF);
  float* DPs = reinterpret_cast<float*>(smem + L::DP_OFF);
  bf16* Ps = reinterpret_cast<bf16*>(smem + L::P_OFF);
  bf16* DSs = reinterpret_cast<bf16*>(smem + L::DS_OFF);
  float* lse_s = reinterpret_cast<float*>(smem + L::ROW_OFF);
  float* delta_s = lse_s + BLOCK_M;
  int* segq_s = reinterpret_cast<int*>(smem + L::SEG_OFF);
  int* segkv_s = segq_s + BLOCK_M;
  float* stage = Ss;

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int q0 = blockIdx.x * BLOCK_M;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / p.group;
  const int r0 = warp * ROWS_PER_WARP;  // this warp's q rows of the tile

  load_tile<D, BLOCK_M, L::LD_T>(Qs, p.q + b * p.q_sb + h * p.q_sh, p.q_ss,
                                 q0, p.Sq, tid);
  load_tile<D, BLOCK_M, L::LD_T>(dOs, p.dout + b * p.do_sb + h * p.do_sh,
                                 p.do_ss, q0, p.Sq, tid);
  load_q_rows(p, b, h, q0, lse_s, segq_s, tid);
  __syncthreads();
  warp_delta<D>(p, dOs, b, h, q0, r0, delta_s, lane);  // own rows only

  Acc dq_acc[D / 16];
#pragma unroll
  for (int nt = 0; nt < D / 16; ++nt) wmma::fill_fragment(dq_acc[nt], 0.f);

  const bf16* kb = p.k + b * p.k_sb + hk * p.k_sh;
  const bf16* vb = p.v + b * p.v_sb + hk * p.v_sh;
  // Causal: no row of this q tile sees a column past its last row.
  const int kv_end = p.causal ? min(p.Skv, q0 + BLOCK_M) : p.Skv;
  for (int n0 = 0; n0 < kv_end; n0 += BLOCK_N) {
    __syncthreads();  // the previous tile's K/V reads are finished
    load_tile<D, BLOCK_N, L::LD_T>(Ks, kb, p.k_ss, n0, p.Skv, tid);
    load_tile<D, BLOCK_N, L::LD_T>(Vs, vb, p.v_ss, n0, p.Skv, tid);
    load_kv_rows(p, b, n0, segkv_s, tid);
    __syncthreads();

    // s and dp for this warp's 16 rows, all 64 columns.
#pragma unroll
    for (int nt = 0; nt < BLOCK_N / 16; ++nt) {
      Acc acc_s, acc_dp;
      wmma::fill_fragment(acc_s, 0.f);
      wmma::fill_fragment(acc_dp, 0.f);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        ARow a;
        BCol bt;
        wmma::load_matrix_sync(a, Qs + r0 * L::LD_T + kk * 16, L::LD_T);
        wmma::load_matrix_sync(bt, Ks + nt * 16 * L::LD_T + kk * 16,
                               L::LD_T);
        wmma::mma_sync(acc_s, a, bt, acc_s);
        wmma::load_matrix_sync(a, dOs + r0 * L::LD_T + kk * 16, L::LD_T);
        wmma::load_matrix_sync(bt, Vs + nt * 16 * L::LD_T + kk * 16,
                               L::LD_T);
        wmma::mma_sync(acc_dp, a, bt, acc_dp);
      }
      wmma::store_matrix_sync(Ss + r0 * L::LD_S + nt * 16, acc_s, L::LD_S,
                              wmma::mem_row_major);
      wmma::store_matrix_sync(DPs + r0 * L::LD_S + nt * 16, acc_dp, L::LD_S,
                              wmma::mem_row_major);
    }
    __syncwarp();

    for (int i = lane; i < ROWS_PER_WARP * BLOCK_N; i += 32) {
      const int r = r0 + i / BLOCK_N;
      const int c = i % BLOCK_N;
      const bool live = is_live(p, q0 + r, n0 + c, segq_s[r], segkv_s[c]);
      p_ds(p, live, Ss[r * L::LD_S + c], DPs[r * L::LD_S + c], lse_s[r],
           delta_s[r], Ps + r * L::LD_P + c, DSs + r * L::LD_P + c);
    }
    __syncwarp();

    // dq += ds k for this warp's rows.
#pragma unroll
    for (int nt = 0; nt < D / 16; ++nt) {
#pragma unroll
      for (int kk = 0; kk < BLOCK_N / 16; ++kk) {
        ARow a;
        BRow bm;
        wmma::load_matrix_sync(a, DSs + r0 * L::LD_P + kk * 16, L::LD_P);
        wmma::load_matrix_sync(bm, Ks + kk * 16 * L::LD_T + nt * 16,
                               L::LD_T);
        wmma::mma_sync(dq_acc[nt], a, bm, dq_acc[nt]);
      }
    }
  }

  __syncthreads();  // no warp still reads Ss / DPs, which stage aliases
#pragma unroll
  for (int nt = 0; nt < D / 16; ++nt) {
    wmma::store_matrix_sync(stage + r0 * L::LD_ACC + nt * 16, dq_acc[nt],
                            L::LD_ACC, wmma::mem_row_major);
  }
  __syncwarp();
  write_rows<D>(p.dq, stage, r0, b, q0, h, p.Sq, p.Hq, lane);
}

// -- K3: the fused backward ----------------------------------------------------

struct FusedParams {
  const bf16* o;       // prep: [B, Sq, Hq, D] views
  const bf16* dout;
  const float* lse;    // prep: [B, Hq, Sq]
  const int* seg_q;    // [B, Sq] or null
  const int* seg_kv;   // [B, Skv] or null
  float* lse2;         // [B, Hq, Sq_pad]: lse * log2(e), 0 past Sq
  float* delta;        // [B, Hq, Sq_pad]: rowsum(o * do), 0 past Sq
  float* dq;           // [B, Sq, Hq, D] fp32 accumulator
  bf16* dk;            // [B, Skv, Hkv, D]
  bf16* dv;
  int B, Sq, Skv, Sq_pad, Hq, Hkv, group;
  long long o_sb, o_ss, o_sh, do_sb, do_ss, do_sh;
  long long segq_sb, segkv_sb;
  float scale, scale_log2;
  int causal;
};

constexpr int PREP_THREADS = 256;

// delta, lse * log2(e) and a zeroed dq accumulator, one (b, s, h) row per
// D / 8 threads (16 bytes each), rows with h fastest; rows s in [Sq, Sq_pad)
// get delta = lse2 = 0.
template <int D>
__global__ void __launch_bounds__(PREP_THREADS)
flash_bwd_prep_kernel(const FusedParams p) {
  constexpr int TPR = D / 8;
  constexpr int ROWS = PREP_THREADS / TPR;
  const long long row =
      static_cast<long long>(blockIdx.x) * ROWS + threadIdx.x / TPR;
  const int part = threadIdx.x % TPR;
  const bool in = row < static_cast<long long>(p.B) * p.Sq_pad * p.Hq;
  const int h = static_cast<int>(row % p.Hq);
  const int s = static_cast<int>((row / p.Hq) % p.Sq_pad);
  const int b = static_cast<int>(row / (static_cast<long long>(p.Hq) *
                                        p.Sq_pad));
  const bool live = in && s < p.Sq;
  float acc = 0.f;
  if (live) {
    const uint4 ov = *reinterpret_cast<const uint4*>(
        p.o + b * p.o_sb + s * p.o_ss + h * p.o_sh + part * 8);
    const uint4 dv = *reinterpret_cast<const uint4*>(
        p.dout + b * p.do_sb + s * p.do_ss + h * p.do_sh + part * 8);
    const bf16* oe = reinterpret_cast<const bf16*>(&ov);
    const bf16* de = reinterpret_cast<const bf16*>(&dv);
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      acc += __bfloat162float(oe[e]) * __bfloat162float(de[e]);
    }
    float4* dq = reinterpret_cast<float4*>(
        p.dq + ((static_cast<long long>(b) * p.Sq + s) * p.Hq + h) * D +
        part * 8);
    dq[0] = make_float4(0.f, 0.f, 0.f, 0.f);
    dq[1] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
#pragma unroll
  for (int off = TPR / 2; off > 0; off >>= 1) {
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  }
  if (in && part == 0) {
    const long long bh = static_cast<long long>(b) * p.Hq + h;
    p.delta[bh * p.Sq_pad + s] = live ? acc : 0.f;
    p.lse2[bh * p.Sq_pad + s] = live ? p.lse[bh * p.Sq + s] * LOG2E : 0.f;
  }
}

constexpr int BWD_STAGES = 3;  // the (Q, dO, lse2, delta) ring

template <int D, int KVW>
struct FusedSmem {
  static constexpr int BLOCK_KV = TILE * KVW;
  static constexpr uint32_t KV_BYTES = BLOCK_KV * D * 2;  // K or V, resident
  static constexpr uint32_t Q_BYTES = TILE * D * 2;       // a Q or dO tile
  static constexpr uint32_t DS_BYTES = TILE * TILE * 2;   // a dS^T tile
  static constexpr uint32_t K_OFF = 0;
  static constexpr uint32_t V_OFF = KV_BYTES;
  static constexpr uint32_t Q_OFF = 2 * KV_BYTES;
  static constexpr uint32_t DO_OFF = Q_OFF + BWD_STAGES * Q_BYTES;
  static constexpr uint32_t DS_OFF = DO_OFF + BWD_STAGES * Q_BYTES;
  static constexpr uint32_t ROW_OFF = DS_OFF + KVW * 2 * DS_BYTES;  // 2 a wg
  // lse2 [stage][64], delta [stage][64]
  static constexpr uint32_t BAR_OFF = ROW_OFF + 2 * BWD_STAGES * TILE * 4;
  // kv_full, full[stage], empty[stage]; 1024 bytes of alignment slack.
  static constexpr uint32_t BYTES = BAR_OFF + 8 * (1 + 2 * BWD_STAGES) + 1024;
};

// One block per (batch, kv head, BLOCK_KV kv rows); warpgroup wg owns kv
// rows [n0 + 64 wg, n0 + 64 wg + 64).
template <int D, int KVW>
__global__ void __launch_bounds__(KVW * WG_THREADS, 1)
flash_bwd_fused_kernel(const __grid_constant__ CUtensorMap q_map,
                       const __grid_constant__ CUtensorMap k_map,
                       const __grid_constant__ CUtensorMap v_map,
                       const __grid_constant__ CUtensorMap do_map,
                       const FusedParams p) {
  using L = FusedSmem<D, KVW>;
  constexpr int BLOCK_KV = L::BLOCK_KV;
  constexpr int SUBS = D / BOX_COLS;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align_1024(smem_raw);
  float* lse_s = reinterpret_cast<float*>(smem + L::ROW_OFF);
  float* delta_s = lse_s + BWD_STAGES * TILE;
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(smem + L::BAR_OFF);
  uint64_t* full = kv_full + 1;
  uint64_t* empty = full + BWD_STAGES;

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int b = blockIdx.x / p.Hkv;
  const int hk = blockIdx.x % p.Hkv;
  const int n0 = blockIdx.y * BLOCK_KV;
  // Under causal masking q rows above n0 see nothing of this tile.
  const int q_begin = p.causal ? n0 : 0;
  const int n_qt = q_begin < p.Sq ? (p.Sq - q_begin + TILE - 1) / TILE : 0;
  const int n_iter = p.group * n_qt;  // (q head, q tile) pairs

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < BWD_STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], KVW * 4);  // one arrival per warp
    }
    mbar_init_fence();
  }
  __syncthreads();

  // Thread 0 issues every load: K and V once, the first BWD_STAGES pairs'
  // (Q, dO, lse2, delta) now, each later pair's when its stage comes free
  // (`release`).
  auto load_pair = [&](int i) {
    const int h = hk * p.group + i / n_qt;
    const int q0 = q_begin + (i % n_qt) * TILE;
    const int s = i % BWD_STAGES;
    mbar_expect_tx(&full[s], 2 * L::Q_BYTES + 2 * TILE * 4);
    for (int c = 0; c < SUBS; ++c) {
      tma_load_4d(smem + L::Q_OFF + s * L::Q_BYTES + c * TILE * ROW_BYTES,
                  &q_map, &full[s], c * BOX_COLS, h, q0, b);
      tma_load_4d(smem + L::DO_OFF + s * L::Q_BYTES + c * TILE * ROW_BYTES,
                  &do_map, &full[s], c * BOX_COLS, h, q0, b);
    }
    const long long rows =
        (static_cast<long long>(b) * p.Hq + h) * p.Sq_pad + q0;
    bulk_load(lse_s + s * TILE, p.lse2 + rows, TILE * 4, &full[s]);
    bulk_load(delta_s + s * TILE, p.delta + rows, TILE * 4, &full[s]);
  };
  if (threadIdx.x == 0) {
    mbar_expect_tx(kv_full, 2 * L::KV_BYTES);
    for (int c = 0; c < SUBS; ++c) {
      tma_load_4d(smem + L::K_OFF + c * BLOCK_KV * ROW_BYTES, &k_map,
                  kv_full, c * BOX_COLS, hk, n0, b);
      tma_load_4d(smem + L::V_OFF + c * BLOCK_KV * ROW_BYTES, &v_map,
                  kv_full, c * BOX_COLS, hk, n0, b);
    }
    for (int i = 0; i < min(BWD_STAGES, n_iter); ++i) load_pair(i);
  }
  // Every warp frees pair i's stage after its last read; thread 0 then
  // refills the stage of pair i - 1, once every warp has freed it, with
  // pair i - 1 + BWD_STAGES: one pair of slack, so it seldom waits.
  auto release = [&](int i) {
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[i % BWD_STAGES]);
    const int r = i - 1;
    if (threadIdx.x == 0 && r >= 0 && r + BWD_STAGES < n_iter) {
      mbar_wait(&empty[r % BWD_STAGES], (r / BWD_STAGES) & 1);
      load_pair(r + BWD_STAGES);
    }
    __syncwarp();  // the warp's next wgmma is issued by all its lanes at once
  };

  // This thread holds kv rows krow0 and krow0 + 8 of the
  // transposed products (S^T, dP^T, dK, dV) and q rows qrow0, qrow0 + 8 of
  // dQ, at the columns of the accumulator layout (flash_hopper.cuh).
  const int wg = warp / 4;
  const int g = lane / 4;
  const int t = lane % 4;
  const int n0w = n0 + wg * TILE;
  const int wrow = (warp % 4) * 16 + g;  // row within the warpgroup's tile
  const int krow0 = n0w + wrow;
  const bool has_seg = p.seg_q != nullptr;
  int seg_row[2] = {0, 0};
  if (has_seg) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int kj = krow0 + 8 * r;
      seg_row[r] = kj < p.Skv ? p.seg_kv[b * p.segkv_sb + kj] : -2;
    }
  }
  float acc_dk[D / 2], acc_dv[D / 2];
#pragma unroll
  for (int j = 0; j < D / 2; ++j) acc_dk[j] = acc_dv[j] = 0.f;
  const uint32_t k_addr = smem_u32(smem + L::K_OFF) + wg * TILE * ROW_BYTES;
  const uint32_t v_addr = smem_u32(smem + L::V_OFF) + wg * TILE * ROW_BYTES;
  unsigned char* ds_tiles = smem + L::DS_OFF + wg * 2 * L::DS_BYTES;
  const bool wg_live = n0w < p.Skv;

  mbar_wait(kv_full, 0);
  for (int i = 0; i < n_iter; ++i) {
    const int h = hk * p.group + i / n_qt;
    const int q0 = q_begin + (i % n_qt) * TILE;
    const int s = i % BWD_STAGES;
    mbar_wait(&full[s], (i / BWD_STAGES) & 1);
    // A q tile wholly above this warpgroup's diagonal sees none of its rows.
    if (wg_live && (!p.causal || q0 + TILE - 1 >= n0w)) {
      const uint32_t q_addr = smem_u32(smem + L::Q_OFF + s * L::Q_BYTES);
      const uint32_t do_addr = smem_u32(smem + L::DO_OFF + s * L::Q_BYTES);
      float st[32], dpt[32];
#pragma unroll
      for (int j = 0; j < 32; ++j) st[j] = dpt[j] = 0.f;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t off = (kk % 4) * 32;
        wgmma_ss<0, 0>(
            st, desc_kmajor(k_addr + (kk / 4) * BLOCK_KV * ROW_BYTES + off),
            desc_kmajor(q_addr + (kk / 4) * TILE * ROW_BYTES + off), kk > 0);
      }
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t off = (kk % 4) * 32;
        wgmma_ss<0, 0>(
            dpt, desc_kmajor(v_addr + (kk / 4) * BLOCK_KV * ROW_BYTES + off),
            desc_kmajor(do_addr + (kk / 4) * TILE * ROW_BYTES + off), kk > 0);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(st);
      fence_regs(dpt);

      // p and ds in place of s and dp (the q index is the column here).
      const bool need_mask = has_seg || q0 + TILE > p.Sq ||
                             n0w + TILE > p.Skv ||
                             (p.causal && q0 < n0w + TILE - 1);
      const float* lse_row = lse_s + s * TILE;
      const float* delta_row = delta_s + s * TILE;
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        const float2 lv = *reinterpret_cast<const float2*>(lse_row + 8 * c +
                                                           2 * t);
        const float2 dl = *reinterpret_cast<const float2*>(delta_row +
                                                           8 * c + 2 * t);
        int seg_col[2] = {0, 0};
        if (need_mask && has_seg) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int qi = min(q0 + 8 * c + 2 * t + e, p.Sq - 1);
            seg_col[e] = p.seg_q[b * p.segq_sb + qi];
          }
        }
#pragma unroll
        for (int r = 0; r < 2; ++r) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int j = 4 * c + 2 * r + e;
            float pv = fast_exp2(st[j] * p.scale_log2 - (e ? lv.y : lv.x));
            if (need_mask) {
              const int qi = q0 + 8 * c + 2 * t + e;
              const int kj = krow0 + 8 * r;
              const bool keep = qi < p.Sq && kj < p.Skv &&
                                (!p.causal || kj <= qi) &&
                                seg_row[r] == seg_col[e];
              pv = keep ? pv : 0.f;
            }
            st[j] = pv;
            dpt[j] = pv * (dpt[j] - (e ? dl.y : dl.x)) * p.scale;
          }
        }
      }
      uint32_t pa[4][4], da[4][4];
      to_a_frags(st, pa);
      to_a_frags(dpt, da);

      // dS^T (bf16) into this warpgroup's tile, swizzled as TMA would
      // write it, for dQ = dS K; two tiles alternate between pairs.
      unsigned char* ds = ds_tiles + (i & 1) * L::DS_BYTES;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
        for (int ii = 0; ii < 4; ++ii) {
          const int row = wrow + 8 * (ii % 2);
          const int chunk = 2 * kk + ii / 2;
          *reinterpret_cast<uint32_t*>(ds + row * ROW_BYTES +
                                       ((chunk ^ (row & 7)) << 4) + 4 * t) =
              da[kk][ii];
        }
      }

      // dV += P^T dO and dK += dS^T Q, A from registers.
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        wgmma_rs<1>(acc_dv, pa[kk],
                    desc_mnmajor(do_addr + kk * 16 * ROW_BYTES,
                                 TILE * ROW_BYTES),
                    1);
      }
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        wgmma_rs<1>(acc_dk, da[kk],
                    desc_mnmajor(q_addr + kk * 16 * ROW_BYTES,
                                 TILE * ROW_BYTES),
                    1);
      }
      wgmma_commit();
      fence_async_shared();
      named_barrier(1 + wg, WG_THREADS);  // the whole dS^T tile is written

      // dQ = dS K, 64 columns at a time, added into the accumulator by
      // 16-byte vector reductions: lanes t and t ^ 1 swap halves so each
      // holds 4 adjacent columns of one row.
      const uint32_t ds_addr = smem_u32(ds);
      float* dq_head = p.dq + static_cast<long long>(b) * p.Sq * p.Hq * D +
                       static_cast<long long>(h) * D;
      const bool odd = t & 1;
      const int qi = q0 + wrow + (odd ? 8 : 0);
#pragma unroll
      for (int c = 0; c < SUBS; ++c) {
        float acc_dq[32];
#pragma unroll
        for (int j = 0; j < 32; ++j) acc_dq[j] = 0.f;
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          wgmma_ss<1, 1>(
              acc_dq,
              desc_mnmajor(ds_addr + kk * 16 * ROW_BYTES, TILE * ROW_BYTES),
              desc_mnmajor(k_addr + c * BLOCK_KV * ROW_BYTES +
                               kk * 16 * ROW_BYTES,
                           BLOCK_KV * ROW_BYTES),
              kk > 0);
        }
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(acc_dq);
        if (c == 0) {
          fence_regs(acc_dv);
          fence_regs(acc_dk);
          fence_regs(pa);
          fence_regs(da);
        }
#pragma unroll
        for (int cc = 0; cc < 8; ++cc) {
          const float s0 = odd ? acc_dq[4 * cc] : acc_dq[4 * cc + 2];
          const float s1 = odd ? acc_dq[4 * cc + 1] : acc_dq[4 * cc + 3];
          const float r0 = __shfl_xor_sync(0xffffffffu, s0, 1);
          const float r1 = __shfl_xor_sync(0xffffffffu, s1, 1);
          const float4 v =
              odd ? make_float4(r0, r1, acc_dq[4 * cc + 2], acc_dq[4 * cc + 3])
                  : make_float4(acc_dq[4 * cc], acc_dq[4 * cc + 1], r0, r1);
          if (qi < p.Sq) {
            atomicAdd(reinterpret_cast<float4*>(
                          dq_head + static_cast<long long>(qi) * p.Hq * D +
                          c * BOX_COLS + 8 * cc + 2 * (t & ~1)),
                      v);
          }
        }
      }
    }
    release(i);
  }

  // dk and dv rows of this warpgroup, bf16.
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int kj = krow0 + 8 * r;
    if (kj >= p.Skv) continue;
    const long long off =
        ((static_cast<long long>(b) * p.Skv + kj) * p.Hkv + hk) * D;
#pragma unroll
    for (int c = 0; c < D / 8; ++c) {
      *reinterpret_cast<uint32_t*>(p.dk + off + 8 * c + 2 * t) =
          pack_bf16(acc_dk[4 * c + 2 * r], acc_dk[4 * c + 2 * r + 1]);
      *reinterpret_cast<uint32_t*>(p.dv + off + 8 * c + 2 * t) =
          pack_bf16(acc_dv[4 * c + 2 * r], acc_dv[4 * c + 2 * r + 1]);
    }
  }
}

template <int D, int KVW>
int launch_fused(const BwdParams& bp, float* ws, int sq_pad,
                 cudaStream_t stream) {
  constexpr int BLOCK_KV = TILE * KVW;
  using L = FusedSmem<D, KVW>;
  FusedParams p;
  p.o = bp.o;
  p.dout = bp.dout;
  p.lse = bp.lse;
  p.seg_q = bp.seg_q;
  p.seg_kv = bp.seg_kv;
  p.lse2 = ws;
  p.delta = ws + static_cast<long long>(bp.B) * bp.Hq * sq_pad;
  p.dq = reinterpret_cast<float*>(bp.dq);
  p.dk = bp.dk;
  p.dv = bp.dv;
  p.B = bp.B;
  p.Sq = bp.Sq;
  p.Skv = bp.Skv;
  p.Sq_pad = sq_pad;
  p.Hq = bp.Hq;
  p.Hkv = bp.Hkv;
  p.group = bp.group;
  p.o_sb = bp.o_sb;
  p.o_ss = bp.o_ss;
  p.o_sh = bp.o_sh;
  p.do_sb = bp.do_sb;
  p.do_ss = bp.do_ss;
  p.do_sh = bp.do_sh;
  p.segq_sb = bp.segq_sb;
  p.segkv_sb = bp.segkv_sb;
  p.scale = bp.scale;
  p.scale_log2 = bp.scale * LOG2E;
  p.causal = bp.causal;

  CUtensorMap q_map, k_map, v_map, do_map;
  cudaError_t err = make_rows_map(&q_map, bp.q, bp.B, bp.Sq, bp.Hq, D,
                                  bp.q_sb, bp.q_ss, bp.q_sh, TILE);
  if (err == cudaSuccess) {
    err = make_rows_map(&do_map, bp.dout, bp.B, bp.Sq, bp.Hq, D, bp.do_sb,
                        bp.do_ss, bp.do_sh, TILE);
  }
  if (err == cudaSuccess) {
    err = make_rows_map(&k_map, bp.k, bp.B, bp.Skv, bp.Hkv, D, bp.k_sb,
                        bp.k_ss, bp.k_sh, BLOCK_KV);
  }
  if (err == cudaSuccess) {
    err = make_rows_map(&v_map, bp.v, bp.B, bp.Skv, bp.Hkv, D, bp.v_sb,
                        bp.v_ss, bp.v_sh, BLOCK_KV);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  static bool opted_in[64] = {};
  err = opt_in_smem(flash_bwd_fused_kernel<D, KVW>, L::BYTES, opted_in);
  if (err != cudaSuccess) return static_cast<int>(err);

  constexpr int PREP_ROWS = PREP_THREADS / (D / 8);
  const long long rows = static_cast<long long>(bp.B) * sq_pad * bp.Hq;
  flash_bwd_prep_kernel<D>
      <<<static_cast<unsigned>((rows + PREP_ROWS - 1) / PREP_ROWS),
         PREP_THREADS, 0, stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(bp.B * bp.Hkv, (bp.Skv + BLOCK_KV - 1) / BLOCK_KV);
  flash_bwd_fused_kernel<D, KVW>
      <<<grid, KVW * WG_THREADS, L::BYTES, stream>>>(q_map, k_map, v_map,
                                                      do_map, p);
  return static_cast<int>(cudaGetLastError());
}

// -- the split pair (K2a, K2b) --------------------------------------------------

template <int D>
int launch_kv(const BwdParams& p, cudaStream_t stream) {
  using L = BwdSmem<D>;
  static bool opted_in[64] = {};
  cudaError_t err = opt_in_smem(flash_bwd_kv_kernel<D>, L::BYTES, opted_in);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((p.Skv + BLOCK_N - 1) / BLOCK_N, p.Hkv, p.B);
  flash_bwd_kv_kernel<D><<<grid, THREADS, L::BYTES, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_dq(const BwdParams& p, cudaStream_t stream) {
  using L = BwdSmem<D>;
  static bool opted_in[64] = {};
  cudaError_t err = opt_in_smem(flash_bwd_dq_kernel<D>, L::BYTES, opted_in);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((p.Sq + BLOCK_M - 1) / BLOCK_M, p.Hq, p.B);
  flash_bwd_dq_kernel<D><<<grid, THREADS, L::BYTES, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// kind: 0 dq, 1 dkv, 2 fused.  q/o/do [B, Sq, Hq, D] and k/v [B, Skv, Hkv,
// D]: bf16 views with unit stride on D, 16-byte aligned, the other strides
// (in elements) multiples of 8; lse [B, Hq, Sq] fp32; seg_q [B, Sq] /
// seg_kv [B, Skv] int32 or null.  Outputs are contiguous: dq bf16
// [B, Sq, Hq, D] for kind 0, an fp32 [B, Sq, Hq, D] accumulator for kind 2
// (zeroed here); dk/dv bf16 [B, Skv, Hkv, D] for kinds 1 and 2.  Kind 2
// also takes ws, fp32 [2, B, Hq, sq_pad] scratch (sq_pad = Sq rounded up to
// 64), and block_kv, the kv rows of a block from the host plan (128 at
// D 64, 64 at D 128).  Returns cudaGetLastError() after the launches
// (0 = ok).
extern "C" int flash_bwd_bf16(
    int kind, const void* q, const void* k, const void* v, const void* o,
    const void* dout, const void* lse, const void* seg_q, const void* seg_kv,
    void* dq, void* dk, void* dv, int B, int Sq, int Skv, int Hq, int Hkv,
    int D, long long q_sb, long long q_ss, long long q_sh, long long k_sb,
    long long k_ss, long long k_sh, long long v_sb, long long v_ss,
    long long v_sh, long long o_sb, long long o_ss, long long o_sh,
    long long do_sb, long long do_ss, long long do_sh, long long segq_sb,
    long long segkv_sb, float scale, int causal, void* ws, int sq_pad,
    int block_kv, void* stream) {
  if (Hkv < 1 || Hq % Hkv != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  BwdParams p;
  p.q = static_cast<const bf16*>(q);
  p.k = static_cast<const bf16*>(k);
  p.v = static_cast<const bf16*>(v);
  p.o = static_cast<const bf16*>(o);
  p.dout = static_cast<const bf16*>(dout);
  p.lse = static_cast<const float*>(lse);
  p.seg_q = static_cast<const int*>(seg_q);
  p.seg_kv = static_cast<const int*>(seg_kv);
  p.dq = static_cast<bf16*>(dq);
  p.dk = static_cast<bf16*>(dk);
  p.dv = static_cast<bf16*>(dv);
  p.B = B;
  p.Sq = Sq;
  p.Skv = Skv;
  p.Hq = Hq;
  p.Hkv = Hkv;
  p.group = Hq / Hkv;
  p.q_sb = q_sb;
  p.q_ss = q_ss;
  p.q_sh = q_sh;
  p.k_sb = k_sb;
  p.k_ss = k_ss;
  p.k_sh = k_sh;
  p.v_sb = v_sb;
  p.v_ss = v_ss;
  p.v_sh = v_sh;
  p.o_sb = o_sb;
  p.o_ss = o_ss;
  p.o_sh = o_sh;
  p.do_sb = do_sb;
  p.do_ss = do_ss;
  p.do_sh = do_sh;
  p.segq_sb = segq_sb;
  p.segkv_sb = segkv_sb;
  p.scale = scale;
  p.causal = causal;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (kind == 2) {
    if (ws == nullptr || sq_pad != (Sq + TILE - 1) / TILE * TILE) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    float* w = static_cast<float*>(ws);
    if (D == 64 && block_kv == 128) return launch_fused<64, 2>(p, w, sq_pad, s);
    if (D == 128 && block_kv == 64) return launch_fused<128, 1>(p, w, sq_pad, s);
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (kind != 0 && kind != 1) return static_cast<int>(cudaErrorInvalidValue);
  switch (D) {
    case 64:
      return kind == 0 ? launch_dq<64>(p, s) : launch_kv<64>(p, s);
    case 128:
      return kind == 0 ? launch_dq<128>(p, s) : launch_kv<128>(p, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
