// Flash-attention backward for Hopper (sm_90a): bf16 in and out, fp32
// products and statistics.  Three kernels behind one C entry point:
//
//   kind 0  dq     replaces dlrover_tpu/ops/flash_attention.py:246
//                  _bwd_dq_kernel (K2a)
//   kind 1  dkv    replaces dlrover_tpu/ops/flash_attention.py:278
//                  _bwd_dkv_kernel (K2b)
//   kind 2  fused  replaces dlrover_tpu/ops/flash_attention.py:318
//                  _bwd_fused_kernel (K3)
//
// Same function as the TPU kernels (_recompute_p_ds, :206): from the
// forward's lse, p = mask ? exp(q k^T * scale - lse) : 0 (the mask gates
// p, never the value of the score: a fully masked row has lse = -1e30 and
// gives exactly zero); delta = rowsum(o * do), computed here from the o
// rows and the do tile as the TPU kernel does; ds = p (do v^T - delta)
// scale, rounded to bf16 like p before their products, as the TPU kernels
// round at :242 and :304; dq = ds k, dk = ds^T q, dv = p^T do, with GQA
// dk/dv summed over each kv head's group of q heads.
//
// What bounds them on this card: at the GPT-2 1.5B training shape (B 16,
// H 25, S 1024, D 64, causal) one backward does five S x S x D products
// per (b, h), halved by causality: 1.34e11 FLOP, 0.136 ms at 989 TFLOP/s;
// its bytes (q, k, v, o, do read once, dq, dk, dv written once) are about
// 0.42 GB, 0.125 ms at 3.35 TB/s.  So the bound is the tensor cores, and
// what counts is keeping the S x S matrices out of device memory and
// running every product on tensor cores: each (q tile, kv tile) pair's
// scores, probabilities and score gradients live in shared memory only,
// all five products are wmma bf16 16x16x16 with fp32 accumulation, and
// causal tiles above the diagonal are skipped by bounding the loops.  The
// design is the simple one (wmma from shared memory, no overlap of loads
// with products); wgmma, TMA and warp specialisation are later work.
//
// Layout.  Nothing carries across blocks on this card, so the TPU's
// sequential grid axis becomes a loop inside the block:
// * dkv / fused: one block of 4 warps per (b, kv head, 64-row kv tile)
//   loops over its group's q heads and the q tiles that can see the tile.
//   Warp w owns kv columns 16w..16w+15 of every (64 x 64) score tile, so
//   s, dp, p, ds and the dv += p^T do, dk += ds^T q updates are all
//   warp-local; dk and dv accumulate in registers.  The fused kernel then
//   syncs and adds dq += ds k for the tile (warp w: q rows 16w..) into an
//   fp32 [B, Sq, Hq, D] scratch by atomics.  That replaces the TPU
//   kernel's nk == 1 restriction (which came from output pipelining) and
//   makes dq's summation order vary from run to run.
// * dq: one block per (b, q head, 64-row q tile) loops over the kv tiles
//   it can see; warp w owns q rows 16w.., so everything is warp-local and
//   dq accumulates in registers.

#include "flash_common.cuh"

using namespace flash;

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
  void* dq;            // bf16 [B, Sq, Hq, D] (dq), fp32 zeroed (fused)
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

// dkv (FUSED = false) and fused (FUSED = true): one block per (kv tile,
// kv head, batch).
template <int D, bool FUSED>
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

      if (FUSED) {
        __syncthreads();  // every warp's ds columns are written
        // dq rows [r0, r0 + 16) of this q tile += ds k, into the fp32
        // scratch by atomics (other kv-tile blocks add to the same rows).
        const int r0 = warp * ROWS_PER_WARP;
#pragma unroll
        for (int nt = 0; nt < D / 16; ++nt) {
          Acc acc;
          wmma::fill_fragment(acc, 0.f);
#pragma unroll
          for (int kk = 0; kk < BLOCK_N / 16; ++kk) {
            ARow a;
            BRow bm;
            wmma::load_matrix_sync(a, DSs + r0 * L::LD_P + kk * 16, L::LD_P);
            wmma::load_matrix_sync(bm, Ks + kk * 16 * L::LD_T + nt * 16,
                                   L::LD_T);
            wmma::mma_sync(acc, a, bm, acc);
          }
          wmma::store_matrix_sync(stage + r0 * L::LD_ACC + nt * 16, acc,
                                  L::LD_ACC, wmma::mem_row_major);
        }
        __syncwarp();
        float* dq = static_cast<float*>(p.dq);
        for (int i = lane; i < ROWS_PER_WARP * D; i += 32) {
          const int r = r0 + i / D;
          const int c = i % D;
          const int qi = q0 + r;
          if (qi < p.Sq) {
            atomicAdd(dq + ((static_cast<long long>(b) * p.Sq + qi) * p.Hq +
                            h) * D + c,
                      stage[r * L::LD_ACC + c]);
          }
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
  write_rows<D>(static_cast<bf16*>(p.dq), stage, r0, b, q0, h, p.Sq, p.Hq,
                lane);
}

template <int D, bool FUSED>
int launch_kv(const BwdParams& p, cudaStream_t stream) {
  using L = BwdSmem<D>;
  static bool opted_in[64] = {};
  cudaError_t err =
      opt_in_smem(flash_bwd_kv_kernel<D, FUSED>, L::BYTES, opted_in);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((p.Skv + BLOCK_N - 1) / BLOCK_N, p.Hkv, p.B);
  flash_bwd_kv_kernel<D, FUSED><<<grid, THREADS, L::BYTES, stream>>>(p);
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

template <int D>
int launch(int kind, const BwdParams& p, cudaStream_t stream) {
  switch (kind) {
    case 0:
      return launch_dq<D>(p, stream);
    case 1:
      return launch_kv<D, false>(p, stream);
    case 2:
      return launch_kv<D, true>(p, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// kind: 0 dq, 1 dkv, 2 fused.  q/o/do [B, Sq, Hq, D] and k/v [B, Skv, Hkv,
// D]: bf16 views with unit stride on D and the other strides (in elements)
// given; lse [B, Hq, Sq] fp32; seg_q [B, Sq] / seg_kv [B, Skv] int32 or
// null.  Outputs are contiguous: dq bf16 [B, Sq, Hq, D] for kind 0, a
// zeroed fp32 [B, Sq, Hq, D] scratch that receives atomic adds for kind 2;
// dk/dv bf16 [B, Skv, Hkv, D] for kinds 1 and 2.  Returns
// cudaGetLastError() after the launch (0 = ok).
extern "C" int flash_bwd_bf16(
    int kind, const void* q, const void* k, const void* v, const void* o,
    const void* dout, const void* lse, const void* seg_q, const void* seg_kv,
    void* dq, void* dk, void* dv, int B, int Sq, int Skv, int Hq, int Hkv,
    int D, long long q_sb, long long q_ss, long long q_sh, long long k_sb,
    long long k_ss, long long k_sh, long long v_sb, long long v_ss,
    long long v_sh, long long o_sb, long long o_ss, long long o_sh,
    long long do_sb, long long do_ss, long long do_sh, long long segq_sb,
    long long segkv_sb, float scale, int causal, void* stream) {
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
  p.dq = dq;
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
  switch (D) {
    case 64:
      return launch<64>(kind, p, s);
    case 128:
      return launch<128>(kind, p, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
