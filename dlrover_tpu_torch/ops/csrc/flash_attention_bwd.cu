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
// K2b (kind 1, the split path's dk/dv) is K3's kernel with the dq half
// compiled out (WITH_DQ false): the same pre-pass (delta and lse2 only, no
// accumulator to zero), the same register-resident dK and dV, a (Q, dO)
// ring 4 stages deep (3 for K3, whose dS^T tiles take the room), and no
// dS^T tile, dQ product or reductions.  Its blocks are one warpgroup of 64
// kv rows at both head dims; at D 64, without dq's registers (184 a
// thread), two fit on an SM.  Its pairs are summed in K3's order with
// K3's arithmetic, so its dk and dv equal K3's bit for bit.
// What bounds it: at the train_split shape (B 16, H 25, S 1024, D 64,
// causal) four S x S x D products over the live pairs, 1.07e11 FLOP, 0.109
// ms at 989 TFLOP/s, beside 0.37 GB of bytes, 0.110 ms: both about equal.
// What holds it back is K3's minus the reductions: each warpgroup runs its
// products and elementwise work in sequence.  Issuing a pair's dV and dK
// with the next pair's S^T and dP^T, with or without the two warpgroups
// taking turns, ran slower (PERF.md).
//
// K2a (kind 0, the split path's dq) is built from the same pieces on K1's
// skeleton, q-tile blocks with K/V streaming:
// * One block per (batch, q head, q tile) of one or two warpgroups of 64
//   q rows: 128-row blocks (one an SM at D 64, 147 registers), which share
//   each K/V tile between two warpgroups, where they make at least 16
//   waves of the card at D 64 or half a wave at D 128 (crossovers measured
//   on an H100, PERF.md); 64-row ones, two an SM at D 64, below that (the
//   host plan, ops/flash_attention.py dq_launch_plan); the heaviest causal
//   q tiles launch first.  Q and dO are loaded once by TMA and stay in
//   shared memory with the block's lse2 and delta rows (bulk copies of the
//   pre-pass's rows); K and V tiles of 64 rows stream through a ring of 4
//   stages.  Tile i - 1's K is still read by its dQ product during tile
//   i, so at tile i, once its products are issued, thread 0 refills the
//   stage of tile i - 2 (freed by every warp at the end of tile i - 1)
//   with tile i + 2: two tiles load while tile i is computed.
// * Per kv tile: S = Q K^T and dP = dO V^T are wgmmas from shared memory
//   with fp32 results in registers; P and dS are built there (K3's
//   arithmetic, masks only where they can bite), and dS in bf16 is the
//   register A operand of dQ += dS K, K through the transpose bit.  Tile
//   i's S and dP are issued with tile i - 1's dQ product, so dS is built
//   while that runs.  No score, probability or dS touches shared memory.
// * dq accumulates in fp32 registers over the whole kv loop and is written
//   once in bf16: no atomics, no accumulator, no cast, and dq is the same
//   bit for bit from run to run.
// The split path (flash_bwd_split) runs the pre-pass once, with K2a's
// launch, and K2b reads the same rows (`prep` 0).  What bounds K2a: at the
// train_split shape three S x S x D products over the live pairs, 8.0e10
// FLOP, 0.081 ms at 989 TFLOP/s, beside 0.32 GB of bytes, 0.094 ms: both
// about equal.  What holds it back: a warpgroup waits for S and dP before
// it builds dS (issuing them as two groups, to start on P early, read no
// faster), and the pre-pass, about a tenth of the launch, reads o and do
// once more.
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

// -- K3 and K2b: one block per kv tile, on wgmma ----------------------------

struct FusedParams {
  const bf16* o;       // prep: [B, Sq, Hq, D] views
  const bf16* dout;
  const float* lse;    // prep: [B, Hq, Sq]
  const int* seg_q;    // [B, Sq] or null
  const int* seg_kv;   // [B, Skv] or null
  float* lse2;         // [B, Hq, Sq_pad]: lse * log2(e), 0 past Sq
  float* delta;        // [B, Hq, Sq_pad]: rowsum(o * do), 0 past Sq
  float* dq;           // K3: [B, Sq, Hq, D] fp32 accumulator; K2b: null
  bf16* dk;            // [B, Skv, Hkv, D]
  bf16* dv;
  int B, Sq, Skv, Sq_pad, Hq, Hkv, group;
  long long o_sb, o_ss, o_sh, do_sb, do_ss, do_sh;
  long long segq_sb, segkv_sb;
  float scale, scale_log2;
  int causal;
};

constexpr int PREP_THREADS = 256;

// delta, lse * log2(e) and, for K3 (ZERO_DQ), a zeroed dq accumulator, one
// (b, s, h) row per D / 8 threads (16 bytes each), rows with h fastest;
// rows s in [Sq, Sq_pad) get delta = lse2 = 0.
template <int D, bool ZERO_DQ>
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
    if constexpr (ZERO_DQ) {
      float4* dq = reinterpret_cast<float4*>(
          p.dq + ((static_cast<long long>(b) * p.Sq + s) * p.Hq + h) * D +
          part * 8);
      dq[0] = make_float4(0.f, 0.f, 0.f, 0.f);
      dq[1] = make_float4(0.f, 0.f, 0.f, 0.f);
    }
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

// K and V resident, a ring of STAGES (Q, dO) tiles with their lse2 and
// delta rows, and, for K3 (WITH_DQ), two dS^T tiles a warpgroup.
template <int D, int KVW, int STAGES, bool WITH_DQ>
struct FusedSmem {
  static constexpr int BLOCK_KV = TILE * KVW;
  static constexpr uint32_t KV_BYTES = BLOCK_KV * D * 2;  // K or V, resident
  static constexpr uint32_t Q_BYTES = TILE * D * 2;       // a Q or dO tile
  static constexpr uint32_t DS_BYTES = TILE * TILE * 2;   // a dS^T tile
  static constexpr uint32_t K_OFF = 0;
  static constexpr uint32_t V_OFF = KV_BYTES;
  static constexpr uint32_t Q_OFF = 2 * KV_BYTES;
  static constexpr uint32_t DO_OFF = Q_OFF + STAGES * Q_BYTES;
  static constexpr uint32_t DS_OFF = DO_OFF + STAGES * Q_BYTES;
  static constexpr uint32_t ROW_OFF =
      DS_OFF + (WITH_DQ ? KVW * 2 * DS_BYTES : 0);
  // lse2 [stage][64], delta [stage][64]
  static constexpr uint32_t BAR_OFF = ROW_OFF + 2 * STAGES * TILE * 4;
  // kv_full, full[stage], empty[stage]; 1024 bytes of alignment slack.
  static constexpr uint32_t BYTES = BAR_OFF + 8 * (1 + 2 * STAGES) + 1024;
};

// One block per (batch, kv head, BLOCK_KV kv rows); warpgroup wg owns kv
// rows [n0 + 64 wg, n0 + 64 wg + 64).  WITH_DQ: K3 (dq, dk, dv); without:
// K2b (dk, dv).  MIN_BLOCKS: blocks an SM the registers must allow.
template <int D, int KVW, bool WITH_DQ, int STAGES, int MIN_BLOCKS>
__global__ void __launch_bounds__(KVW * WG_THREADS, MIN_BLOCKS)
flash_bwd_kv_tile_kernel(const __grid_constant__ CUtensorMap q_map,
                         const __grid_constant__ CUtensorMap k_map,
                         const __grid_constant__ CUtensorMap v_map,
                         const __grid_constant__ CUtensorMap do_map,
                         const FusedParams p) {
  using L = FusedSmem<D, KVW, STAGES, WITH_DQ>;
  constexpr int BLOCK_KV = L::BLOCK_KV;
  constexpr int SUBS = D / BOX_COLS;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align_1024(smem_raw);
  float* lse_s = reinterpret_cast<float*>(smem + L::ROW_OFF);
  float* delta_s = lse_s + STAGES * TILE;
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(smem + L::BAR_OFF);
  uint64_t* full = kv_full + 1;
  uint64_t* empty = full + STAGES;

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
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], KVW * 4);  // one arrival per warp
    }
    mbar_init_fence();
  }
  __syncthreads();

  // Thread 0 issues every load: K and V once, the first STAGES pairs'
  // (Q, dO, lse2, delta) now, each later pair's when its stage comes free
  // (`release`).
  auto load_pair = [&](int i) {
    const int h = hk * p.group + i / n_qt;
    const int q0 = q_begin + (i % n_qt) * TILE;
    const int s = i % STAGES;
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
    for (int i = 0; i < min(STAGES, n_iter); ++i) load_pair(i);
  }
  // Every warp frees pair i's stage after its last read; thread 0 then
  // refills the stage of pair i - 1, once every warp has freed it, with
  // pair i - 1 + STAGES: one pair of slack, so it seldom waits.
  auto release = [&](int i) {
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[i % STAGES]);
    const int r = i - 1;
    if (threadIdx.x == 0 && r >= 0 && r + STAGES < n_iter) {
      mbar_wait(&empty[r % STAGES], (r / STAGES) & 1);
      load_pair(r + STAGES);
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
  const bool wg_live = n0w < p.Skv;

  mbar_wait(kv_full, 0);
  for (int i = 0; i < n_iter; ++i) {
    [[maybe_unused]] const int h = hk * p.group + i / n_qt;
    const int q0 = q_begin + (i % n_qt) * TILE;
    const int s = i % STAGES;
    mbar_wait(&full[s], (i / STAGES) & 1);
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
      [[maybe_unused]] unsigned char* ds =
          smem + L::DS_OFF + (wg * 2 + (i & 1)) * L::DS_BYTES;
      if constexpr (WITH_DQ) {
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
          for (int ii = 0; ii < 4; ++ii) {
            const int row = wrow + 8 * (ii % 2);
            const int chunk = 2 * kk + ii / 2;
            *reinterpret_cast<uint32_t*>(
                ds + row * ROW_BYTES + ((chunk ^ (row & 7)) << 4) + 4 * t) =
                da[kk][ii];
          }
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
      if constexpr (!WITH_DQ) {
        // K2b: nothing follows; the stage is freed once they have run.
        wgmma_wait<0>();
        fence_regs(acc_dv);
        fence_regs(acc_dk);
        fence_regs(pa);
        fence_regs(da);
      } else {
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
                desc_mnmajor(ds_addr + kk * 16 * ROW_BYTES,
                           TILE * ROW_BYTES),
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
                odd ? make_float4(r0, r1, acc_dq[4 * cc + 2],
                                  acc_dq[4 * cc + 3])
                    : make_float4(acc_dq[4 * cc], acc_dq[4 * cc + 1], r0,
                                  r1);
            if (qi < p.Sq) {
              atomicAdd(reinterpret_cast<float4*>(
                            dq_head + static_cast<long long>(qi) * p.Hq * D +
                            c * BOX_COLS + 8 * cc + 2 * (t & ~1)),
                        v);
            }
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

// -- K2a: one block per q tile, on wgmma --------------------------------------

struct DqParams {
  const int* seg_q;    // [B, Sq] or null
  const int* seg_kv;   // [B, Skv] or null
  const float* lse2;   // [B, Hq, Sq_pad]: the pre-pass's rows
  const float* delta;  // [B, Hq, Sq_pad]
  bf16* dq;            // [B, Sq, Hq, D] contiguous
  int Sq, Skv, Sq_pad, Hq, group, n_qt;
  long long segq_sb, segkv_sb;
  float scale, scale_log2;
  int causal;
};

// Q and dO resident (BLOCK_M rows each, as TMA writes them), a ring of
// STAGES (K, V) tiles of 64 rows, and the block's lse2 and delta rows.
template <int D, int NWG, int STAGES>
struct DqSmem {
  static constexpr int BLOCK_M = TILE * NWG;
  static constexpr uint32_t Q_BYTES = BLOCK_M * D * 2;  // Q or dO
  static constexpr uint32_t KV_BYTES = TILE * D * 2;    // one K or V tile
  static constexpr uint32_t DO_OFF = Q_BYTES;
  static constexpr uint32_t K_OFF = 2 * Q_BYTES;
  static constexpr uint32_t V_OFF = K_OFF + STAGES * KV_BYTES;
  // lse2 [BLOCK_M], delta [BLOCK_M]
  static constexpr uint32_t ROW_OFF = V_OFF + STAGES * KV_BYTES;
  static constexpr uint32_t BAR_OFF = ROW_OFF + 2 * BLOCK_M * 4;
  // q_full, full[STAGES], empty[STAGES]; 1024 bytes of alignment slack.
  static constexpr uint32_t BYTES = BAR_OFF + 8 * (1 + 2 * STAGES) + 1024;
};

// One block per (batch, q head, BLOCK_M q rows); warpgroup wg owns q rows
// [q0 + 64 wg, q0 + 64 wg + 64).  MIN_BLOCKS: blocks an SM the registers
// must allow.
template <int D, int NWG, int STAGES, int MIN_BLOCKS>
__global__ void __launch_bounds__(NWG * WG_THREADS, MIN_BLOCKS)
flash_bwd_dq_kernel(const __grid_constant__ CUtensorMap q_map,
                    const __grid_constant__ CUtensorMap k_map,
                    const __grid_constant__ CUtensorMap v_map,
                    const __grid_constant__ CUtensorMap do_map,
                    const DqParams p) {
  using L = DqSmem<D, NWG, STAGES>;
  constexpr int BLOCK_M = L::BLOCK_M;
  constexpr int SUBS = D / BOX_COLS;
  // Tile i - 1's K is read by its dQ product while tile i is in use, so
  // the stage refilled at tile i is tile i - 2's.
  static_assert(STAGES >= 3, "the ring refills two tiles behind");
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align_1024(smem_raw);
  float* lse_s = reinterpret_cast<float*>(smem + L::ROW_OFF);
  float* delta_s = lse_s + BLOCK_M;
  uint64_t* q_full = reinterpret_cast<uint64_t*>(smem + L::BAR_OFF);
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + STAGES;

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int b = blockIdx.x / p.Hq;
  const int h = blockIdx.x % p.Hq;
  const int hk = h / p.group;
  // Under causal masking the last q tiles see the most kv tiles: launch
  // them first.
  const int qt = p.causal ? p.n_qt - 1 - static_cast<int>(blockIdx.y)
                          : static_cast<int>(blockIdx.y);
  const int q0 = qt * BLOCK_M;
  const int kv_end = p.causal ? min(p.Skv, q0 + BLOCK_M) : p.Skv;
  const int n_tiles = (kv_end + TILE - 1) / TILE;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], NWG * 4);  // one arrival per warp
    }
    mbar_init_fence();
  }
  __syncthreads();

  // Thread 0 issues every load: Q, dO and the stat rows now, with the
  // first STAGES (K, V) tiles, each later tile when its stage comes free
  // (`refill`).
  auto load_kv = [&](int i) {
    const int s = i % STAGES;
    mbar_expect_tx(&full[s], 2 * L::KV_BYTES);
    unsigned char* ks = smem + L::K_OFF + s * L::KV_BYTES;
    unsigned char* vs = smem + L::V_OFF + s * L::KV_BYTES;
    for (int c = 0; c < SUBS; ++c) {
      tma_load_4d(ks + c * TILE * ROW_BYTES, &k_map, &full[s],
                  c * BOX_COLS, hk, i * TILE, b);
      tma_load_4d(vs + c * TILE * ROW_BYTES, &v_map, &full[s],
                  c * BOX_COLS, hk, i * TILE, b);
    }
  };
  if (threadIdx.x == 0) {
    // The stat rows end at Sq_pad (a multiple of 64): a last block of two
    // warpgroups may hold only one warpgroup's rows.
    const int stat_rows = min(BLOCK_M, p.Sq_pad - q0);
    mbar_expect_tx(q_full, 2 * L::Q_BYTES + 2 * stat_rows * 4);
    for (int c = 0; c < SUBS; ++c) {
      tma_load_4d(smem + c * BLOCK_M * ROW_BYTES, &q_map, q_full,
                  c * BOX_COLS, h, q0, b);
      tma_load_4d(smem + L::DO_OFF + c * BLOCK_M * ROW_BYTES, &do_map,
                  q_full, c * BOX_COLS, h, q0, b);
    }
    const long long rows =
        (static_cast<long long>(b) * p.Hq + h) * p.Sq_pad + q0;
    bulk_load(lse_s, p.lse2 + rows, stat_rows * 4, q_full);
    bulk_load(delta_s, p.delta + rows, stat_rows * 4, q_full);
    for (int i = 0; i < min(STAGES, n_tiles); ++i) load_kv(i);
  }
  // Every warp frees tile i's stage after its last read (its dQ product).
  auto release = [&](int i) {
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[i % STAGES]);
  };
  // At tile i, once warpgroup 0 has issued its products, thread 0 refills
  // the stage of tile i - 2, which every warp freed at the end of tile
  // i - 1, with tile i - 2 + STAGES: the next STAGES - 2 tiles load while
  // tile i is computed.
  auto refill = [&](int i) {
    const int r = i - 2;
    if (threadIdx.x == 0 && r >= 0 && r + STAGES < n_tiles) {
      mbar_wait(&empty[r % STAGES], (r / STAGES) & 1);
      load_kv(r + STAGES);
    }
    __syncwarp();  // the warp's next wgmma is issued by all its lanes at once
  };

  // Warpgroup wg owns q rows [wg_q0, wg_q0 + 64); this thread holds rows
  // row0 and row0 + 8 of them, at the accumulator layout's columns
  // (flash_hopper.cuh).
  const int wg = warp / 4;
  const int g = lane / 4;
  const int t = lane % 4;
  const int wg_q0 = q0 + wg * TILE;
  const int wrow = wg * TILE + (warp % 4) * 16 + g;  // row within the block
  const int row0 = q0 + wrow;
  const int wg_kv_end = p.causal ? min(p.Skv, wg_q0 + TILE) : p.Skv;
  // A warpgroup whose rows all lie past Sq has nothing to compute.
  const int n_w = wg_q0 < p.Sq ? (wg_kv_end + TILE - 1) / TILE : 0;
  const bool has_seg = p.seg_q != nullptr;
  int seg_row[2] = {0, 0};
  if (has_seg) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int qi = row0 + 8 * r;
      seg_row[r] = qi < p.Sq ? p.seg_q[b * p.segq_sb + qi] : -1;
    }
  }

  float acc_dq[D / 2];
#pragma unroll
  for (int j = 0; j < D / 2; ++j) acc_dq[j] = 0.f;
  float sc[32], dp[32];
  uint32_t da[TILE / 16][4];
  const uint32_t q_addr = smem_u32(smem) + wg * TILE * ROW_BYTES;
  const uint32_t do_addr = smem_u32(smem + L::DO_OFF) + wg * TILE * ROW_BYTES;

  // S = Q K^T and dP = dO V^T of tile i into sc and dp, one group
  // (issued, not waited for).
  auto issue_s_dp = [&](int i) {
    const uint32_t k_addr =
        smem_u32(smem + L::K_OFF + (i % STAGES) * L::KV_BYTES);
    const uint32_t v_addr =
        smem_u32(smem + L::V_OFF + (i % STAGES) * L::KV_BYTES);
#pragma unroll
    for (int j = 0; j < 32; ++j) sc[j] = dp[j] = 0.f;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t off = (kk / 4) * BLOCK_M * ROW_BYTES + (kk % 4) * 32;
      wgmma_ss<0, 0>(
          sc, desc_kmajor(q_addr + off),
          desc_kmajor(k_addr + (kk / 4) * TILE * ROW_BYTES + (kk % 4) * 32),
          kk > 0);
    }
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t off = (kk / 4) * BLOCK_M * ROW_BYTES + (kk % 4) * 32;
      wgmma_ss<0, 0>(
          dp, desc_kmajor(do_addr + off),
          desc_kmajor(v_addr + (kk / 4) * TILE * ROW_BYTES + (kk % 4) * 32),
          kk > 0);
    }
    wgmma_commit();
  };
  // dQ += dS K of tile i, dS (bf16) from the registers, K through the
  // transpose bit (issued, not waited for).
  auto issue_dq = [&](int i) {
    const uint32_t k_addr =
        smem_u32(smem + L::K_OFF + (i % STAGES) * L::KV_BYTES);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < TILE / 16; ++kk) {
      wgmma_rs<1>(acc_dq, da[kk],
                  desc_mnmajor(k_addr + kk * 16 * ROW_BYTES,
                               TILE * ROW_BYTES),
                  1);
    }
    wgmma_commit();
  };
  float lse2[2], delta[2];
  // p and ds of tile i in place of dp (K2b's and K3's arithmetic): p =
  // exp2(s * scale * log2(e) - lse2), gated by the mask where it can bite;
  // ds = p (dp - delta) scale.
  auto p_ds = [&](int i) {
    const int n0 = i * TILE;
    const bool need_mask = has_seg || n0 + TILE > p.Skv ||
                           (p.causal && n0 + TILE - 1 > wg_q0);
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      int seg_col[2] = {0, 0};
      if (need_mask && has_seg) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int kj = min(n0 + 8 * c + 2 * t + e, p.Skv - 1);
          seg_col[e] = p.seg_kv[b * p.segkv_sb + kj];
        }
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int j = 4 * c + 2 * r + e;
          float pv = fast_exp2(sc[j] * p.scale_log2 - lse2[r]);
          if (need_mask) {
            const int kj = n0 + 8 * c + 2 * t + e;
            const bool keep = kj < p.Skv &&
                              (!p.causal || kj <= row0 + 8 * r) &&
                              seg_row[r] == seg_col[e];
            pv = keep ? pv : 0.f;
          }
          dp[j] = pv * (dp[j] - delta[r]) * p.scale;
        }
      }
    }
  };

  // The warpgroup computes kv tiles [0, n_w) (under causal masking the
  // block's last tile may lie wholly above its rows) and passes the rest.
  // Software pipeline: tile i's S and dP are issued together with tile
  // i - 1's dQ product, and tile i's dS is built while that runs.
  mbar_wait(q_full, 0);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    lse2[r] = lse_s[wrow + 8 * r];
    delta[r] = delta_s[wrow + 8 * r];
  }
  if (n_w > 0) {
    mbar_wait(&full[0], 0);
    issue_s_dp(0);
    wgmma_wait<0>();
    fence_regs(sc);
    fence_regs(dp);
    p_ds(0);
    to_a_frags(dp, da);
    for (int i = 1; i < n_w; ++i) {
      mbar_wait(&full[i % STAGES], (i / STAGES) & 1);
      issue_s_dp(i);
      issue_dq(i - 1);
      refill(i);
      wgmma_wait<1>();  // S and dP done; dQ may still run
      fence_regs(sc);
      fence_regs(dp);
      p_ds(i);
      wgmma_wait<0>();
      fence_regs(acc_dq);
      fence_regs(da);
      release(i - 1);
      to_a_frags(dp, da);
    }
    issue_dq(n_w - 1);
    wgmma_wait<0>();
    fence_regs(acc_dq);
    fence_regs(da);
    release(n_w - 1);
  }
  for (int i = n_w; i < n_tiles; ++i) {
    refill(i);
    mbar_wait(&full[i % STAGES], (i / STAGES) & 1);
    release(i);
  }

  // dq rows, bf16, written once.
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = row0 + 8 * r;
    if (qi >= p.Sq) continue;
    bf16* drow = p.dq + (static_cast<long long>(b) * p.Sq + qi) * p.Hq * D +
                 static_cast<long long>(h) * D;
#pragma unroll
    for (int c = 0; c < D / 8; ++c) {
      *reinterpret_cast<uint32_t*>(drow + 8 * c + 2 * t) =
          pack_bf16(acc_dq[4 * c + 2 * r], acc_dq[4 * c + 2 * r + 1]);
    }
  }
}

// -- launches -------------------------------------------------------------------

// The pre-pass's parameters: o, do, lse in; the lse2 and delta rows of
// ws (fp32 [2, B, Hq, sq_pad]) out; dq_acc (K3) zeroed, or null.
FusedParams prep_params(const BwdParams& bp, float* ws, int sq_pad,
                        float* dq_acc) {
  FusedParams p;
  p.o = bp.o;
  p.dout = bp.dout;
  p.lse = bp.lse;
  p.seg_q = bp.seg_q;
  p.seg_kv = bp.seg_kv;
  p.lse2 = ws;
  p.delta = ws + static_cast<long long>(bp.B) * bp.Hq * sq_pad;
  p.dq = dq_acc;
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
  return p;
}

template <int D, bool ZERO_DQ>
cudaError_t run_prep(const FusedParams& p, cudaStream_t stream) {
  constexpr int PREP_ROWS = PREP_THREADS / (D / 8);
  const long long rows = static_cast<long long>(p.B) * p.Sq_pad * p.Hq;
  flash_bwd_prep_kernel<D, ZERO_DQ>
      <<<static_cast<unsigned>((rows + PREP_ROWS - 1) / PREP_ROWS),
         PREP_THREADS, 0, stream>>>(p);
  return cudaGetLastError();
}

// The pre-pass (unless `prep` is 0: ws already holds this call's rows),
// then the kv-tile kernel: K3 (WITH_DQ, always with its pre-pass, which
// zeroes the dq accumulator) or K2b.
template <int D, int KVW, bool WITH_DQ, int STAGES, int MIN_BLOCKS>
int launch_kv_tiles(const BwdParams& bp, float* ws, int sq_pad, int prep,
                    cudaStream_t stream) {
  constexpr int BLOCK_KV = TILE * KVW;
  using L = FusedSmem<D, KVW, STAGES, WITH_DQ>;
  const FusedParams p = prep_params(
      bp, ws, sq_pad, WITH_DQ ? reinterpret_cast<float*>(bp.dq) : nullptr);
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
  err = opt_in_smem(
      flash_bwd_kv_tile_kernel<D, KVW, WITH_DQ, STAGES, MIN_BLOCKS>,
      L::BYTES, opted_in);
  if (err == cudaSuccess && (prep || WITH_DQ)) {
    err = run_prep<D, WITH_DQ>(p, stream);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(bp.B * bp.Hkv, (bp.Skv + BLOCK_KV - 1) / BLOCK_KV);
  flash_bwd_kv_tile_kernel<D, KVW, WITH_DQ, STAGES, MIN_BLOCKS>
      <<<grid, KVW * WG_THREADS, L::BYTES, stream>>>(q_map, k_map, v_map,
                                                      do_map, p);
  return static_cast<int>(cudaGetLastError());
}

// The pre-pass (unless `prep` is 0), then K2a.
template <int D, int NWG, int STAGES, int MIN_BLOCKS>
int launch_dq(const BwdParams& bp, float* ws, int sq_pad, int prep,
              cudaStream_t stream) {
  constexpr int BLOCK_M = TILE * NWG;
  using L = DqSmem<D, NWG, STAGES>;
  DqParams p;
  p.seg_q = bp.seg_q;
  p.seg_kv = bp.seg_kv;
  p.lse2 = ws;
  p.delta = ws + static_cast<long long>(bp.B) * bp.Hq * sq_pad;
  p.dq = bp.dq;
  p.Sq = bp.Sq;
  p.Skv = bp.Skv;
  p.Sq_pad = sq_pad;
  p.Hq = bp.Hq;
  p.group = bp.group;
  p.n_qt = (bp.Sq + BLOCK_M - 1) / BLOCK_M;
  p.segq_sb = bp.segq_sb;
  p.segkv_sb = bp.segkv_sb;
  p.scale = bp.scale;
  p.scale_log2 = bp.scale * LOG2E;
  p.causal = bp.causal;
  CUtensorMap q_map, k_map, v_map, do_map;
  cudaError_t err = make_rows_map(&q_map, bp.q, bp.B, bp.Sq, bp.Hq, D,
                                  bp.q_sb, bp.q_ss, bp.q_sh, BLOCK_M);
  if (err == cudaSuccess) {
    err = make_rows_map(&do_map, bp.dout, bp.B, bp.Sq, bp.Hq, D, bp.do_sb,
                        bp.do_ss, bp.do_sh, BLOCK_M);
  }
  if (err == cudaSuccess) {
    err = make_rows_map(&k_map, bp.k, bp.B, bp.Skv, bp.Hkv, D, bp.k_sb,
                        bp.k_ss, bp.k_sh, TILE);
  }
  if (err == cudaSuccess) {
    err = make_rows_map(&v_map, bp.v, bp.B, bp.Skv, bp.Hkv, D, bp.v_sb,
                        bp.v_ss, bp.v_sh, TILE);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  static bool opted_in[64] = {};
  err = opt_in_smem(flash_bwd_dq_kernel<D, NWG, STAGES, MIN_BLOCKS>,
                    L::BYTES, opted_in);
  if (err == cudaSuccess && prep) {
    err = run_prep<D, false>(prep_params(bp, ws, sq_pad, nullptr), stream);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(bp.B * bp.Hq, p.n_qt);
  flash_bwd_dq_kernel<D, NWG, STAGES, MIN_BLOCKS>
      <<<grid, NWG * WG_THREADS, L::BYTES, stream>>>(q_map, k_map, v_map,
                                                      do_map, p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// kind: 0 dq (K2a), 1 dkv (K2b), 2 fused (K3).  q/o/do [B, Sq, Hq, D] and
// k/v [B, Skv, Hkv, D]: bf16 views with unit stride on D, 16-byte aligned,
// the other strides (in elements) multiples of 8; lse [B, Hq, Sq] fp32;
// seg_q [B, Sq] / seg_kv [B, Skv] int32 or null.  Outputs are contiguous:
// dq bf16 [B, Sq, Hq, D] for kind 0, an fp32 [B, Sq, Hq, D] accumulator
// for kind 2 (zeroed here), none for kind 1; dk/dv bf16 [B, Skv, Hkv, D]
// for kinds 1 and 2.  ws: fp32 [2, B, Hq, sq_pad] rows (sq_pad = Sq
// rounded up to 64), which the pre-pass fills with lse * log2(e) and
// delta; `prep` 0 skips the pre-pass of kinds 0 and 1 (ws holds this
// backward's rows already: the split path fills them once for K2a and
// K2b).  The host plan's block_rows (q rows a block for kind 0, kv rows
// for kinds 1 and 2), stages (of the streamed ring) and smem_bytes (a
// block's dynamic shared memory) must be one of the builds below; any
// other plan is refused.  Returns cudaGetLastError() after the launches
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
    int block_rows, int stages, int smem_bytes, int prep, void* stream) {
  constexpr int kInvalid = static_cast<int>(cudaErrorInvalidValue);
  if (Hkv < 1 || Hq % Hkv != 0 || ws == nullptr ||
      sq_pad != (Sq + TILE - 1) / TILE * TILE) {
    return kInvalid;
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
  float* w = static_cast<float*>(ws);
  // The builds: (D, warpgroups a block, ring stages, blocks an SM, shared
  // memory bytes).  ops/flash_attention.py's plans and
  // tests/test_torch_flash_plans.py read this table.
#define DQ_BUILD(DD, NW, ST, MB, SMEM)                                     \
  static_assert(DqSmem<DD, NW, ST>::BYTES == SMEM, "dq build bytes");      \
  if (kind == 0 && D == DD && block_rows == TILE * NW && stages == ST &&   \
      smem_bytes == SMEM) {                                                \
    return launch_dq<DD, NW, ST, MB>(p, w, sq_pad, prep, s);              \
  }
#define KV_BUILD(KIND, DD, NW, ST, MB, SMEM)                               \
  static_assert(FusedSmem<DD, NW, ST, KIND == 2>::BYTES == SMEM,           \
                "kv-tile build bytes");                                    \
  if (kind == KIND && D == DD && block_rows == TILE * NW &&                \
      stages == ST && smem_bytes == SMEM) {                                \
    return launch_kv_tiles<DD, NW, KIND == 2, ST, MB>(p, w, sq_pad, prep,  \
                                                      s);                  \
  }
  DQ_BUILD(64, 1, 4, 2, 83528)
  DQ_BUILD(64, 2, 4, 1, 100424)
  DQ_BUILD(128, 1, 4, 1, 165448)
  DQ_BUILD(128, 2, 4, 1, 198728)
  KV_BUILD(1, 64, 1, 4, 2, 85064)
  KV_BUILD(1, 128, 1, 4, 1, 166984)
  KV_BUILD(2, 64, 2, 3, 1, 117304)
  KV_BUILD(2, 128, 1, 3, 1, 150072)
#undef DQ_BUILD
#undef KV_BUILD
  return kInvalid;
}
