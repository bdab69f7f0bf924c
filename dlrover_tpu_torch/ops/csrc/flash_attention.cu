// Flash-attention forward for Hopper (sm_90a), bf16 in, fp32 softmax.
//
// Replaces the TPU kernel dlrover_tpu/ops/flash_attention.py:58 _fwd_kernel
// (reached through pl.pallas_call at :148, from _flash_fwd and mha).  Same
// function: causal or full attention with a segment mask and GQA (kv head
// = q head / group), online softmax in fp32 with P rounded to bf16 before
// P V, outputs o and lse, and a fully masked row gives o = 0 and
// lse = -1e30.
//
// What bounds it on this card: at the training shape (B 16, H 25, S 1024,
// D 64, causal) one call does 5.4e10 FLOP of products (0.054 ms at 989
// TFLOP/s) and moves 0.21 GB (q, k, v read once, o written once: 0.063 ms
// at 3.35 TB/s), so the roofline bound is the bytes, with the tensor cores
// close behind; the softmax between the two products (an exp2 and a few
// FMAs per score on the SMs' FP32 units) costs about as much issue time as
// the products themselves.  At the serving shapes (B 1, S <= 1024) the
// grid is small and the launch dominates.
//
// The design, built for Hopper (flash_hopper.cuh holds the pieces):
// * One block per (batch, q head, q tile) of one or two warpgroups, each
//   owning 64 q rows: 128-row tiles where the grid fills the card, 64
//   where B * H * ceil(S / 128) blocks would leave SMs idle (the host plan,
//   ops/flash_attention.py fwd_launch_plan).  At D 64 two 128-row blocks
//   share an SM (at most 128 registers a thread).  Under causal masking
//   the heaviest q tiles are launched first.
// * K and V stream through a 4-stage ring in shared memory, filled by TMA
//   (4-D maps over the strided [B, S, H, D] views as they are; rows past S
//   arrive as zeros) on full / empty mbarrier pairs.  Thread 0 issues the
//   loads: the q tile and the first four kv tiles at once, then each tile
//   as its stage comes free, two tiles ahead of the products, so loads
//   overlap the products without a producer warp.
// * S = Q K^T is a wgmma with both operands in shared memory and the fp32
//   scores in registers.  The online softmax runs on those accumulator
//   registers: a row's max and sum are quad shuffles (four threads hold a
//   row), exp2 with scale * log2(e) folded in, the row sum kept per thread
//   until the end.  P is rounded to bf16 in registers and is the register
//   A operand of the P V wgmma (V from shared memory through the transpose
//   bit); O accumulates and is rescaled in registers.  No score, no
//   probability and no output partial touches shared memory.
// * Each warpgroup pipelines its loop: tile i's Q K^T and tile i-1's P V
//   are issued together, and tile i's softmax runs while P V is on the
//   tensor cores.
// * Masks are evaluated only on tiles where they can bite: the causal
//   diagonal tile, the ragged kv edge, and every tile when segment ids are
//   given.
// What holds it back still: the softmax (exp2 on the SFU, FMAs on the FP32
// units) is as long as the two products and only P V hides it, and the
// warpgroups are not scheduled in ping-pong.

#include "flash_common.cuh"
#include "flash_hopper.cuh"

using namespace hopper;

namespace {

struct FwdParams {
  const int* seg_q;   // [B, Sq] or null
  const int* seg_kv;  // [B, Skv] or null
  bf16* o;            // [B, Sq, Hq, D] contiguous
  float* lse;         // [B, Hq, Sq] or null
  int Sq, Skv, Hq, group, n_qt;
  long long segq_sb, segkv_sb;
  float scale_log2;  // softmax scale * log2(e)
  int causal;
};

template <int D, int NWG, int STAGES>
struct FwdSmem {
  static constexpr int BLOCK_M = TILE * NWG;
  static constexpr uint32_t Q_BYTES = BLOCK_M * D * 2;
  static constexpr uint32_t KV_BYTES = TILE * D * 2;  // one K or V tile
  static constexpr uint32_t K_OFF = Q_BYTES;
  static constexpr uint32_t V_OFF = K_OFF + STAGES * KV_BYTES;
  static constexpr uint32_t BAR_OFF = V_OFF + STAGES * KV_BYTES;
  // q_full, full[STAGES], empty[STAGES]; 1024 bytes of alignment slack.
  static constexpr uint32_t BYTES = BAR_OFF + 8 * (1 + 2 * STAGES) + 1024;
};

// Blocks of an SM: two of the 128-row kind at D 64 (at most 128 registers
// a thread), so 16 consumer warps hide each other's latencies.
template <int D, int NWG>
constexpr int fwd_min_blocks() {
  return D == 64 ? (NWG == 2 ? 2 : 4) : 1;
}

template <int D, int NWG, int STAGES>
__global__ void __launch_bounds__(NWG * WG_THREADS, (fwd_min_blocks<D, NWG>()))
flash_fwd_kernel(const __grid_constant__ CUtensorMap q_map,
                 const __grid_constant__ CUtensorMap k_map,
                 const __grid_constant__ CUtensorMap v_map,
                 const FwdParams p) {
  using L = FwdSmem<D, NWG, STAGES>;
  constexpr int BLOCK_M = L::BLOCK_M;
  constexpr int SUBS = D / BOX_COLS;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align_1024(smem_raw);
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

  // Thread 0 issues every TMA load: the q tile and the first STAGES kv
  // tiles now, each later tile when its stage comes free (`release`).
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
    mbar_expect_tx(q_full, L::Q_BYTES);
    for (int c = 0; c < SUBS; ++c) {
      tma_load_4d(smem + c * BLOCK_M * ROW_BYTES, &q_map, q_full,
                  c * BOX_COLS, h, q0, b);
    }
    for (int i = 0; i < min(STAGES, n_tiles); ++i) load_kv(i);
  }
  // Every warp frees tile i's stage after its last read; thread 0 then
  // refills the stage of tile i - 1, once every warp has freed it, with
  // tile i - 1 + STAGES: one tile of slack, so it seldom waits.
  auto release = [&](int i) {
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[i % STAGES]);
    const int r = i - 1;
    if (threadIdx.x == 0 && r >= 0 && r + STAGES < n_tiles) {
      mbar_wait(&empty[r % STAGES], (r / STAGES) & 1);
      load_kv(r + STAGES);
    }
    __syncwarp();  // the warp's next wgmma is issued by all its lanes at once
  };

  // Warpgroup wg owns q rows [q0 + 64 wg, q0 + 64 wg + 64); this thread
  // holds rows row0 and row0 + 8 of them.
  const int wg = warp / 4;
  const int g = lane / 4;
  const int t = lane % 4;
  const int wg_q0 = q0 + wg * TILE;
  const int row0 = wg_q0 + (warp % 4) * 16 + g;
  const int wg_kv_end = p.causal ? min(p.Skv, wg_q0 + TILE) : p.Skv;
  const bool has_seg = p.seg_q != nullptr;
  int seg_row[2] = {0, 0};
  if (has_seg) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int qi = row0 + 8 * r;
      seg_row[r] = qi < p.Sq ? p.seg_q[b * p.segq_sb + qi] : -1;
    }
  }

  float acc_o[D / 2];
#pragma unroll
  for (int j = 0; j < D / 2; ++j) acc_o[j] = 0.f;
  float m_run[2] = {-INFINITY, -INFINITY};
  float l_run[2] = {0.f, 0.f};  // this thread's share of the row sums
  float corr[2] = {1.f, 1.f};
  float sc[32];
  uint32_t pa[TILE / 16][4];
  const uint32_t q_addr = smem_u32(smem) + wg * TILE * ROW_BYTES;

  // S = Q K^T of tile i into sc (issued, not waited for).
  auto issue_qk = [&](int i) {
    const uint32_t k_addr =
        smem_u32(smem + L::K_OFF + (i % STAGES) * L::KV_BYTES);
#pragma unroll
    for (int j = 0; j < 32; ++j) sc[j] = 0.f;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t off = (kk % 4) * 32;
      wgmma_ss<0, 0>(
          sc, desc_kmajor(q_addr + (kk / 4) * BLOCK_M * ROW_BYTES + off),
          desc_kmajor(k_addr + (kk / 4) * TILE * ROW_BYTES + off), kk > 0);
    }
    wgmma_commit();
  };
  // O += P V of tile i, P (bf16) from the registers (issued, not waited).
  auto issue_pv = [&](int i) {
    const uint32_t v_addr =
        smem_u32(smem + L::V_OFF + (i % STAGES) * L::KV_BYTES);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < TILE / 16; ++kk) {
      wgmma_rs<1>(acc_o, pa[kk],
                  desc_mnmajor(v_addr + kk * 16 * ROW_BYTES,
                               TILE * ROW_BYTES),
                  1);
    }
    wgmma_commit();
  };
  // The online softmax of tile i on the accumulator registers: sc becomes
  // p (fp32), corr the factor that rescales the rows' earlier sums.
  auto softmax = [&](int i) {
    const int n0 = i * TILE;
    // Scale into the log2 domain; mask where a mask can bite.
    const bool need_mask = has_seg || n0 + TILE > p.Skv ||
                           (p.causal && n0 + TILE - 1 > wg_q0);
    if (need_mask) {
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        int seg_col[2] = {0, 0};
        if (has_seg) {
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
            const int kj = n0 + 8 * c + 2 * t + e;
            const bool keep = kj < p.Skv &&
                              (!p.causal || kj <= row0 + 8 * r) &&
                              seg_row[r] == seg_col[e];
            sc[j] = keep ? sc[j] * p.scale_log2 : -INFINITY;
          }
        }
      }
    } else {
#pragma unroll
      for (int j = 0; j < 32; ++j) sc[j] *= p.scale_log2;
    }
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      mx[(j / 2) % 2] = fmaxf(mx[(j / 2) % 2], sc[j]);
    }
    float m_use[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m_run[r], mx[r]);
      // A row with nothing live so far keeps m = -inf: subtract 0 so its
      // probabilities stay 0 instead of NaN.
      m_use[r] = m_new == -INFINITY ? 0.f : m_new;
      corr[r] = fast_exp2(m_run[r] - m_use[r]);
      m_run[r] = m_new;
    }
    float rsum[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const int r = (j / 2) % 2;
      sc[j] = fast_exp2(sc[j] - m_use[r]);
      rsum[r] += sc[j];
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) l_run[r] = l_run[r] * corr[r] + rsum[r];
  };
  // The warpgroup computes kv tiles [0, n_w) (under causal masking the
  // block's last tile may lie wholly above its rows) and passes the rest.
  // Software pipeline: tile i's Q K^T and tile i - 1's P V are issued
  // together, and tile i's softmax runs while P V is on the tensor cores.
  const int n_w = (wg_kv_end + TILE - 1) / TILE;
  mbar_wait(q_full, 0);
  if (n_w > 0) {
    mbar_wait(&full[0], 0);
    issue_qk(0);
    wgmma_wait<0>();
    fence_regs(sc);
    softmax(0);
    to_a_frags(sc, pa);
    for (int i = 1; i < n_w; ++i) {
      mbar_wait(&full[i % STAGES], (i / STAGES) & 1);
      issue_qk(i);
      issue_pv(i - 1);
      wgmma_wait<1>();  // Q K^T done; P V may still run
      fence_regs(sc);
      softmax(i);
      wgmma_wait<0>();
      fence_regs(acc_o);
      fence_regs(pa);
      release(i - 1);
      // Rows whose max did not move need no rescale (corr is 1 there).
      if (__any_sync(0xffffffffu, corr[0] != 1.f || corr[1] != 1.f)) {
#pragma unroll
        for (int j = 0; j < D / 2; ++j) acc_o[j] *= corr[(j / 2) % 2];
      }
      to_a_frags(sc, pa);
    }
    issue_pv(n_w - 1);
    wgmma_wait<0>();
    fence_regs(acc_o);
    fence_regs(pa);
    release(n_w - 1);
  }
  for (int i = n_w; i < n_tiles; ++i) {
    mbar_wait(&full[i % STAGES], (i / STAGES) & 1);
    release(i);
  }

  // o = O / l (0 for a fully masked row), lse = (m + log2 l) ln 2.
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 1);
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 2);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = row0 + 8 * r;
    if (qi >= p.Sq) continue;
    const float inv = l_run[r] == 0.f ? 0.f : 1.f / l_run[r];
    bf16* orow = p.o + (static_cast<long long>(b) * p.Sq + qi) * p.Hq * D +
                 static_cast<long long>(h) * D;
#pragma unroll
    for (int c = 0; c < D / 8; ++c) {
      *reinterpret_cast<uint32_t*>(orow + 8 * c + 2 * t) =
          pack_bf16(acc_o[4 * c + 2 * r] * inv, acc_o[4 * c + 2 * r + 1] * inv);
    }
    if (p.lse != nullptr && t == 0) {
      p.lse[(static_cast<long long>(b) * p.Hq + h) * p.Sq + qi] =
          l_run[r] == 0.f ? flash::NEG_INF
                          : (m_run[r] + log2f(l_run[r])) * LN2;
    }
  }
}

template <int D, int NWG>
int launch(const void* q, const void* k, const void* v, FwdParams p, int B,
           int Hkv, long long q_sb, long long q_ss, long long q_sh,
           long long k_sb, long long k_ss, long long k_sh, long long v_sb,
           long long v_ss, long long v_sh, cudaStream_t stream) {
  constexpr int STAGES = 4;
  constexpr int BLOCK_M = TILE * NWG;
  using L = FwdSmem<D, NWG, STAGES>;
  CUtensorMap q_map, k_map, v_map;
  cudaError_t err = make_rows_map(&q_map, q, B, p.Sq, p.Hq, D, q_sb, q_ss,
                                  q_sh, BLOCK_M);
  if (err == cudaSuccess) {
    err = make_rows_map(&k_map, k, B, p.Skv, Hkv, D, k_sb, k_ss, k_sh, TILE);
  }
  if (err == cudaSuccess) {
    err = make_rows_map(&v_map, v, B, p.Skv, Hkv, D, v_sb, v_ss, v_sh, TILE);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  static bool opted_in[64] = {};
  err = flash::opt_in_smem(flash_fwd_kernel<D, NWG, STAGES>, L::BYTES,
                           opted_in);
  if (err != cudaSuccess) return static_cast<int>(err);
  p.n_qt = (p.Sq + BLOCK_M - 1) / BLOCK_M;
  dim3 grid(B * p.Hq, p.n_qt);
  flash_fwd_kernel<D, NWG, STAGES>
      <<<grid, NWG * WG_THREADS, L::BYTES, stream>>>(q_map, k_map, v_map,
                                                      p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q [B, Sq, Hq, D], k/v [B, Skv, Hkv, D]: bf16 views with unit stride on D,
// 16-byte aligned, and the other strides (in elements) multiples of 8;
// seg_q [B, Sq] / seg_kv [B, Skv] int32 or null; o [B, Sq, Hq, D]
// contiguous bf16; lse [B, Hq, Sq] fp32 or null.  block_m (64 or 128) is
// the q rows of a block, from the host plan.  Returns cudaGetLastError()
// after the launch (0 = ok).
extern "C" int flash_fwd_bf16(
    const void* q, const void* k, const void* v, const void* seg_q,
    const void* seg_kv, void* o, void* lse, int B, int Sq, int Skv, int Hq,
    int Hkv, int D, long long q_sb, long long q_ss, long long q_sh,
    long long k_sb, long long k_ss, long long k_sh, long long v_sb,
    long long v_ss, long long v_sh, long long segq_sb, long long segkv_sb,
    float scale, int causal, int block_m, void* stream) {
  if (Hkv < 1 || Hq % Hkv != 0) return static_cast<int>(cudaErrorInvalidValue);
  FwdParams p;
  p.seg_q = static_cast<const int*>(seg_q);
  p.seg_kv = static_cast<const int*>(seg_kv);
  p.o = static_cast<bf16*>(o);
  p.lse = static_cast<float*>(lse);
  p.Sq = Sq;
  p.Skv = Skv;
  p.Hq = Hq;
  p.group = Hq / Hkv;
  p.n_qt = 0;
  p.segq_sb = segq_sb;
  p.segkv_sb = segkv_sb;
  p.scale_log2 = scale * LOG2E;
  p.causal = causal;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define FWD_CASE(DD, NW)                                                     \
  if (D == DD && block_m == TILE * NW) {                                     \
    return launch<DD, NW>(q, k, v, p, B, Hkv, q_sb, q_ss, q_sh, k_sb, k_ss,  \
                          k_sh, v_sb, v_ss, v_sh, s);                        \
  }
  FWD_CASE(64, 1)
  FWD_CASE(64, 2)
  FWD_CASE(128, 1)
  FWD_CASE(128, 2)
#undef FWD_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}
