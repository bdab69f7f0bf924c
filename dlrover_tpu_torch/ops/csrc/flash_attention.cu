// Flash-attention forward for Hopper (sm_90a), bf16 in, fp32 softmax.
//
// Replaces the TPU kernel dlrover_tpu/ops/flash_attention.py:_fwd_kernel
// (reached through _flash_fwd and mha).  Same function: causal or full
// attention with a segment mask and GQA (kv head = q head / group), online
// softmax in fp32, outputs o and lse, and a fully masked row gives o = 0 and
// lse = -1e30.
//
// What bounds it on this card: at the serving shapes (B = 1, H = 25,
// D = 64, S <= 1024, causal) one call moves a few MB (q, k, v read once,
// o written once) and does a few GFLOP, so the roofline bound is the bytes
// (a few microseconds at 3.35 TB/s); in practice the launch and the small
// grid (H * ceil(S / 64) blocks) dominate.  What the design does about it:
// the S x S score matrix never touches device memory (scores, probabilities
// and the running output stay in shared memory), q/k/v are read straight
// from the strided [B, S, H, D] views the fused qkv projection produces
// (no transpose, no padding copy), causal tiles above the diagonal are
// skipped by bounding the kv loop, and both matmuls run on tensor cores.
//
// Layout: one block of 4 warps owns one (batch, head, 64-row q tile) and
// loops over 64-row kv tiles; the TPU's sequential kv grid axis becomes
// that loop.  Each warp owns 16 q rows for S = Q K^T, the softmax and
// O += P V, so only the K/V tile loads need the whole block to sync.
// Tensor-core products use nvcuda::wmma bf16 16x16x16 fragments with fp32
// accumulation; the running output O lives in fp32 shared memory so the
// per-row rescale of the online softmax is plain elementwise work.
// wgmma, TMA and warp specialisation are left for a performance pass.

#include "flash_common.cuh"

using namespace flash;

namespace {

// Shared-memory plan.  Leading dimensions are padded (wmma needs a multiple
// of 8 bf16 / 4 fp32 elements, and every fragment pointer 32-byte aligned,
// which these offsets keep) and break up bank conflicts on the row walks.
template <int D>
struct Smem {
  static constexpr int LD_T = D + 8;        // q/k/v tiles, bf16
  static constexpr int LD_S = BLOCK_N + 4;  // scores, fp32
  static constexpr int LD_P = BLOCK_N + 8;  // probabilities, bf16
  static constexpr int LD_O = D + 4;        // running output, fp32
  static constexpr size_t Q_OFF = 0;
  static constexpr size_t K_OFF = Q_OFF + sizeof(bf16) * BLOCK_M * LD_T;
  static constexpr size_t V_OFF = K_OFF + sizeof(bf16) * BLOCK_N * LD_T;
  static constexpr size_t S_OFF = V_OFF + sizeof(bf16) * BLOCK_N * LD_T;
  static constexpr size_t P_OFF = S_OFF + sizeof(float) * BLOCK_M * LD_S;
  static constexpr size_t O_OFF = P_OFF + sizeof(bf16) * BLOCK_M * LD_P;
  static constexpr size_t ROW_OFF = O_OFF + sizeof(float) * BLOCK_M * LD_O;
  static constexpr size_t SEG_OFF = ROW_OFF + sizeof(float) * 3 * BLOCK_M;
  static constexpr size_t BYTES = SEG_OFF + sizeof(int) * (BLOCK_M + BLOCK_N);
};

template <int D>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, const int* __restrict__ seg_q,
                 const int* __restrict__ seg_kv, bf16* __restrict__ o,
                 float* __restrict__ lse, int Sq, int Skv, int Hq, int group,
                 long long q_sb, long long q_ss, long long q_sh,
                 long long k_sb, long long k_ss, long long k_sh,
                 long long v_sb, long long v_ss, long long v_sh,
                 long long segq_sb, long long segkv_sb, float scale,
                 int causal) {
  using L = Smem<D>;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem + L::Q_OFF);
  bf16* Ks = reinterpret_cast<bf16*>(smem + L::K_OFF);
  bf16* Vs = reinterpret_cast<bf16*>(smem + L::V_OFF);
  float* Ss = reinterpret_cast<float*>(smem + L::S_OFF);
  bf16* Ps = reinterpret_cast<bf16*>(smem + L::P_OFF);
  float* Os = reinterpret_cast<float*>(smem + L::O_OFF);
  float* m_s = reinterpret_cast<float*>(smem + L::ROW_OFF);
  float* l_s = m_s + BLOCK_M;
  float* c_s = l_s + BLOCK_M;
  int* segq_s = reinterpret_cast<int*>(smem + L::SEG_OFF);
  int* segkv_s = segq_s + BLOCK_M;

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int q0 = blockIdx.x * BLOCK_M;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / group;
  const bf16* qb = q + b * q_sb + h * q_sh;
  const bf16* kb = k + b * k_sb + hk * k_sh;
  const bf16* vb = v + b * v_sb + hk * v_sh;

  load_tile<D, BLOCK_M, L::LD_T>(Qs, qb, q_ss, q0, Sq, tid);
  for (int i = tid; i < BLOCK_M * L::LD_O; i += THREADS) Os[i] = 0.f;
  if (tid < BLOCK_M) {
    m_s[tid] = NEG_INF;
    l_s[tid] = 0.f;
    const int gi = q0 + tid;
    segq_s[tid] = seg_q ? (gi < Sq ? seg_q[b * segq_sb + gi] : -1) : 0;
  }

  const int r0 = warp * ROWS_PER_WARP;
  // Causal whole-tile skip: no row of this q tile sees a column past its
  // last row, so the kv loop stops there.
  const int kv_end = causal ? min(Skv, q0 + BLOCK_M) : Skv;
  for (int n0 = 0; n0 < kv_end; n0 += BLOCK_N) {
    __syncthreads();  // the previous tile's K/V reads are finished
    load_tile<D, BLOCK_N, L::LD_T>(Ks, kb, k_ss, n0, Skv, tid);
    load_tile<D, BLOCK_N, L::LD_T>(Vs, vb, v_ss, n0, Skv, tid);
    if (tid < BLOCK_N) {
      const int gj = n0 + tid;
      segkv_s[tid] = seg_kv ? (gj < Skv ? seg_kv[b * segkv_sb + gj] : -2) : 0;
    }
    __syncthreads();

    // S = Q K^T for this warp's 16 rows (fp32 accumulate).
    for (int nt = 0; nt < BLOCK_N / 16; ++nt) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::fill_fragment(acc, 0.f);
      for (int kk = 0; kk < D / 16; ++kk) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> bt;
        wmma::load_matrix_sync(a, Qs + r0 * L::LD_T + kk * 16, L::LD_T);
        wmma::load_matrix_sync(bt, Ks + nt * 16 * L::LD_T + kk * 16, L::LD_T);
        wmma::mma_sync(acc, a, bt, acc);
      }
      wmma::store_matrix_sync(Ss + r0 * L::LD_S + nt * 16, acc, L::LD_S,
                              wmma::mem_row_major);
    }
    __syncwarp();

    // Online softmax, one row at a time across the warp (2 columns a lane).
    for (int rr = 0; rr < ROWS_PER_WARP; ++rr) {
      const int r = r0 + rr;
      const int gi = q0 + r;
      float sv[BLOCK_N / 32];
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < BLOCK_N / 32; ++j) {
        const int c = lane + 32 * j;
        const int gj = n0 + c;
        const bool keep = gj < Skv && (!causal || gj <= gi) &&
                          segq_s[r] == segkv_s[c];
        sv[j] = keep ? Ss[r * L::LD_S + c] * scale : NEG_INF;
        mx = fmaxf(mx, sv[j]);
      }
      mx = warp_max(mx);
      const float m_prev = m_s[r];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < BLOCK_N / 32; ++j) {
        // Rows masked so far keep m at NEG_INF: freeze p to 0 there.
        const float p = (m_new == NEG_INF) ? 0.f : expf(sv[j] - m_new);
        Ps[r * L::LD_P + lane + 32 * j] = __float2bfloat16(p);
        sum += p;
      }
      sum = warp_sum(sum);
      const float corr = (m_prev == NEG_INF) ? 0.f : expf(m_prev - m_new);
      if (lane == 0) {
        m_s[r] = m_new;
        l_s[r] = corr * l_s[r] + sum;
        c_s[r] = corr;
      }
    }
    __syncwarp();

    for (int i = lane; i < ROWS_PER_WARP * D; i += 32) {
      const int r = r0 + i / D;
      Os[r * L::LD_O + i % D] *= c_s[r];
    }
    __syncwarp();

    // O += P V (bf16 probabilities, fp32 accumulate).
    for (int nt = 0; nt < D / 16; ++nt) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::load_matrix_sync(acc, Os + r0 * L::LD_O + nt * 16, L::LD_O,
                             wmma::mem_row_major);
      for (int kk = 0; kk < BLOCK_N / 16; ++kk) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bv;
        wmma::load_matrix_sync(a, Ps + r0 * L::LD_P + kk * 16, L::LD_P);
        wmma::load_matrix_sync(bv, Vs + kk * 16 * L::LD_T + nt * 16, L::LD_T);
        wmma::mma_sync(acc, a, bv, acc);
      }
      wmma::store_matrix_sync(Os + r0 * L::LD_O + nt * 16, acc, L::LD_O,
                              wmma::mem_row_major);
    }
    __syncwarp();
  }
  __syncwarp();

  // Finalize: o = O / l (0 for a fully masked row), lse = m + log l.
  const long long o_row = static_cast<long long>(Hq) * D;
  for (int i = lane; i < ROWS_PER_WARP * D; i += 32) {
    const int r = r0 + i / D;
    const int c = i % D;
    const int gi = q0 + r;
    if (gi >= Sq) continue;
    const float l = l_s[r];
    const float val = (l == 0.f) ? 0.f : Os[r * L::LD_O + c] / l;
    o[(static_cast<long long>(b) * Sq + gi) * o_row +
      static_cast<long long>(h) * D + c] = __float2bfloat16(val);
  }
  if (lse != nullptr && lane < ROWS_PER_WARP) {
    const int r = r0 + lane;
    const int gi = q0 + r;
    if (gi < Sq) {
      const float l = l_s[r];
      lse[(static_cast<long long>(b) * Hq + h) * Sq + gi] =
          (l == 0.f) ? NEG_INF : m_s[r] + logf(l);
    }
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, const void* seg_q,
           const void* seg_kv, void* o, void* lse, int B, int Sq, int Skv,
           int Hq, int Hkv, long long q_sb, long long q_ss, long long q_sh,
           long long k_sb, long long k_ss, long long k_sh, long long v_sb,
           long long v_ss, long long v_sh, long long segq_sb,
           long long segkv_sb, float scale, int causal, cudaStream_t stream) {
  using L = Smem<D>;
  static bool opted_in[64] = {};
  cudaError_t err = opt_in_smem(flash_fwd_kernel<D>, L::BYTES, opted_in);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((Sq + BLOCK_M - 1) / BLOCK_M, Hq, B);
  flash_fwd_kernel<D><<<grid, THREADS, L::BYTES, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const int*>(seg_q),
      static_cast<const int*>(seg_kv), static_cast<bf16*>(o),
      static_cast<float*>(lse), Sq, Skv, Hq, Hq / Hkv, q_sb, q_ss, q_sh,
      k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, segq_sb, segkv_sb, scale, causal);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q [B, Sq, Hq, D], k/v [B, Skv, Hkv, D]: bf16 views with unit stride on D
// and the other strides (in elements) given; seg_q [B, Sq] / seg_kv
// [B, Skv] int32 or null; o [B, Sq, Hq, D] contiguous bf16; lse [B, Hq, Sq]
// fp32 or null.  Returns cudaGetLastError() after the launch (0 = ok).
extern "C" int flash_fwd_bf16(
    const void* q, const void* k, const void* v, const void* seg_q,
    const void* seg_kv, void* o, void* lse, int B, int Sq, int Skv, int Hq,
    int Hkv, int D, long long q_sb, long long q_ss, long long q_sh,
    long long k_sb, long long k_ss, long long k_sh, long long v_sb,
    long long v_ss, long long v_sh, long long segq_sb, long long segkv_sb,
    float scale, int causal, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64:
      return launch<64>(q, k, v, seg_q, seg_kv, o, lse, B, Sq, Skv, Hq, Hkv,
                        q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh,
                        segq_sb, segkv_sb, scale, causal, s);
    case 128:
      return launch<128>(q, k, v, seg_q, seg_kv, o, lse, B, Sq, Skv, Hq, Hkv,
                         q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh,
                         segq_sb, segkv_sb, scale, causal, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
