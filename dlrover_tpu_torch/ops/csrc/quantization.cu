// Block quantization and the low-bit Adam updates on Hopper (sm_90a).
//
// Replaces the TPU kernels of dlrover_tpu/ops/quantization.py:
//   K5a _quant_kernel     per-256-block absmax int8 quantize;
//   K5b _dequant_kernel   int8 x per-block scale -> fp32;
//   K6  _q8_adam_kernel   dequantize m (linear) and v (4th-root map) ->
//                         Adam -> update -> requantize, int8 codes;
//   K7  _q4_adam_kernel   the same with nibbles packed two per byte: m
//                         signed [-7, 7] on a sqrt map, v unsigned [0, 15]
//                         on the 4th-root map.
// A block is 256 consecutive values of the flattened array; block r has
// one fp32 scale, scales[r].  Codes are int8 [R, 256] (q4: [R, 128], byte
// j of a row holding element 2j in its low nibble and 2j + 1 in its
// high).  Elements past n in the last block read as 0 and their codes
// are written as 0.
//
// What bounds K5a, K5b and K6 on this card: bytes, and for the Adam
// kernels the arithmetic close behind.  Per parameter K6 reads g and p,
// two codes and writes the update and two codes (10 bytes with bf16 g
// and p, plus 16 bytes of scales per 256).  What the design does about
// it: one pass, nothing but the operands crosses device memory.  g and p
// are read in their own dtype and converted in registers, the update is
// written in p's dtype, and the state is updated in place.  One warp owns
// one block: a lane holds 8 consecutive values (16-byte loads for bf16, 8
// for int8 codes, 4 for nibbles), the block's absmax is a warp shuffle.
//
// Arithmetic.  Every float operation is a single IEEE round-to-nearest
// operation (__fmul_rn, __fadd_rn, __fdiv_rn, __fsqrt_rn: no fused
// multiply-add where the plain version rounds twice), in the order the
// TPU kernel states them, and codes round half to even (rintf), as
// jnp.round does.  A quotient one ulp off would move a value across a .5
// boundary and the code by one level.
//
// K7.  8.06 bytes a value (bf16 g, p and update, two nibbles read and
// written, the scales): 1.18 ms at the largest leaf of GPT-2 1.5B by
// bytes.  Its first version spent 3 correctly rounded divisions and 4
// roots a value (each a MUFU op, a Newton step and a check) and about ten
// multiplications to decode two nibbles, and was bound by the
// instructions they issue, at 46% of the bytes' bound.  It now computes
// the same bits with a fraction of that arithmetic:
// - decode: what a nibble decodes to before the block's scale depends on
//   the nibble alone, so it is a table of 16 (Q4Maps, made on the host by
//   the plain version's own decode at scale 1): one read and one
//   __fmul_rn by the scale, equal by construction;
// - the two quotients by the block's scale: r = RN(1 / s) once a warp,
//   then per value q0 = RN(x r) and one fma correction, which gives
//   RN(x / s) exactly (Markstein's theorem) while s and r are normal; a
//   block whose s or r is not takes __fdiv_rn (a branch uniform over the
//   warp, same bits).  A quotient below 2^-126 is code 0 on both maps;
// - codes: round(7 sqrt(q)) and round(15 q^(1/4)), clamped, are monotone
//   step functions of q, so a code is the number of its thresholds <= q
//   (7 for m's level, 15 for v), found on the host by bisection over
//   float32 bit patterns through the plain version's own chain, ties
//   included.  K7 counts them through a table of bins of q's bits: one
//   read and one compare a code (code_of).  chip_smoke.py checks every
//   float32 x in [0, s] for 145 scales against the IEEE chain
//   (q4_code_check, below).
// Adam's own division and root stay __fdiv_rn and __fsqrt_rn: 2 MUFU
// operations a value, where there were 7; their range checks and slow
// paths, one branch region each, now take most of what a value issues.
// The tables and bins (1712 bytes) are passed by value and copied into
// shared memory; the copy cost a tenth of K7's time when every CTA of 8
// blocks made it, so K7's CTAs are persistent: as many as the card holds
// at once (4 an SM at 60 registers), each warp walking blocks on a
// grid-stride loop.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <cfloat>
#include <cstring>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int BLOCK = 256;          // values per quantization block
constexpr int PER_LANE = 8;         // BLOCK / 32
constexpr int WARPS = 8;            // warps (blocks of values) per CTA
constexpr int THREADS = WARPS * 32;

__device__ __forceinline__ float warp_max(float x) {
  for (int off = 16; off > 0; off >>= 1) {
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
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

// 8 consecutive values starting at element i (a multiple of 8) of a flat
// array of n, as floats; 0 past the end.  The base is 16-byte aligned.
template <typename T>
__device__ __forceinline__ void load8(const T* base, long long i,
                                      long long n, float (&out)[8]) {
  if (i + PER_LANE <= n) {
    __align__(16) T tmp[8];
    constexpr int VECS = sizeof(T) * 8 / 16;
    const uint4* src = reinterpret_cast<const uint4*>(base + i);
#pragma unroll
    for (int v = 0; v < VECS; ++v) reinterpret_cast<uint4*>(tmp)[v] = src[v];
#pragma unroll
    for (int k = 0; k < 8; ++k) out[k] = to_float(tmp[k]);
  } else {
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      out[k] = (i + k < n) ? to_float(base[i + k]) : 0.0f;
    }
  }
}

template <typename T>
__device__ __forceinline__ void store8(T* base, long long i, long long n,
                                       const float (&val)[8]) {
  if (i + PER_LANE <= n) {
    __align__(16) T tmp[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) from_float(val[k], &tmp[k]);
    constexpr int VECS = sizeof(T) * 8 / 16;
    uint4* dst = reinterpret_cast<uint4*>(base + i);
#pragma unroll
    for (int v = 0; v < VECS; ++v) dst[v] = reinterpret_cast<uint4*>(tmp)[v];
  } else {
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      if (i + k < n) from_float(val[k], &base[i + k]);
    }
  }
}

__device__ __forceinline__ void load_codes8(const int8_t* q, long long i,
                                            int (&out)[8]) {
  const uint2 raw = *reinterpret_cast<const uint2*>(q + i);
  const int8_t* b = reinterpret_cast<const int8_t*>(&raw);
#pragma unroll
  for (int k = 0; k < 8; ++k) out[k] = b[k];
}

__device__ __forceinline__ void store_codes8(int8_t* q, long long i,
                                             const int (&val)[8]) {
  uint2 raw;
  int8_t* b = reinterpret_cast<int8_t*>(&raw);
#pragma unroll
  for (int k = 0; k < 8; ++k) b[k] = static_cast<int8_t>(val[k]);
  *reinterpret_cast<uint2*>(q + i) = raw;
}

__device__ __forceinline__ float clampf(float x, float lo, float hi) {
  return fminf(fmaxf(x, lo), hi);
}

struct Hyper {
  float lr, b1, b2, eps, wd, bias_scale;
};

// One Adam step on a value: m, v updated in place, the update returned.
__device__ __forceinline__ float adam(const Hyper& h, float g, float p,
                                      float& m, float& v) {
  const float omb1 = __fsub_rn(1.0f, h.b1);
  const float omb2 = __fsub_rn(1.0f, h.b2);
  m = __fadd_rn(__fmul_rn(h.b1, m), __fmul_rn(omb1, g));
  v = __fadd_rn(__fmul_rn(h.b2, v), __fmul_rn(__fmul_rn(omb2, g), g));
  const float step = __fdiv_rn(__fmul_rn(m, h.bias_scale),
                               __fadd_rn(__fsqrt_rn(v), h.eps));
  return __fmul_rn(-h.lr, __fadd_rn(step, __fmul_rn(h.wd, p)));
}

// -- K5a / K5b ---------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(THREADS)
quantize_kernel(const T* __restrict__ x, int8_t* __restrict__ q,
                float* __restrict__ scales, long long n, long long rows) {
  const long long row =
      static_cast<long long>(blockIdx.x) * WARPS + (threadIdx.x >> 5);
  if (row >= rows) return;
  const int lane = threadIdx.x & 31;
  const long long i = row * BLOCK + lane * PER_LANE;
  float val[8];
  load8(x, i, n, val);
  float absmax = 0.0f;
#pragma unroll
  for (int k = 0; k < 8; ++k) absmax = fmaxf(absmax, fabsf(val[k]));
  absmax = warp_max(absmax);
  const float scale = (absmax == 0.0f) ? 1.0f : __fdiv_rn(absmax, 127.0f);
  int code[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    code[k] = static_cast<int>(
        clampf(rintf(__fdiv_rn(val[k], scale)), -127.0f, 127.0f));
  }
  store_codes8(q, i, code);
  if (lane == 0) scales[row] = scale;
}

__global__ void __launch_bounds__(THREADS)
dequantize_kernel(const int8_t* __restrict__ q,
                  const float* __restrict__ scales, float* __restrict__ out,
                  long long n, long long rows) {
  const long long row =
      static_cast<long long>(blockIdx.x) * WARPS + (threadIdx.x >> 5);
  if (row >= rows) return;
  const int lane = threadIdx.x & 31;
  const long long i = row * BLOCK + lane * PER_LANE;
  if (i >= n) return;
  int code[8];
  load_codes8(q, i, code);
  const float scale = scales[row];
  float val[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    val[k] = __fmul_rn(static_cast<float>(code[k]), scale);
  }
  store8(out, i, n, val);
}

// -- K6 ------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(THREADS)
q8_adam_kernel(const T* __restrict__ g, const T* __restrict__ p,
               int8_t* __restrict__ mq, float* __restrict__ ms,
               int8_t* __restrict__ vq, float* __restrict__ vs,
               T* __restrict__ upd, long long n, long long rows, Hyper h) {
  const long long row =
      static_cast<long long>(blockIdx.x) * WARPS + (threadIdx.x >> 5);
  if (row >= rows) return;
  const int lane = threadIdx.x & 31;
  const long long i = row * BLOCK + lane * PER_LANE;
  float gv[8], pv[8], m[8], v[8], u[8];
  int code[8];
  load8(g, i, n, gv);
  load8(p, i, n, pv);
  const float m_scale_in = ms[row];
  const float v_scale_in = vs[row];
  load_codes8(mq, i, code);
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    m[k] = __fmul_rn(static_cast<float>(code[k]), m_scale_in);
  }
  load_codes8(vq, i, code);
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const float vn = __fmul_rn(static_cast<float>(code[k]), 1.0f / 127.0f);
    const float sq = __fmul_rn(vn, vn);
    v[k] = __fmul_rn(__fmul_rn(sq, sq), v_scale_in);
  }
  float m_absmax = 0.0f, v_max = 0.0f;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    u[k] = adam(h, gv[k], pv[k], m[k], v[k]);
    m_absmax = fmaxf(m_absmax, fabsf(m[k]));
    v_max = fmaxf(v_max, v[k]);
  }
  store8(upd, i, n, u);
  m_absmax = warp_max(m_absmax);
  v_max = warp_max(v_max);
  const float m_scale =
      (m_absmax == 0.0f) ? 1.0f : __fdiv_rn(m_absmax, 127.0f);
  const float v_scale = (v_max == 0.0f) ? 1.0f : v_max;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    code[k] = static_cast<int>(
        clampf(rintf(__fdiv_rn(m[k], m_scale)), -127.0f, 127.0f));
  }
  store_codes8(mq, i, code);
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const float vn = __fsqrt_rn(__fsqrt_rn(__fdiv_rn(v[k], v_scale)));
    code[k] =
        static_cast<int>(clampf(rintf(__fmul_rn(127.0f, vn)), 0.0f, 127.0f));
  }
  store_codes8(vq, i, code);
  if (lane == 0) {
    ms[row] = m_scale;
    vs[row] = v_scale;
  }
}

inline long long blocks_for(long long rows) {
  return (rows + WARPS - 1) / WARPS;
}

// -- K7 ------------------------------------------------------------------------

// A code from its quotient q in [0, 1] (or NaN): the number of the map's
// thresholds <= q (7 for m's level, 15 for v's code; ops/quantization.
// q4_maps finds them).  K7 reads it from a table of bins: q's bin is its
// float32 bits >> BIN_SHIFT (the exponent and the top two mantissa bits,
// so a bin spans at most a factor 1.25 and holds at most one threshold of
// either map, whose neighbours lie a factor 1.33 or more apart), and the
// bin gives the thresholds below it and the one inside it (+inf if none):
// code = base + (q >= t), one 8-byte read and one compare.  Bin 0 takes
// every q below 2^-24 (code 0: each map's least threshold lies above),
// bins 1 .. BINS - 2 the keys BIN_LOW .. BIN_HIGH (2^-24 up to 1.0), and
// the last one any larger key (NaN and -0.0, code 0).
constexpr int BIN_SHIFT = 21;
constexpr int BIN_LOW = 0x33800000 >> BIN_SHIFT;   // 2^-24
constexpr int BIN_HIGH = 0x3F800000 >> BIN_SHIFT;  // 1.0
constexpr int BINS = BIN_HIGH - BIN_LOW + 3;

struct __align__(8) Q4Bin {
  float t;   // the threshold inside the bin, +inf if none
  int base;  // the thresholds below the bin
};

// The q4 maps, from ops/quantization.q4_maps, passed by value: what a
// nibble decodes to at scale 1, and each map's bins.
struct Q4Maps {
  float m_table[16];  // by m's raw nibble: 8..15 are the codes -8..-1
  float v_table[16];
  Q4Bin m_bins[BINS];
  Q4Bin v_bins[BINS];
};
constexpr int Q4_MAP_WORDS = sizeof(Q4Maps) / 4;

// The maps in the block's shared memory.  Every thread of the block
// calls it, before any leaves: the copy ends in a barrier.
__device__ __forceinline__ const Q4Maps& maps_in_shared(const Q4Maps& maps,
                                                        Q4Maps& smem) {
  const uint32_t* src = reinterpret_cast<const uint32_t*>(&maps);
  uint32_t* dst = reinterpret_cast<uint32_t*>(&smem);
  for (int i = threadIdx.x; i < Q4_MAP_WORDS; i += blockDim.x) dst[i] = src[i];
  __syncthreads();
  return smem;
}

__device__ __forceinline__ int code_of(const Q4Bin* bins, float q) {
  const int key = static_cast<int>(__float_as_uint(q) >> BIN_SHIFT);
  const Q4Bin bin = bins[min(max(key - BIN_LOW + 1, 0), BINS - 1)];
  return bin.base + ((q >= bin.t) ? 1 : 0);
}

// A block's scale s and r = RN(1 / s).  fast: s and r are both normal,
// and RN(x / s) = fma(fma(-q0, s, x), r, q0) with q0 = RN(x r).
struct Divisor {
  float s, r;
  bool fast;
};

__device__ __forceinline__ Divisor divisor(float s) {
  const float r = __frcp_rn(s);
  return {s, r, s >= FLT_MIN && r >= FLT_MIN};
}

template <bool FAST>
__device__ __forceinline__ float quotient(float x, const Divisor& d) {
  if constexpr (FAST) {
    const float q0 = __fmul_rn(x, d.r);
    return __fmaf_rn(__fmaf_rn(-q0, d.s, x), d.r, q0);
  } else {
    return __fdiv_rn(x, d.s);
  }
}

// The 8 m nibbles of a lane: sign(m) times the level of |m| / s.
template <bool FAST>
__device__ __forceinline__ uint32_t m_nibbles(const Q4Maps& maps,
                                              const Divisor& d,
                                              const float (&m)[8]) {
  uint32_t out = 0u;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const int level = code_of(maps.m_bins, quotient<FAST>(fabsf(m[k]), d));
    const int code = (m[k] < 0.0f) ? -level : level;
    out |= (static_cast<uint32_t>(code) & 0xFu) << (4 * k);
  }
  return out;
}

template <bool FAST>
__device__ __forceinline__ uint32_t v_nibbles(const Q4Maps& maps,
                                              const Divisor& d,
                                              const float (&v)[8]) {
  uint32_t out = 0u;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    out |= static_cast<uint32_t>(code_of(maps.v_bins, quotient<FAST>(v[k], d)))
           << (4 * k);
  }
  return out;
}

// One block of values for one lane: decode, Adam, update, requantize.
template <typename T>
__device__ __forceinline__ void q4_row(const T* g, const T* p, int8_t* mq,
                                       float* ms, int8_t* vq, float* vs,
                                       T* upd, long long n, long long row,
                                       const Hyper& h, const Q4Maps& sm) {
  const int lane = threadIdx.x & 31;
  const long long i = row * BLOCK + lane * PER_LANE;
  // A lane's 8 values are 4 packed bytes: one 32-bit word.
  const long long word = row * (BLOCK / 8) + lane;
  float gv[8], pv[8], m[8], v[8], u[8];
  load8(g, i, n, gv);
  load8(p, i, n, pv);
  const float m_scale_in = ms[row];
  const float v_scale_in = vs[row];
  const uint32_t m_word = reinterpret_cast<const uint32_t*>(mq)[word];
  const uint32_t v_word = reinterpret_cast<const uint32_t*>(vq)[word];
  float m_absmax = 0.0f, v_max = 0.0f;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    // Element k sits in nibble k of the little-endian word.
    m[k] = __fmul_rn(sm.m_table[(m_word >> (4 * k)) & 0xFu], m_scale_in);
    v[k] = __fmul_rn(sm.v_table[(v_word >> (4 * k)) & 0xFu], v_scale_in);
    u[k] = adam(h, gv[k], pv[k], m[k], v[k]);
    m_absmax = fmaxf(m_absmax, fabsf(m[k]));
    v_max = fmaxf(v_max, v[k]);
  }
  store8(upd, i, n, u);
  m_absmax = warp_max(m_absmax);
  v_max = warp_max(v_max);
  const Divisor dm = divisor((m_absmax == 0.0f) ? 1.0f : m_absmax);
  const Divisor dv = divisor((v_max == 0.0f) ? 1.0f : v_max);
  // Branches uniform over the warp: one scale each.
  reinterpret_cast<uint32_t*>(mq)[word] =
      dm.fast ? m_nibbles<true>(sm, dm, m) : m_nibbles<false>(sm, dm, m);
  reinterpret_cast<uint32_t*>(vq)[word] =
      dv.fast ? v_nibbles<true>(sm, dv, v) : v_nibbles<false>(sm, dv, v);
  if (lane == 0) {
    ms[row] = dm.s;
    vs[row] = dv.s;
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
q4_adam_kernel(const T* __restrict__ g, const T* __restrict__ p,
               int8_t* __restrict__ mq, float* __restrict__ ms,
               int8_t* __restrict__ vq, float* __restrict__ vs,
               T* __restrict__ upd, long long n, long long rows, Hyper h,
               const __grid_constant__ Q4Maps maps) {
  __shared__ Q4Maps smem;
  const Q4Maps& sm = maps_in_shared(maps, smem);
  const long long stride = static_cast<long long>(gridDim.x) * WARPS;
  for (long long row =
           static_cast<long long>(blockIdx.x) * WARPS + (threadIdx.x >> 5);
       row < rows; row += stride) {
    q4_row(g, p, mq, ms, vq, vs, upd, n, row, h, sm);
  }
}

// K7's grid: as many CTAs as fit on the card at once (a CTA copies the
// maps into its shared memory once), at most one for each 8 blocks.
template <typename T>
unsigned q4_grid(long long rows) {
  static int resident = 0;  // CTAs the card holds at once
  if (resident == 0) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, q4_adam_kernel<T>,
                                                  THREADS, 0);
    resident = sms * (per_sm > 0 ? per_sm : 1);
  }
  const long long blocks = blocks_for(rows);
  return static_cast<unsigned>(blocks < resident ? blocks : resident);
}

// The exhaustive check of K7's codes: for each scale s of scales, every
// float32 x in [0, s] (bit patterns 0 to bits(s)), m's level and v's code
// of x / s by K7's path (divisor, quotient, bins) against the IEEE chain
// (__fdiv_rn, __fsqrt_rn, rintf, clamped).  counts[3 j + 0] and [3 j + 1]
// gain the mismatching m levels and v codes at scale j, [3 j + 2] the
// values checked.  Grid: (any, number of scales).
__global__ void __launch_bounds__(THREADS)
q4_code_check_kernel(const __grid_constant__ Q4Maps maps,
                     const float* __restrict__ scales,
                     unsigned long long* __restrict__ counts) {
  __shared__ Q4Maps smem;
  const Q4Maps& sm = maps_in_shared(maps, smem);
  const float s = scales[blockIdx.y];
  const unsigned long long top = __float_as_uint(s);
  const Divisor d = divisor(s);
  unsigned long long m_bad = 0, v_bad = 0, seen = 0;
  for (unsigned long long bits =
           static_cast<unsigned long long>(blockIdx.x) * THREADS +
           threadIdx.x;
       bits <= top; bits += static_cast<unsigned long long>(gridDim.x) *
                            THREADS) {
    const float x = __uint_as_float(static_cast<uint32_t>(bits));
    const float q = d.fast ? quotient<true>(x, d) : quotient<false>(x, d);
    const float qi = __fdiv_rn(x, s);
    const int m_ieee = static_cast<int>(
        clampf(rintf(__fmul_rn(7.0f, __fsqrt_rn(qi))), 0.0f, 7.0f));
    const int v_ieee = static_cast<int>(clampf(
        rintf(__fmul_rn(15.0f, __fsqrt_rn(__fsqrt_rn(qi)))), 0.0f, 15.0f));
    m_bad += (code_of(sm.m_bins, q) != m_ieee) ? 1 : 0;
    v_bad += (code_of(sm.v_bins, q) != v_ieee) ? 1 : 0;
    ++seen;
  }
  for (int off = 16; off > 0; off >>= 1) {
    m_bad += __shfl_xor_sync(0xffffffffu, m_bad, off);
    v_bad += __shfl_xor_sync(0xffffffffu, v_bad, off);
    seen += __shfl_xor_sync(0xffffffffu, seen, off);
  }
  if ((threadIdx.x & 31) == 0) {
    atomicAdd(&counts[3 * blockIdx.y + 0], m_bad);
    atomicAdd(&counts[3 * blockIdx.y + 1], v_bad);
    atomicAdd(&counts[3 * blockIdx.y + 2], seen);
  }
}

inline bool bad_size(long long n, long long rows) {
  return n <= 0 || rows != (n + BLOCK - 1) / BLOCK ||
         blocks_for(rows) > 2147483647LL;
}

}  // namespace

// K5a.  x: n values, fp32 (is_bf16 0) or bf16 (1), 16-byte aligned;
// q int8 [rows, 256] and scales fp32 [rows], rows = ceil(n / 256), every
// element written.  Returns cudaGetLastError() after the launch (0 = ok).
extern "C" int quantize_blocks(const void* x, void* q, void* scales,
                               long long n, long long rows, int is_bf16,
                               void* stream) {
  if (bad_size(n, rows)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned grid = static_cast<unsigned>(blocks_for(rows));
  if (is_bf16) {
    quantize_kernel<bf16><<<grid, THREADS, 0, s>>>(
        static_cast<const bf16*>(x), static_cast<int8_t*>(q),
        static_cast<float*>(scales), n, rows);
  } else {
    quantize_kernel<float><<<grid, THREADS, 0, s>>>(
        static_cast<const float*>(x), static_cast<int8_t*>(q),
        static_cast<float*>(scales), n, rows);
  }
  return static_cast<int>(cudaGetLastError());
}

// K5b.  q int8 [rows, 256], scales fp32 [rows] -> out fp32, n values.
extern "C" int dequantize_blocks(const void* q, const void* scales, void* out,
                                 long long n, long long rows, void* stream) {
  if (bad_size(n, rows)) return static_cast<int>(cudaErrorInvalidValue);
  dequantize_kernel<<<static_cast<unsigned>(blocks_for(rows)), THREADS, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(q), static_cast<const float*>(scales),
      static_cast<float*>(out), n, rows);
  return static_cast<int>(cudaGetLastError());
}

// K6 (bits 8) and K7 (bits 4).  g, p and upd: n values of one dtype, fp32
// (is_bf16 0) or bf16 (1), 16-byte aligned; mq, vq int8 [rows, 256] (bits
// 8) or [rows, 128] (bits 4) and ms, vs fp32 [rows], updated in place.
// q4_maps: bits 4 only, the struct Q4Maps on the host.
extern "C" int low_bit_adam(const void* g, const void* p, void* mq, void* ms,
                            void* vq, void* vs, void* upd, long long n,
                            long long rows, int bits, int is_bf16, float lr,
                            float b1, float b2, float eps, float wd,
                            float bias_scale, const void* q4_maps,
                            void* stream) {
  if (bad_size(n, rows) || (bits != 8 && bits != 4) ||
      (bits == 4 && q4_maps == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned grid = static_cast<unsigned>(blocks_for(rows));
  const Hyper h = {lr, b1, b2, eps, wd, bias_scale};
  Q4Maps maps;
  if (bits == 4) std::memcpy(&maps, q4_maps, sizeof(maps));
  int8_t* mq8 = static_cast<int8_t*>(mq);
  int8_t* vq8 = static_cast<int8_t*>(vq);
  float* msf = static_cast<float*>(ms);
  float* vsf = static_cast<float*>(vs);
  if (is_bf16) {
    const bf16* gb = static_cast<const bf16*>(g);
    const bf16* pb = static_cast<const bf16*>(p);
    bf16* ub = static_cast<bf16*>(upd);
    if (bits == 8) {
      q8_adam_kernel<bf16><<<grid, THREADS, 0, s>>>(gb, pb, mq8, msf, vq8,
                                                   vsf, ub, n, rows, h);
    } else {
      q4_adam_kernel<bf16><<<q4_grid<bf16>(rows), THREADS, 0, s>>>(
          gb, pb, mq8, msf, vq8, vsf, ub, n, rows, h, maps);
    }
  } else {
    const float* gf = static_cast<const float*>(g);
    const float* pf = static_cast<const float*>(p);
    float* uf = static_cast<float*>(upd);
    if (bits == 8) {
      q8_adam_kernel<float><<<grid, THREADS, 0, s>>>(gf, pf, mq8, msf, vq8,
                                                    vsf, uf, n, rows, h);
    } else {
      q4_adam_kernel<float><<<q4_grid<float>(rows), THREADS, 0, s>>>(
          gf, pf, mq8, msf, vq8, vsf, uf, n, rows, h, maps);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

// The exhaustive check of K7's codes (q4_code_check_kernel).  q4_maps: the
// struct Q4Maps on the host; scales: n_scales fp32 on the device;
// counts: uint64 [n_scales, 3] on the device, zeroed by the caller.
extern "C" int q4_code_check(const void* q4_maps, const void* scales,
                             int n_scales, void* counts, void* stream) {
  if (q4_maps == nullptr || n_scales <= 0 || n_scales > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Q4Maps maps;
  std::memcpy(&maps, q4_maps, sizeof(maps));
  q4_code_check_kernel<<<dim3(264, static_cast<unsigned>(n_scales)), THREADS,
                         0, static_cast<cudaStream_t>(stream)>>>(
      maps, static_cast<const float*>(scales),
      static_cast<unsigned long long*>(counts));
  return static_cast<int>(cudaGetLastError());
}
