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
// What bounds it on this card: bytes.  Per parameter K6 reads g and p,
// two codes and writes the update and two codes (10 bytes with bf16 g
// and p, plus 16 bytes of scales per 256), against some 40 flops.  What
// the design does about it: one pass, nothing but the operands crosses
// device memory.  g and p are read in their own dtype and converted in
// registers, the update is written in p's dtype, and the state is
// updated in place.  One warp owns one block: a lane holds 8 consecutive
// values (16-byte loads for bf16, 8 for int8 codes, 4 for nibbles), the
// block's absmax is a warp shuffle, and no shared memory is used.
//
// Arithmetic.  Every float operation is a single IEEE round-to-nearest
// operation (__fmul_rn, __fadd_rn, __fdiv_rn, __fsqrt_rn: no fused
// multiply-add, no reciprocal), in the order the TPU kernel states
// them, and codes round half to even (rintf), as jnp.round does.  A
// quotient one ulp off would move a value across a .5 boundary and the
// code by one level.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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

__device__ __forceinline__ float signf(float x) {
  return (x > 0.0f) ? 1.0f : ((x < 0.0f) ? -1.0f : 0.0f);
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

// -- K7 ------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(THREADS)
q4_adam_kernel(const T* __restrict__ g, const T* __restrict__ p,
               int8_t* __restrict__ mq, float* __restrict__ ms,
               int8_t* __restrict__ vq, float* __restrict__ vs,
               T* __restrict__ upd, long long n, long long rows, Hyper h) {
  const long long row =
      static_cast<long long>(blockIdx.x) * WARPS + (threadIdx.x >> 5);
  if (row >= rows) return;
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
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    // Element k sits in nibble k of the little-endian word; the shifts
    // sign-extend m's nibble and leave v's unsigned.
    const int m_code = static_cast<int>(m_word << (28 - 4 * k)) >> 28;
    const int v_code = static_cast<int>((v_word >> (4 * k)) & 0xFu);
    const float mn = __fmul_rn(static_cast<float>(m_code), 1.0f / 7.0f);
    m[k] = __fmul_rn(__fmul_rn(signf(mn), __fmul_rn(mn, mn)), m_scale_in);
    const float vn = __fmul_rn(static_cast<float>(v_code), 1.0f / 15.0f);
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
  const float m_scale = (m_absmax == 0.0f) ? 1.0f : m_absmax;
  const float v_scale = (v_max == 0.0f) ? 1.0f : v_max;
  uint32_t m_out = 0u, v_out = 0u;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const float mn = __fsqrt_rn(__fdiv_rn(fabsf(m[k]), m_scale));
    const float level = clampf(rintf(__fmul_rn(7.0f, mn)), 0.0f, 7.0f);
    const int m_code = static_cast<int>(__fmul_rn(signf(m[k]), level));
    const float vn = __fsqrt_rn(__fsqrt_rn(__fdiv_rn(v[k], v_scale)));
    const int v_code =
        static_cast<int>(clampf(rintf(__fmul_rn(15.0f, vn)), 0.0f, 15.0f));
    m_out |= (static_cast<uint32_t>(m_code) & 0xFu) << (4 * k);
    v_out |= (static_cast<uint32_t>(v_code) & 0xFu) << (4 * k);
  }
  reinterpret_cast<uint32_t*>(mq)[word] = m_out;
  reinterpret_cast<uint32_t*>(vq)[word] = v_out;
  if (lane == 0) {
    ms[row] = m_scale;
    vs[row] = v_scale;
  }
}

inline long long blocks_for(long long rows) {
  return (rows + WARPS - 1) / WARPS;
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
extern "C" int low_bit_adam(const void* g, const void* p, void* mq, void* ms,
                            void* vq, void* vs, void* upd, long long n,
                            long long rows, int bits, int is_bf16, float lr,
                            float b1, float b2, float eps, float wd,
                            float bias_scale, void* stream) {
  if (bad_size(n, rows) || (bits != 8 && bits != 4)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned grid = static_cast<unsigned>(blocks_for(rows));
  const Hyper h = {lr, b1, b2, eps, wd, bias_scale};
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
      q4_adam_kernel<bf16><<<grid, THREADS, 0, s>>>(gb, pb, mq8, msf, vq8,
                                                   vsf, ub, n, rows, h);
    }
  } else {
    const float* gf = static_cast<const float*>(g);
    const float* pf = static_cast<const float*>(p);
    float* uf = static_cast<float*>(upd);
    if (bits == 8) {
      q8_adam_kernel<float><<<grid, THREADS, 0, s>>>(gf, pf, mq8, msf, vq8,
                                                    vsf, uf, n, rows, h);
    } else {
      q4_adam_kernel<float><<<grid, THREADS, 0, s>>>(gf, pf, mq8, msf, vq8,
                                                    vsf, uf, n, rows, h);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
