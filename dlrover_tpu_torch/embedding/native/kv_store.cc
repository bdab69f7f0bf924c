// Host-side dynamic-capacity sparse embedding store (C core).
//
// Capability ref: TFPlus KvVariable
// (tfplus/tfplus/kv_variable/kernels/kv_variable.h:1-1021 —
// dynamic capacity hash -> embedding row with per-key counts/timestamps and
// full/delta export; hashmap.h cuckoo table; kernels/training_ops.cc +
// ops/training_ops.cc group sparse optimizer updates applied directly to
// rows: Adam, Adagrad, Ftrl, Lamb and friends).
//
// TPU redesign: the table lives in host RAM (TPU HBM holds only the rows a
// step touches — lookups gather host->device, updates scatter back), so the
// native piece is a plain open-addressing robin-hood-style hash keyed by
// int64 with an inline payload:
//   [ value(dim) | s0(dim) | s1(dim) ] float32  +  count u32  +  last_step u32
// The two optimizer state rows sit next to the value row — exactly the
// "group sparse apply" layout the reference's C++ optimizers use (one cache
// walk per update, no second table).  Per optimizer the slots mean:
//   adam/lamb: s0 = first moment m, s1 = second moment v
//   adagrad:   s0 = accumulator,    s1 unused
//   ftrl:      s0 = accumulator,    s1 = linear term
//
// The key whose uint64 pattern equals the empty-slot sentinel (INT64_MIN)
// cannot live in the open-addressing array; it gets a dedicated side slot
// so every int64 key is storable (round-3 advisor finding).
//
// Exposed as a C ABI for ctypes (no pybind11 in this image).

#include <cmath>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <utility>

namespace {

constexpr uint64_t kEmpty = 0x8000000000000000ULL;  // sentinel slot marker

inline uint64_t mix64(uint64_t x) {
  // splitmix64 finalizer: avalanche for bucket choice + deterministic init.
  x += 0x9E3779B97F4A7C15ULL;
  x = (x ^ (x >> 30)) * 0xBF58476D1CE4E5B9ULL;
  x = (x ^ (x >> 27)) * 0x94D049BB133111EBULL;
  return x ^ (x >> 31);
}

inline void init_row(float* row, int64_t dim, uint64_t key, uint64_t seed,
                     float init_scale) {
  // Deterministic per-key init: uniform(-s, s) from a splitmix stream.
  uint64_t state = mix64(key ^ seed);
  for (int64_t d = 0; d < dim; ++d) {
    state = mix64(state);
    float u = static_cast<float>(state >> 40) /
              static_cast<float>(1ULL << 24);  // [0, 1)
    row[d] = (2.0f * u - 1.0f) * init_scale;
  }
}

struct Store {
  int64_t dim = 0;
  int64_t capacity = 0;   // power of two
  int64_t size = 0;       // entries in the hash array (excl. the side slot)
  uint64_t* keys = nullptr;      // [capacity]
  float* payload = nullptr;      // [capacity, 3*dim]
  uint32_t* counts = nullptr;    // [capacity]
  uint32_t* steps = nullptr;     // [capacity]
  // Side slot for the single key colliding with kEmpty (INT64_MIN).
  bool has_min = false;
  float* min_payload = nullptr;  // [3*dim]
  uint32_t min_count = 0;
  uint32_t min_step = 0;

  int64_t payload_width() const { return 3 * dim; }

  void alloc(int64_t cap) {
    capacity = cap;
    keys = static_cast<uint64_t*>(malloc(cap * sizeof(uint64_t)));
    payload = static_cast<float*>(calloc(cap * payload_width(), sizeof(float)));
    counts = static_cast<uint32_t*>(calloc(cap, sizeof(uint32_t)));
    steps = static_cast<uint32_t*>(calloc(cap, sizeof(uint32_t)));
    min_payload = static_cast<float*>(calloc(payload_width(), sizeof(float)));
    for (int64_t i = 0; i < cap; ++i) keys[i] = kEmpty;
  }

  void release() {
    free(keys); free(payload); free(counts); free(steps); free(min_payload);
    keys = nullptr; payload = nullptr; counts = nullptr; steps = nullptr;
    min_payload = nullptr;
  }

  int64_t find_slot(uint64_t key) const {
    uint64_t mask = static_cast<uint64_t>(capacity) - 1;
    uint64_t idx = mix64(key) & mask;
    while (true) {
      if (keys[idx] == key) return static_cast<int64_t>(idx);
      if (keys[idx] == kEmpty) return -static_cast<int64_t>(idx) - 1;
      idx = (idx + 1) & mask;
    }
  }

  void grow() {
    Store bigger;
    bigger.dim = dim;
    bigger.alloc(capacity * 2);
    for (int64_t i = 0; i < capacity; ++i) {
      if (keys[i] == kEmpty) continue;
      int64_t slot = bigger.find_slot(keys[i]);
      slot = -slot - 1;  // must be a miss in the fresh table
      bigger.keys[slot] = keys[i];
      memcpy(bigger.payload + slot * payload_width(),
             payload + i * payload_width(),
             payload_width() * sizeof(float));
      bigger.counts[slot] = counts[i];
      bigger.steps[slot] = steps[i];
    }
    bigger.size = size;
    // Preserve the side slot across the rebuild.
    std::swap(bigger.min_payload, min_payload);
    bigger.has_min = has_min;
    bigger.min_count = min_count;
    bigger.min_step = min_step;
    release();
    *this = bigger;
  }

  // Row pointer for an existing key; nullptr when absent.
  float* row_for(uint64_t key) {
    if (key == kEmpty) return has_min ? min_payload : nullptr;
    int64_t slot = find_slot(key);
    return slot >= 0 ? payload + slot * payload_width() : nullptr;
  }

  // Row pointer, inserting (with deterministic init) when absent; bumps
  // count/step metadata for the key.
  float* row_touch(uint64_t key, float init_scale, uint64_t seed,
                   uint32_t step) {
    if (key == kEmpty) {
      if (!has_min) {
        init_row(min_payload, dim, key, seed, init_scale);
        has_min = true;
      }
      min_count += 1;
      min_step = step;
      return min_payload;
    }
    int64_t slot = upsert(key, init_scale, seed);
    counts[slot] += 1;
    steps[slot] = step;
    return payload + slot * payload_width();
  }

  int64_t upsert(uint64_t key, float init_scale, uint64_t seed) {
    int64_t slot = find_slot(key);
    if (slot >= 0) return slot;
    if ((size + 1) * 10 >= capacity * 7) {  // load factor 0.7
      grow();
      slot = find_slot(key);
    }
    slot = -slot - 1;
    keys[slot] = key;
    init_row(payload + slot * payload_width(), dim, key, seed, init_scale);
    // optimizer-state rows (s0, s1) start at zero via calloc/grow-copy
    size += 1;
    return slot;
  }
};

// -- per-row optimizer math (shared by array slots and the side slot) -------

inline void adam_row(float* w, float* m, float* v, const float* g,
                     int64_t dim, float lr, float b1, float b2, float eps,
                     float wd, float scale) {
  for (int64_t d = 0; d < dim; ++d) {
    float gd = g[d] + wd * w[d];
    m[d] = b1 * m[d] + (1.0f - b1) * gd;
    v[d] = b2 * v[d] + (1.0f - b2) * gd * gd;
    w[d] -= lr * scale * m[d] / (sqrtf(v[d]) + eps);
  }
}

inline void adagrad_row(float* w, float* acc, const float* g, int64_t dim,
                        float lr, float eps) {
  for (int64_t d = 0; d < dim; ++d) {
    acc[d] += g[d] * g[d];
    w[d] -= lr * g[d] / (sqrtf(acc[d]) + eps);
  }
}

// FTRL-proximal, TF FtrlV2 semantics with learning_rate_power = -0.5
// (ref tfplus ops/training_ops.cc KvVariableGroupSparseApplyFtrl):
//   acc' = acc + g^2
//   sigma = (sqrt(acc') - sqrt(acc)) / lr
//   linear += g - sigma * w
//   w = (sign(linear)*l1 - linear) / ((beta + sqrt(acc'))/lr + 2*l2)
//       if |linear| > l1 else 0
inline void ftrl_row(float* w, float* acc, float* linear, const float* g,
                     int64_t dim, float lr, float l1, float l2, float beta) {
  for (int64_t d = 0; d < dim; ++d) {
    float acc_new = acc[d] + g[d] * g[d];
    float sigma = (sqrtf(acc_new) - sqrtf(acc[d])) / lr;
    linear[d] += g[d] - sigma * w[d];
    acc[d] = acc_new;
    float l = linear[d];
    if (fabsf(l) > l1) {
      float quad = (beta + sqrtf(acc_new)) / lr + 2.0f * l2;
      w[d] = ((l < 0.0f ? -l1 : l1) - l) / quad;
    } else {
      w[d] = 0.0f;
    }
  }
}

// LAMB with a per-row trust ratio (the embedding row is the natural "layer"
// group for a sparse table; ref atorch low-bit LAMB and tfplus group apply).
inline void lamb_row(float* w, float* m, float* v, const float* g,
                     int64_t dim, float lr, float b1, float b2, float eps,
                     float wd, float bias1, float bias2) {
  float w_norm = 0.0f, u_norm = 0.0f;
  // First pass: update moments, accumulate norms of w and the update u.
  for (int64_t d = 0; d < dim; ++d) {
    m[d] = b1 * m[d] + (1.0f - b1) * g[d];
    v[d] = b2 * v[d] + (1.0f - b2) * g[d] * g[d];
    float u = (m[d] / bias1) / (sqrtf(v[d] / bias2) + eps) + wd * w[d];
    w_norm += w[d] * w[d];
    u_norm += u * u;
  }
  float ratio = 1.0f;
  if (w_norm > 0.0f && u_norm > 0.0f) {
    ratio = sqrtf(w_norm) / sqrtf(u_norm);
  }
  for (int64_t d = 0; d < dim; ++d) {
    float u = (m[d] / bias1) / (sqrtf(v[d] / bias2) + eps) + wd * w[d];
    w[d] -= lr * ratio * u;
  }
}

// Rectified Adam (ref tfplus training_ops.cc RectifiedAdam group apply):
// warms up through the un-adapted SGD-with-momentum regime until the
// variance estimate's rectification term r_t is defined (rho_t > 4).
inline void radam_row(float* w, float* m, float* v, const float* g,
                      int64_t dim, float lr, float b1, float b2, float eps,
                      float wd, float bias1, float bias2, float rho_inf,
                      float rho_t) {
  float rect = -1.0f;
  if (rho_t > 4.0f) {
    rect = sqrtf(((rho_t - 4.0f) * (rho_t - 2.0f) * rho_inf) /
                 ((rho_inf - 4.0f) * (rho_inf - 2.0f) * rho_t));
  }
  for (int64_t d = 0; d < dim; ++d) {
    m[d] = b1 * m[d] + (1.0f - b1) * g[d];
    v[d] = b2 * v[d] + (1.0f - b2) * g[d] * g[d];
    float m_hat = m[d] / bias1;
    float update;
    if (rect > 0.0f) {
      float v_hat = sqrtf(v[d] / bias2);
      update = rect * m_hat / (v_hat + eps);
    } else {
      update = m_hat;
    }
    w[d] -= lr * (update + wd * w[d]);
  }
}

// AdaHessian (ref tfplus AdaDQH/AdaHessian group semantics): the second
// moment tracks the squared HESSIAN diagonal estimate (Hutchinson trace
// probe, computed by the caller), not the squared gradient — curvature-
// scaled steps where Adam's are gradient-magnitude-scaled.
inline void adahessian_row(float* w, float* m, float* v, const float* g,
                           const float* h, int64_t dim, float lr, float b1,
                           float b2, float eps, float wd, float bias1,
                           float bias2) {
  for (int64_t d = 0; d < dim; ++d) {
    m[d] = b1 * m[d] + (1.0f - b1) * g[d];
    v[d] = b2 * v[d] + (1.0f - b2) * h[d] * h[d];
    float update = (m[d] / bias1) / (sqrtf(v[d] / bias2) + eps);
    w[d] -= lr * (update + wd * w[d]);
  }
}

}  // namespace

extern "C" {

void* kv_create(int64_t dim, int64_t initial_capacity) {
  Store* s = new Store();
  s->dim = dim;
  int64_t cap = 64;
  while (cap < initial_capacity) cap <<= 1;
  s->alloc(cap);
  return s;
}

void kv_free(void* handle) {
  Store* s = static_cast<Store*>(handle);
  s->release();
  delete s;
}

int64_t kv_size(void* handle) {
  Store* s = static_cast<Store*>(handle);
  return s->size + (s->has_min ? 1 : 0);
}

int64_t kv_capacity(void* handle) {
  return static_cast<Store*>(handle)->capacity;
}

int64_t kv_dim(void* handle) { return static_cast<Store*>(handle)->dim; }

// Gather rows for `keys`, inserting missing keys with deterministic init.
// Bumps per-key counts and last_step.  out: [n, dim].
void kv_lookup(void* handle, const int64_t* lookup_keys, int64_t n,
               float* out, float init_scale, uint64_t seed, uint32_t step) {
  Store* s = static_cast<Store*>(handle);
  for (int64_t i = 0; i < n; ++i) {
    float* row = s->row_touch(static_cast<uint64_t>(lookup_keys[i]),
                              init_scale, seed, step);
    memcpy(out + i * s->dim, row, s->dim * sizeof(float));
  }
}

// Read-only gather: missing keys yield zero rows and are NOT inserted
// (inference / eval path).
void kv_peek(void* handle, const int64_t* peek_keys, int64_t n, float* out) {
  Store* s = static_cast<Store*>(handle);
  for (int64_t i = 0; i < n; ++i) {
    const float* row = s->row_for(static_cast<uint64_t>(peek_keys[i]));
    if (row) {
      memcpy(out + i * s->dim, row, s->dim * sizeof(float));
    } else {
      memset(out + i * s->dim, 0, s->dim * sizeof(float));
    }
  }
}

// Overwrite value rows (import/restore path); inserts missing keys.
void kv_insert(void* handle, const int64_t* ins_keys, int64_t n,
               const float* rows, const float* moments_m,
               const float* moments_v, const uint32_t* ins_counts,
               const uint32_t* ins_steps) {
  Store* s = static_cast<Store*>(handle);
  for (int64_t i = 0; i < n; ++i) {
    uint64_t key = static_cast<uint64_t>(ins_keys[i]);
    float* row;
    if (key == kEmpty) {
      s->has_min = true;
      row = s->min_payload;
      if (ins_counts) s->min_count = ins_counts[i];
      if (ins_steps) s->min_step = ins_steps[i];
    } else {
      int64_t slot = s->upsert(key, 0.0f, 0);
      row = s->payload + slot * s->payload_width();
      if (ins_counts) s->counts[slot] = ins_counts[i];
      if (ins_steps) s->steps[slot] = ins_steps[i];
    }
    memcpy(row, rows + i * s->dim, s->dim * sizeof(float));
    if (moments_m)
      memcpy(row + s->dim, moments_m + i * s->dim, s->dim * sizeof(float));
    if (moments_v)
      memcpy(row + 2 * s->dim, moments_v + i * s->dim,
             s->dim * sizeof(float));
  }
}

// Group-sparse Adam applied directly to the rows (ref training_ops.cc
// KvVariableGroupSparseApplyAdamV2): one walk updates value + moments.
// Repeated keys in one batch are applied sequentially (gradient order).
void kv_apply_group_adam(void* handle, const int64_t* upd_keys, int64_t n,
                         const float* grads, float lr, float b1, float b2,
                         float eps, float weight_decay, int64_t t) {
  Store* s = static_cast<Store*>(handle);
  float bias1 = 1.0f - powf(b1, static_cast<float>(t));
  float bias2 = 1.0f - powf(b2, static_cast<float>(t));
  float scale = sqrtf(bias2) / bias1;
  for (int64_t i = 0; i < n; ++i) {
    float* row = s->row_for(static_cast<uint64_t>(upd_keys[i]));
    if (!row) continue;  // never looked up: no grad should exist
    adam_row(row, row + s->dim, row + 2 * s->dim, grads + i * s->dim,
             s->dim, lr, b1, b2, eps, weight_decay, scale);
  }
}

// Group-sparse Adagrad (ref KvVariableGroupSparseApplyAdagrad): s0 holds
// the accumulator.
void kv_apply_group_adagrad(void* handle, const int64_t* upd_keys, int64_t n,
                            const float* grads, float lr, float eps) {
  Store* s = static_cast<Store*>(handle);
  for (int64_t i = 0; i < n; ++i) {
    float* row = s->row_for(static_cast<uint64_t>(upd_keys[i]));
    if (!row) continue;
    adagrad_row(row, row + s->dim, grads + i * s->dim, s->dim, lr, eps);
  }
}

// Group-sparse FTRL (ref KvVariableGroupSparseApplyFtrl): s0 = accumulator,
// s1 = linear term.
void kv_apply_group_ftrl(void* handle, const int64_t* upd_keys, int64_t n,
                         const float* grads, float lr, float l1, float l2,
                         float beta) {
  Store* s = static_cast<Store*>(handle);
  for (int64_t i = 0; i < n; ++i) {
    float* row = s->row_for(static_cast<uint64_t>(upd_keys[i]));
    if (!row) continue;
    ftrl_row(row, row + s->dim, row + 2 * s->dim, grads + i * s->dim,
             s->dim, lr, l1, l2, beta);
  }
}

// Group-sparse LAMB (ref tfplus group apply family + atorch LAMB): per-row
// trust ratio; s0 = m, s1 = v.
void kv_apply_group_lamb(void* handle, const int64_t* upd_keys, int64_t n,
                         const float* grads, float lr, float b1, float b2,
                         float eps, float weight_decay, int64_t t) {
  Store* s = static_cast<Store*>(handle);
  float bias1 = 1.0f - powf(b1, static_cast<float>(t));
  float bias2 = 1.0f - powf(b2, static_cast<float>(t));
  for (int64_t i = 0; i < n; ++i) {
    float* row = s->row_for(static_cast<uint64_t>(upd_keys[i]));
    if (!row) continue;
    lamb_row(row, row + s->dim, row + 2 * s->dim, grads + i * s->dim,
             s->dim, lr, b1, b2, eps, weight_decay, bias1, bias2);
  }
}

// Group-sparse Rectified Adam (ref RectifiedAdam group apply): s0 = m,
// s1 = v; the rectification schedule is a function of t alone.
void kv_apply_group_radam(void* handle, const int64_t* upd_keys, int64_t n,
                          const float* grads, float lr, float b1, float b2,
                          float eps, float weight_decay, int64_t t) {
  Store* s = static_cast<Store*>(handle);
  float bias1 = 1.0f - powf(b1, static_cast<float>(t));
  float bias2 = 1.0f - powf(b2, static_cast<float>(t));
  float rho_inf = 2.0f / (1.0f - b2) - 1.0f;
  float b2t = powf(b2, static_cast<float>(t));
  float rho_t =
      rho_inf - 2.0f * static_cast<float>(t) * b2t / (1.0f - b2t);
  for (int64_t i = 0; i < n; ++i) {
    float* row = s->row_for(static_cast<uint64_t>(upd_keys[i]));
    if (!row) continue;
    radam_row(row, row + s->dim, row + 2 * s->dim, grads + i * s->dim,
              s->dim, lr, b1, b2, eps, weight_decay, bias1, bias2, rho_inf,
              rho_t);
  }
}

// Group-sparse AdaHessian: grads + caller-computed Hessian-diagonal rows
// (same [n, dim] layout); s0 = m, s1 = v over h^2.
void kv_apply_group_adahessian(void* handle, const int64_t* upd_keys,
                               int64_t n, const float* grads,
                               const float* hessian, float lr, float b1,
                               float b2, float eps, float weight_decay,
                               int64_t t) {
  Store* s = static_cast<Store*>(handle);
  float bias1 = 1.0f - powf(b1, static_cast<float>(t));
  float bias2 = 1.0f - powf(b2, static_cast<float>(t));
  for (int64_t i = 0; i < n; ++i) {
    float* row = s->row_for(static_cast<uint64_t>(upd_keys[i]));
    if (!row) continue;
    adahessian_row(row, row + s->dim, row + 2 * s->dim, grads + i * s->dim,
                   hessian + i * s->dim, s->dim, lr, b1, b2, eps,
                   weight_decay, bias1, bias2);
  }
}

// Export up to `cap` entries (all when min_step == 0, else only entries
// touched at or after min_step — the delta-export path).  Returns the
// number written.  Arrays may be null to export keys only.
int64_t kv_export(void* handle, uint32_t min_step, int64_t* out_keys,
                  float* out_rows, float* out_m, float* out_v,
                  uint32_t* out_counts, uint32_t* out_steps, int64_t cap) {
  Store* s = static_cast<Store*>(handle);
  int64_t written = 0;
  if (s->has_min && (!min_step || s->min_step >= min_step) && written < cap) {
    if (out_keys) out_keys[written] = static_cast<int64_t>(kEmpty);
    if (out_rows)
      memcpy(out_rows + written * s->dim, s->min_payload,
             s->dim * sizeof(float));
    if (out_m)
      memcpy(out_m + written * s->dim, s->min_payload + s->dim,
             s->dim * sizeof(float));
    if (out_v)
      memcpy(out_v + written * s->dim, s->min_payload + 2 * s->dim,
             s->dim * sizeof(float));
    if (out_counts) out_counts[written] = s->min_count;
    if (out_steps) out_steps[written] = s->min_step;
    written += 1;
  }
  for (int64_t i = 0; i < s->capacity && written < cap; ++i) {
    if (s->keys[i] == kEmpty) continue;
    if (min_step && s->steps[i] < min_step) continue;
    if (out_keys) out_keys[written] = static_cast<int64_t>(s->keys[i]);
    const float* row = s->payload + i * s->payload_width();
    if (out_rows)
      memcpy(out_rows + written * s->dim, row, s->dim * sizeof(float));
    if (out_m)
      memcpy(out_m + written * s->dim, row + s->dim, s->dim * sizeof(float));
    if (out_v)
      memcpy(out_v + written * s->dim, row + 2 * s->dim,
             s->dim * sizeof(float));
    if (out_counts) out_counts[written] = s->counts[i];
    if (out_steps) out_steps[written] = s->steps[i];
    written += 1;
  }
  return written;
}

int64_t kv_count_since(void* handle, uint32_t min_step) {
  Store* s = static_cast<Store*>(handle);
  int64_t n = 0;
  if (s->has_min && (!min_step || s->min_step >= min_step)) n += 1;
  for (int64_t i = 0; i < s->capacity; ++i) {
    if (s->keys[i] == kEmpty) continue;
    if (min_step && s->steps[i] < min_step) continue;
    n += 1;
  }
  return n;
}

// Targeted removal (the reshard row-move path: rows that changed owner are
// deleted at the source after the destination acknowledges the insert).
// Open addressing with linear probing cannot tombstone without poisoning
// every future probe chain, so holes are healed by backward-shift deletion:
// entries after the hole whose home slot does not lie cyclically within
// (hole, entry] slide back into it.  Returns the number actually removed.
int64_t kv_remove(void* handle, const int64_t* rm_keys, int64_t n) {
  Store* s = static_cast<Store*>(handle);
  int64_t removed = 0;
  for (int64_t r = 0; r < n; ++r) {
    uint64_t key = static_cast<uint64_t>(rm_keys[r]);
    if (key == kEmpty) {
      if (s->has_min) {
        s->has_min = false;
        s->min_count = 0;
        s->min_step = 0;
        memset(s->min_payload, 0, s->payload_width() * sizeof(float));
        removed += 1;
      }
      continue;
    }
    int64_t slot = s->find_slot(key);
    if (slot < 0) continue;
    uint64_t mask = static_cast<uint64_t>(s->capacity) - 1;
    uint64_t hole = static_cast<uint64_t>(slot);
    s->keys[hole] = kEmpty;
    uint64_t j = hole;
    while (true) {
      j = (j + 1) & mask;
      if (s->keys[j] == kEmpty) break;
      uint64_t home = mix64(s->keys[j]) & mask;
      // Reachable from its home without passing the hole? Then leave it.
      bool in_range = (hole < j) ? (home > hole && home <= j)
                                 : (home > hole || home <= j);
      if (in_range) continue;
      s->keys[hole] = s->keys[j];
      memcpy(s->payload + hole * s->payload_width(),
             s->payload + j * s->payload_width(),
             s->payload_width() * sizeof(float));
      s->counts[hole] = s->counts[j];
      s->steps[hole] = s->steps[j];
      s->keys[j] = kEmpty;
      hole = j;
    }
    s->size -= 1;
    removed += 1;
  }
  return removed;
}

// Evict entries not touched since `min_step` with fewer than `min_count`
// hits (feature-freshness eviction, ref kv_variable.h delete/filter ops).
// Rebuilds the table; returns evicted count.
int64_t kv_evict(void* handle, uint32_t min_step, uint32_t min_count) {
  Store* s = static_cast<Store*>(handle);
  Store fresh;
  fresh.dim = s->dim;
  fresh.alloc(s->capacity);
  int64_t evicted = 0;
  if (s->has_min) {
    if (s->min_step < min_step && s->min_count < min_count) {
      evicted += 1;
    } else {
      fresh.has_min = true;
      fresh.min_count = s->min_count;
      fresh.min_step = s->min_step;
      memcpy(fresh.min_payload, s->min_payload,
             s->payload_width() * sizeof(float));
    }
  }
  for (int64_t i = 0; i < s->capacity; ++i) {
    if (s->keys[i] == kEmpty) continue;
    if (s->steps[i] < min_step && s->counts[i] < min_count) {
      evicted += 1;
      continue;
    }
    int64_t slot = fresh.find_slot(s->keys[i]);
    slot = -slot - 1;
    fresh.keys[slot] = s->keys[i];
    memcpy(fresh.payload + slot * fresh.payload_width(),
           s->payload + i * s->payload_width(),
           s->payload_width() * sizeof(float));
    fresh.counts[slot] = s->counts[i];
    fresh.steps[slot] = s->steps[i];
    fresh.size += 1;
  }
  s->release();
  *s = fresh;
  return evicted;
}

}  // extern "C"
