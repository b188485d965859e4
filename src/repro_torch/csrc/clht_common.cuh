// Shared per-key logic of the DPM data-plane kernels (clht_probe.cu,
// log_merge.cu, clht_insert.cu).
//
// Bucket line layout (8 int32 = one 32-byte sector, the paper's one cache
// line per probe; the TPU kernels used a 128-lane row instead):
//   line[0:3] slot keys (-1 == empty), line[3:6] slot value pointers,
//   line[6] chain link into the overflow region (-1 == none), line[7] pad.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace dinomo {

constexpr int SLOTS = 3;
constexpr int LINE = 8;
constexpr int LINK = 2 * SLOTS;
constexpr int MAX_CHAIN = 8;
constexpr int32_t EMPTY = -1;

// 32-bit finalizer of core/clht.py:_mix32, in native uint32 arithmetic.
__device__ __forceinline__ uint32_t mix32(uint32_t x) {
  x = (x ^ (x >> 16)) * 0x7FEB352Du;
  x = (x ^ (x >> 15)) * 0x846CA68Bu;
  return x ^ (x >> 16);
}

// Primary bucket of a key; num_buckets is a power of two. Negative keys
// hash as their two's-complement uint32.
__device__ __forceinline__ int64_t bucket_of(int32_t key, int64_t num_buckets) {
  return static_cast<int64_t>(mix32(static_cast<uint32_t>(key)) &
                              static_cast<uint32_t>(num_buckets - 1));
}

__device__ __forceinline__ int64_t clamp_row(int64_t r, int64_t rows) {
  return r < 0 ? 0 : (r >= rows ? rows - 1 : r);
}

// One bucket line as two 16-byte loads (the line is 32-byte aligned).
__device__ __forceinline__ void load_line(const int32_t* lines, int64_t b,
                                          int32_t (&v)[LINE]) {
  const int4* p = reinterpret_cast<const int4*>(lines + b * LINE);
  const int4 a = p[0];
  const int4 c = p[1];
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = c.x; v[5] = c.y; v[6] = c.z; v[7] = c.w;
}

__device__ __forceinline__ void store_line(int32_t* lines, int64_t b,
                                           const int32_t (&v)[LINE]) {
  int4* p = reinterpret_cast<int4*>(lines + b * LINE);
  p[0] = make_int4(v[0], v[1], v[2], v[3]);
  p[1] = make_int4(v[4], v[5], v[6], v[7]);
}

// Slot holding `key` in this line, -1 if none. Negative keys (padding)
// never match, as in the Pallas probe (clht_probe.py:55).
__device__ __forceinline__ int probe_line(const int32_t (&v)[LINE],
                                          int32_t key) {
  int hit = -1;
#pragma unroll
  for (int s = SLOTS - 1; s >= 0; --s)
    if (v[s] == key) hit = s;
  return key >= 0 ? hit : -1;
}

// Pointer in slot s of the line (s in [0, SLOTS)), with constant indices
// only so the line stays in registers.
__device__ __forceinline__ int32_t slot_ptr(const int32_t (&v)[LINE], int s) {
  int32_t p = EMPTY;
#pragma unroll
  for (int t = 0; t < SLOTS; ++t)
    if (t == s) p = v[SLOTS + t];
  return p;
}

__device__ __forceinline__ void set_slot(int32_t (&v)[LINE], int s,
                                         int32_t key, int32_t ptr) {
#pragma unroll
  for (int t = 0; t < SLOTS; ++t)
    if (t == s) {
      v[t] = key;
      v[SLOTS + t] = ptr;
    }
}

// One sequential insert/update, core/clht.py:_locate + _insert_one:
// walk up to MAX_CHAIN lines of the key's chain; update in place if the
// key is present, else fill the first empty slot, else link a fresh
// overflow bucket at the tail (if any are left). `head` is the overflow
// allocation cursor; `fresh` is set for a successful new insert.
__device__ __forceinline__ void insert_one(int32_t* lines, int64_t total,
                                           int64_t num_buckets,
                                           int32_t& head, int32_t key,
                                           int32_t ptr, int32_t& old,
                                           bool& ok, bool& fresh) {
  int64_t cur = bucket_of(key, num_buckets);
  int64_t mb = -1, eb = -1, tail = cur;
  int ms = -1, es = -1;
  for (int step = 0; step < MAX_CHAIN; ++step) {
    int32_t v[LINE];
    load_line(lines, cur, v);
#pragma unroll
    for (int s = SLOTS - 1; s >= 0; --s) {
      if (mb < 0 && v[s] == key) ms = s;
      if (eb < 0 && v[s] == EMPTY) es = s;
    }
    if (mb < 0 && ms >= 0) mb = cur;
    if (eb < 0 && es >= 0) eb = cur;
    tail = cur;
    if (v[LINK] == EMPTY) break;
    cur = v[LINK];
  }
  const bool is_update = mb >= 0;
  const bool has_empty = eb >= 0;
  const bool can_overflow = head < total;
  const int64_t tb = is_update ? mb : (has_empty ? eb : head);
  const int ts = is_update ? ms : (has_empty ? es : 0);
  ok = is_update || has_empty || can_overflow;
  fresh = ok && !is_update;
  old = is_update ? lines[tb * LINE + SLOTS + ts] : EMPTY;
  if (ok) {
    lines[tb * LINE + ts] = key;
    lines[tb * LINE + SLOTS + ts] = ptr;
  }
  if (!is_update && !has_empty && can_overflow) {
    lines[tail * LINE + LINK] = head;
    head += 1;
  }
}

}  // namespace dinomo
