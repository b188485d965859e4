// Kernel D: the sequential CLHT insert.
//
// Not a Pallas kernel. It replaces the lax.scan of lax.conds in
// src/repro/core/clht.py:clht_insert, which the JAX plane runs on the
// device for the slow path of
// src/repro/kernels/log_merge/ops.py:merge_segment_fast (entries whose
// primary bucket was full). Every insert depends on the ones before it
// (chain growth takes overflow buckets in log order), so one thread walks
// the masked entries in order through dinomo::insert_one, with the
// overflow cursor in a register.
//
// Bound on an H100 SXM: latency, not bytes or operations. Per entry it
// reads 8 B (key, ptr), plus 1 B of mask when one is given, writes 8 B
// (old, ok) and one line, and walks one dependent 32-byte line per chain
// step; the roofline bound counts those bytes over 3.35 TB/s, but one
// thread waits out each line's device-memory latency in turn.
#include "clht_common.cuh"

namespace {

__global__ void clht_insert_kernel(int32_t* __restrict__ lines, int64_t total,
                                   int64_t num_buckets,
                                   int32_t* __restrict__ overflow_head,
                                   const int32_t* __restrict__ keys,
                                   const int32_t* __restrict__ ptrs,
                                   const bool* __restrict__ mask, int64_t n,
                                   int32_t* __restrict__ old,
                                   int32_t* __restrict__ ok,
                                   int32_t* __restrict__ num_new) {
  int32_t head = *overflow_head;
  int32_t fresh_count = 0;
  for (int64_t i = 0; i < n; ++i) {
    if (mask != nullptr && !mask[i]) {
      old[i] = dinomo::EMPTY;
      ok[i] = 0;
      continue;
    }
    int32_t o;
    bool okb, fresh;
    dinomo::insert_one(lines, total, num_buckets, head, keys[i], ptrs[i], o,
                       okb, fresh);
    old[i] = o;
    ok[i] = okb;
    fresh_count += fresh;
  }
  *overflow_head = head;
  *num_new = fresh_count;
}

}  // namespace

extern "C" int clht_insert_launch(int32_t* lines, int64_t total,
                                  int64_t num_buckets, int32_t* overflow_head,
                                  const int32_t* keys, const int32_t* ptrs,
                                  const bool* mask, int64_t n, int32_t* old,
                                  int32_t* ok, int32_t* num_new,
                                  cudaStream_t stream) {
  clht_insert_kernel<<<1, 1, 0, stream>>>(lines, total, num_buckets,
                                          overflow_head, keys, ptrs, mask, n,
                                          old, ok, num_new);
  return static_cast<int>(cudaGetLastError());
}
