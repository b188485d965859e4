// Kernel C of the DPM write path: log_merge_sorted.
//
// Replaces the Pallas kernel
// src/repro/kernels/log_merge/log_merge.py:log_merge_sorted (_merge_kernel).
// The entries arrive stable-sorted by bucket (log order kept within a
// bucket) with the start of every bucket group found by the wrapper. One
// thread per group loads the group's line into registers, applies the
// group's entries in log order (a match overwrites the pointer, else the
// first empty slot is claimed, else ok=0 for the sequential slow path;
// negative keys are padding and change nothing), writes each entry's
// superseded pointer and ok flag, and writes the final line once. The
// Pallas kernel's per-entry (E, 128) row output only served its block
// coherence and has no counterpart here.
//
// Bound on an H100 SXM: bytes. Per entry 8 B (key, ptr) read and 8 B
// (old, ok) written; per group 4 B of start and 4 B of bucket id read, and
// its 32-byte line read and written once; over 3.35 TB/s. A group is
// sequential by nature; a hot key's long group runs on one thread while
// the rest of the card idles, which the time on skewed batches shows.
#include "clht_common.cuh"

namespace {

using dinomo::LINE;
using dinomo::SLOTS;

__global__ void log_merge_sorted_kernel(int32_t* __restrict__ lines,
                                        int64_t total,
                                        const int32_t* __restrict__ starts,
                                        int64_t groups,
                                        const int32_t* __restrict__ bucket_ids,
                                        const int32_t* __restrict__ keys,
                                        const int32_t* __restrict__ ptrs,
                                        int32_t* __restrict__ old,
                                        int32_t* __restrict__ ok) {
  const int64_t g = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x;
  if (g >= groups) return;
  const int32_t lo = starts[g];
  const int32_t hi = starts[g + 1];
  const int64_t b = dinomo::clamp_row(bucket_ids[lo], total);
  int32_t v[LINE];
  dinomo::load_line(lines, b, v);
  for (int32_t i = lo; i < hi; ++i) {
    const int32_t key = keys[i];
    int match = -1, empty = -1;
#pragma unroll
    for (int s = SLOTS - 1; s >= 0; --s) {
      if (v[s] == key) match = s;
      if (v[s] == dinomo::EMPTY) empty = s;
    }
    const bool live = key >= 0;
    const int target = match >= 0 ? match : empty;
    const bool okb = target >= 0 && live;
    old[i] = (match >= 0 && live) ? dinomo::slot_ptr(v, match) : dinomo::EMPTY;
    ok[i] = okb;
    if (okb) dinomo::set_slot(v, target, key, ptrs[i]);
  }
  dinomo::store_line(lines, b, v);
}

}  // namespace

extern "C" int log_merge_sorted_launch(int32_t* lines, int64_t total,
                                       const int32_t* starts, int64_t groups,
                                       const int32_t* bucket_ids,
                                       const int32_t* keys,
                                       const int32_t* ptrs, int32_t* old,
                                       int32_t* ok, cudaStream_t stream) {
  if (groups <= 0) return 0;
  constexpr int threads = 128;
  const unsigned blocks = static_cast<unsigned>((groups + threads - 1) / threads);
  log_merge_sorted_kernel<<<blocks, threads, 0, stream>>>(
      lines, total, starts, groups, bucket_ids, keys, ptrs, old, ok);
  return static_cast<int>(cudaGetLastError());
}
