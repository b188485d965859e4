// Kernel C of the DPM write path: log_merge_sorted.
//
// Replaces the Pallas kernel
// src/repro/kernels/log_merge/log_merge.py:log_merge_sorted (_merge_kernel).
// The entries arrive stable-sorted by bucket (log order kept within a
// bucket) with the start of every bucket group found by the wrapper. Each
// group applies its entries in log order to its bucket's line (clamped to
// the table): a match overwrites the pointer, else the first empty slot is
// claimed, else ok=0 for the sequential slow path; negative keys change
// nothing. Per entry it writes the superseded pointer and ok; the Pallas
// kernel's per-entry (E, 128) row output only served its block coherence
// and has no counterpart here.
//
// Why a group is parallel. A merge never frees a slot, so
// - a live key (>= 0) found in the loaded line is an update at every
//   occurrence, of the lowest matching slot;
// - the live keys not in the line, ordered by first occurrence, claim the
//   empty slots in ascending order while they last; every occurrence of a
//   later new key fails (old -1, ok 0), as does every negative key;
// - so at most SLOTS keys of a group succeed, one per slot, and an entry
//   of such a key has old = the pointer of the key's previous occurrence
//   in the group (the line's pointer for an update's first, -1 for a
//   claim's first), and the slot ends with the key's last pointer.
// The line's links and pad (lanes 6-7) are never touched.
//
// The design. `walk_kernel`, one thread per group: a group of at most
// `walk_max` entries (most groups of a write batch: 2^19 updates land in
// 2^25 buckets) is walked in log order as the loop above; a larger one is
// appended to a list. `group_kernel`, one block of 1024 threads per listed
// group (blocks draw groups from the list): the block walks the group in
// tiles of 1024 entries in log order, carrying the slots' keys and the last
// pointer of each slot from tile to tile, with the next tile's keys and
// pointers loading while one is merged. In a tile, the first new key is
// found by a ballot and a min over the warps, at most once per empty slot;
// each entry's previous entry of its slot is the highest lower lane of its
// warp's ballot, else the last of the nearest earlier warp, else the carry,
// and its pointer is read from the tile in shared memory. No sort, no
// atomics on data, no host read-back; the list's two counters are the only
// atomics.
//
// Bound on an H100 SXM: bytes. Per entry 8 B (key, ptr) read and 8 B
// (old, ok) written; per group 4 B of start and 4 B of bucket id read, and
// its 32-byte line read and written once; over 3.35 TB/s. A hot key's
// group (27 K entries in a served write_heavy_update batch) is one block's
// chain of 27 tiles, a few barriers each, while the other blocks take the
// rest of the list: latency, not bytes, bounds it.
#include <climits>

#include "clht_common.cuh"

namespace {

using dinomo::EMPTY;
using dinomo::LINE;
using dinomo::SLOTS;

constexpr int kWalkThreads = 128;
constexpr int kGroupThreads = 1024;
constexpr int kWarps = kGroupThreads / 32;
constexpr unsigned kFull = 0xFFFFFFFFu;

// list[0]: groups listed, list[1]: groups drawn, list[2:]: the groups
__global__ void walk_kernel(int32_t* __restrict__ lines, int64_t total,
                            const int32_t* __restrict__ starts,
                            int64_t groups,
                            const int32_t* __restrict__ bucket_ids,
                            const int32_t* __restrict__ keys,
                            const int32_t* __restrict__ ptrs,
                            int32_t* __restrict__ old,
                            int32_t* __restrict__ ok, int32_t walk_max,
                            int32_t* __restrict__ list) {
  const int64_t g =
      blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x;
  if (g >= groups) return;
  const int32_t lo = starts[g];
  const int32_t hi = starts[g + 1];
  if (hi <= lo) return;
  if (hi - lo > walk_max) {
    list[2 + atomicAdd(list, 1)] = static_cast<int32_t>(g);
    return;
  }
  const int64_t b = dinomo::clamp_row(bucket_ids[lo], total);
  int32_t v[LINE];
  dinomo::load_line(lines, b, v);
  for (int32_t i = lo; i < hi; ++i) {
    const int32_t key = keys[i];
    int match = -1, empty = -1;
#pragma unroll
    for (int s = SLOTS - 1; s >= 0; --s) {
      if (v[s] == key) match = s;
      if (v[s] == EMPTY) empty = s;
    }
    const bool live = key >= 0;
    const int target = match >= 0 ? match : empty;
    const bool okb = target >= 0 && live;
    old[i] = (match >= 0 && live) ? dinomo::slot_ptr(v, match) : EMPTY;
    ok[i] = okb;
    if (okb) dinomo::set_slot(v, target, key, ptrs[i]);
  }
  dinomo::store_line(lines, b, v);
}

// The slot whose key is `key` (-1 if none); want[s] is -1 where no live
// key lands in slot s (yet), and no live key equals -1.
__device__ __forceinline__ int slot_of(const int32_t (&want)[SLOTS],
                                       int32_t key) {
  int s_of = -1;
#pragma unroll
  for (int s = SLOTS - 1; s >= 0; --s)
    if (want[s] == key) s_of = s;
  return key >= 0 ? s_of : -1;
}

// One large group by the whole block (every thread runs every step).
__device__ void merge_group(int32_t* __restrict__ lines, int64_t total,
                            int32_t lo, int32_t hi,
                            const int32_t* __restrict__ bucket_ids,
                            const int32_t* __restrict__ keys,
                            const int32_t* __restrict__ ptrs,
                            int32_t* __restrict__ old,
                            int32_t* __restrict__ ok,
                            int32_t (&s_first)[2][kWarps],
                            int32_t (&s_last)[kWarps][SLOTS],
                            int32_t (&s_key)[kGroupThreads],
                            int32_t (&s_ptr)[kGroupThreads]) {
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int64_t b = dinomo::clamp_row(bucket_ids[lo], total);
  int32_t v[LINE];
  dinomo::load_line(lines, b, v);
  // want[s]: the key landing in slot s: the line's live key where no lower
  // slot holds it, later the claimed key of an empty slot
  int32_t want[SLOTS];
  int n_empty = 0;
#pragma unroll
  for (int s = 0; s < SLOTS; ++s) {
    bool dup = false;
#pragma unroll
    for (int t = 0; t < s; ++t) dup |= v[t] == v[s];
    want[s] = (v[s] >= 0 && !dup) ? v[s] : EMPTY;
    n_empty += v[s] == EMPTY;
  }
  int claimed = 0;
  // the last entry landing in each slot so far, and its pointer
  int32_t last[SLOTS] = {-1, -1, -1};
  int32_t last_ptr[SLOTS] = {EMPTY, EMPTY, EMPTY};
  int buf = 0;
  int32_t next_key = lo + tid < hi ? keys[lo + tid] : EMPTY;
  int32_t next_ptr = lo + tid < hi ? ptrs[lo + tid] : EMPTY;
  for (int32_t base = lo; base < hi; base += kGroupThreads) {
    const int32_t e = base + tid;
    const bool in = e < hi;
    const int32_t key = next_key;
    s_key[tid] = key;       // both read after the next barrier
    s_ptr[tid] = next_ptr;
    // the next tile's entries load while this one is merged
    const int32_t e2 = e + kGroupThreads;
    next_key = e2 < hi ? keys[e2] : EMPTY;
    next_ptr = e2 < hi ? ptrs[e2] : EMPTY;
    // the tile's new keys, in log order, claim the remaining empty slots
    while (claimed < n_empty) {
      const bool fresh = key >= 0 && slot_of(want, key) < 0;
      const unsigned m = __ballot_sync(kFull, fresh);
      if (lane == 0)
        s_first[buf][warp] = m ? warp * 32 + __ffs(m) - 1 : INT_MAX;
      __syncthreads();
      int first = INT_MAX;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) first = min(first, s_first[buf][w]);
      buf ^= 1;
      if (first == INT_MAX) break;
      const int32_t fk = s_key[first];
      // the claimed-th empty slot in ascending order
      int seen = 0;
#pragma unroll
      for (int s = 0; s < SLOTS; ++s) {
        if (v[s] == EMPTY) {
          if (seen == claimed) want[s] = fk;
          ++seen;
        }
      }
      ++claimed;
    }
    const int s_of = slot_of(want, key);
    // each entry's previous entry of its slot: in its warp, else in an
    // earlier warp, else in an earlier tile
    int32_t prev = -1;
#pragma unroll
    for (int s = 0; s < SLOTS; ++s) {
      const unsigned m = __ballot_sync(kFull, s_of == s);
      const unsigned below = m & ((1u << lane) - 1u);
      if (s_of == s && below) prev = warp * 32 + 31 - __clz(below);
      if (lane == 0)
        s_last[warp][s] = m ? warp * 32 + 31 - __clz(m) : -1;
    }
    __syncthreads();
    for (int w = warp - 1; s_of >= 0 && prev < 0 && w >= 0; --w)
      prev = s_last[w][s_of];
    int32_t o = EMPTY;
    if (prev >= 0) {
      o = s_ptr[prev];
    } else if (s_of >= 0) {
      // none in this tile: the slot's last pointer from an earlier tile,
      // else the key's first occurrence: an update's line pointer, a
      // claim's -1
#pragma unroll
      for (int s = 0; s < SLOTS; ++s)
        if (s == s_of)
          o = last[s] >= 0 ? last_ptr[s] : (v[s] != EMPTY ? v[SLOTS + s]
                                                          : EMPTY);
    }
#pragma unroll
    for (int s = 0; s < SLOTS; ++s) {
      int32_t t = -1;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) t = max(t, s_last[w][s]);
      if (t >= 0) {
        last[s] = base + t;
        last_ptr[s] = s_ptr[t];
      }
    }
    __syncthreads();  // s_last and s_ptr are rewritten by the next tile
    if (in) {
      old[e] = o;
      ok[e] = s_of >= 0;
    }
  }
  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < SLOTS; ++s) {
      if (last[s] >= 0) {
        v[s] = want[s];
        v[SLOTS + s] = last_ptr[s];
      }
    }
    dinomo::store_line(lines, b, v);
  }
}

__global__ void __launch_bounds__(kGroupThreads)
    group_kernel(int32_t* __restrict__ lines, int64_t total,
                 const int32_t* __restrict__ starts,
                 const int32_t* __restrict__ bucket_ids,
                 const int32_t* __restrict__ keys,
                 const int32_t* __restrict__ ptrs, int32_t* __restrict__ old,
                 int32_t* __restrict__ ok, int32_t* __restrict__ list) {
  __shared__ int32_t s_first[2][kWarps];
  __shared__ int32_t s_last[kWarps][SLOTS];
  __shared__ int32_t s_key[kGroupThreads];
  __shared__ int32_t s_ptr[kGroupThreads];
  __shared__ int32_t s_draw;
  const int32_t listed = list[0];  // written by walk_kernel before this launch
  for (;;) {
    if (threadIdx.x == 0) s_draw = atomicAdd(list + 1, 1);
    __syncthreads();
    const int32_t i = s_draw;
    __syncthreads();  // s_draw is rewritten by the next draw
    if (i >= listed) return;
    const int32_t g = list[2 + i];
    merge_group(lines, total, starts[g], starts[g + 1], bucket_ids, keys,
                ptrs, old, ok, s_first, s_last, s_key, s_ptr);
  }
}

}  // namespace

// list: (groups + 2,) int32 scratch whose first two entries are zero.
extern "C" int log_merge_sorted_launch(int32_t* lines, int64_t total,
                                       const int32_t* starts, int64_t groups,
                                       const int32_t* bucket_ids,
                                       const int32_t* keys,
                                       const int32_t* ptrs, int32_t* old,
                                       int32_t* ok, int32_t* list,
                                       int64_t walk_max, cudaStream_t stream) {
  if (groups <= 0) return 0;
  const unsigned blocks =
      static_cast<unsigned>((groups + kWalkThreads - 1) / kWalkThreads);
  walk_kernel<<<blocks, kWalkThreads, 0, stream>>>(
      lines, total, starts, groups, bucket_ids, keys, ptrs, old, ok,
      static_cast<int32_t>(walk_max), list);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  int device = 0, sms = 0;
  if (cudaGetDevice(&device) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device) !=
          cudaSuccess || sms <= 0)
    sms = 132;
  const int64_t large = groups < sms ? groups : sms;
  group_kernel<<<static_cast<unsigned>(large), kGroupThreads, 0, stream>>>(
      lines, total, starts, bucket_ids, keys, ptrs, old, ok, list);
  return static_cast<int>(cudaGetLastError());
}
