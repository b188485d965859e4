// Kernel D: the CLHT insert, in parallel over chains, exact.
//
// Not a Pallas kernel. It replaces the lax.scan of lax.conds in
// src/repro/core/clht.py:clht_insert, which the JAX plane runs on the
// device for the slow path of
// src/repro/kernels/log_merge/ops.py:merge_segment_fast (entries whose
// primary bucket was full). Its result is that of dinomo::insert_one run
// on every unmasked entry in log order (core/clht.py:clht_insert_plain),
// bit for bit: lines, overflow_head, old, ok and num_new.
//
// The order is much weaker than "every entry after the last":
// - a chain (a primary bucket and the overflow buckets linked from it)
//   shares no line with another, so chains are independent but for the
//   overflow cursor, which hands out buckets in log order;
// - within a chain, once a key (not -1, which matches empty slots) sits
//   in one of the MAX_CHAIN lines a walk sees, every later occurrence
//   is an update of that slot: old is the previous occurrence's ptr, ok
//   is 1, and the chain's shape does not change. A key linked in past
//   the MAX_CHAIN-th line is invisible to the next walk, and a key that
//   failed for want of overflow buckets fails again (nothing frees a
//   slot); the first case is walked again, the second is settled.
// So, after the wrapper's two stable sorts (torch.sort, no host sync):
//   prepare  key1 = (primary bucket, key) per entry, masked entries last;
//   mark     over the entries sorted by key1: each entry's group (the
//            first occurrence of its key in its chain, by binary search),
//            its previous occurrence, the group's last ptr; and key2 =
//            (not first, bucket), which sorts the first occurrences of
//            each chain, in log order, ahead of the rest;
//   plan     one thread per chain walks its first occurrences in log
//            order through insert_one's logic on a copy of the chain's
//            visible lines in local memory, with every overflow link
//            granted; it flags the entries that link. A walk that leaves
//            its key unsettled (linked past the walk's reach, or key -1)
//            turns the rest of the chain to a merge of first and later
//            occurrences in log order, walking every occurrence of an
//            unsettled key;
//   (the wrapper takes an inclusive count of the link flags in log order)
//   apply    the same walk with the real overflow ids: the link of rank r
//            gets head + r if that is below the region's end, and fails
//            otherwise (once one link fails, every later one does, in
//            every chain: before it every chain decided as in plan). It
//            writes each settled key's last ptr into its slot once, each
//            link once, and old and ok of every walked entry;
//   fill     old and ok of the entries that were not walked (old = the
//            previous occurrence's ptr, or -1 after a failure), and the
//            cursor: min(end, head + links).
// A write batch's hot keys in overflow buckets thus cost one walk per
// (chain, key) and one thread per entry, not one thread's walk per entry.
// Precondition (held by clht_init and every insert): the overflow buckets
// at and past the cursor are empty lines.
//
// Bound on an H100 SXM: bytes, 8 B read (key, ptr), 1 B of mask where
// given, 8 B written (old, ok) per entry, and each walked chain line read
// once and written once, over 3.35 TB/s: under a microsecond at the main
// path's batches. In practice latency: the sorts' passes, and each chain
// thread's dependent walks (the longest chain's distinct keys, one line
// each).
#include "clht_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kBucketBits = 33;            // key2: (not first) << 33 | bucket
constexpr int32_t kVirtual = 0x7FFFFFFF;   // a link in plan's copy
// status of a group (indexed by its first entry): (entry << 2) | state
constexpr int kOpen = 0, kSettledOk = 1, kSettledFail = 2;

__device__ __forceinline__ int64_t lower_bound(const int64_t* a, int64_t n,
                                               int64_t v) {
  int64_t lo = 0, hi = n;
  while (lo < hi) {
    const int64_t mid = (lo + hi) >> 1;
    if (a[mid] < v) lo = mid + 1; else hi = mid;
  }
  return lo;
}

__device__ __forceinline__ int64_t upper_bound(const int64_t* a, int64_t n,
                                               int64_t v) {
  int64_t lo = 0, hi = n;
  while (lo < hi) {
    const int64_t mid = (lo + hi) >> 1;
    if (a[mid] <= v) lo = mid + 1; else hi = mid;
  }
  return lo;
}

__global__ void prepare_kernel(const int32_t* __restrict__ keys,
                               const bool* __restrict__ mask, int64_t n,
                               int64_t num_buckets, int64_t* __restrict__ key1) {
  const int64_t e = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x;
  if (e >= n) return;
  const int32_t k = keys[e];
  const int64_t b = (mask != nullptr && !mask[e])
                        ? num_buckets
                        : dinomo::bucket_of(k, num_buckets);
  key1[e] = (b << 32) | static_cast<int64_t>(static_cast<uint32_t>(k));
}

__global__ void mark_kernel(const int64_t* __restrict__ key1s,
                            const int64_t* __restrict__ order1,
                            const int32_t* __restrict__ ptrs, int64_t n,
                            int32_t* __restrict__ grp,
                            int32_t* __restrict__ prev,
                            int32_t* __restrict__ last_ptr,
                            int64_t* __restrict__ key2,
                            int32_t* __restrict__ flags,
                            int32_t* __restrict__ status1,
                            int32_t* __restrict__ status2) {
  const int64_t r = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x;
  if (r >= n) return;
  const int64_t k = key1s[r];
  const int64_t e = order1[r];
  const int64_t lo = (r > 0 && key1s[r - 1] == k) ? lower_bound(key1s, r, k)
                                                  : r;
  grp[e] = static_cast<int32_t>(order1[lo]);
  prev[e] = r > lo ? static_cast<int32_t>(order1[r - 1]) : -1;
  if (r == lo) {
    const int64_t hi = upper_bound(key1s, n, k);
    last_ptr[e] = ptrs[order1[hi - 1]];
  }
  key2[e] = (static_cast<int64_t>(r > lo) << kBucketBits) | (k >> 32);
  flags[e] = 0;
  status1[e] = kOpen;
  status2[e] = kOpen;
}

// The lines a walk of one chain sees (at most MAX_CHAIN), as a copy.
struct Chain {
  int32_t id[dinomo::MAX_CHAIN];
  int32_t v[dinomo::MAX_CHAIN][dinomo::LINE];
  int n;
};

enum Outcome { kUpdate, kFill, kLinkSeen, kLinkUnseen, kFail };

template <bool kApply>
struct Walker {
  int32_t* lines;
  int64_t total;
  const int32_t* keys;
  const int32_t* ptrs;
  const int32_t* grp;
  const int32_t* last_ptr;
  int32_t* flags;
  const int32_t* incl;  // apply: inclusive count of link flags, log order
  int64_t head;
  int32_t* status;
  int32_t* old;
  int32_t* ok;
  Chain c;
  int fresh;

  __device__ void load(int64_t bucket) {
    int64_t cur = bucket;
    c.n = 0;
    for (int i = 0; i < dinomo::MAX_CHAIN; ++i) {
      c.id[i] = static_cast<int32_t>(cur);
      dinomo::load_line(lines, cur, c.v[i]);
      c.n = i + 1;
      if (c.v[i][dinomo::LINK] == dinomo::EMPTY) break;
      cur = c.v[i][dinomo::LINK];
    }
  }

  __device__ void put(int li, int s, int32_t key, int32_t ptr) {
    c.v[li][s] = key;
    c.v[li][dinomo::SLOTS + s] = ptr;
    if (kApply) {
      lines[static_cast<int64_t>(c.id[li]) * dinomo::LINE + s] = key;
      lines[static_cast<int64_t>(c.id[li]) * dinomo::LINE + dinomo::SLOTS + s] =
          ptr;
    }
  }

  // insert_one for entry e on the chain's copy (and, in apply, the lines)
  __device__ void walk(int64_t e) {
    const int32_t key = keys[e];
    int mb = -1, ms = -1, eb = -1, es = -1;
    for (int i = 0; i < c.n; ++i) {
      for (int s = dinomo::SLOTS - 1; s >= 0; --s) {
        if (mb < 0 && c.v[i][s] == key) ms = s;
        if (eb < 0 && c.v[i][s] == dinomo::EMPTY) es = s;
      }
      if (mb < 0 && ms >= 0) mb = i;
      if (eb < 0 && es >= 0) eb = i;
    }
    Outcome out;
    int32_t link_id = kVirtual;
    if (mb >= 0) {
      out = kUpdate;
    } else if (eb >= 0) {
      out = kFill;
    } else {
      bool granted = true;
      if (kApply) {
        const int64_t id = head + incl[e] - 1;  // this link's rank
        granted = flags[e] != 0 && id < total;
        link_id = static_cast<int32_t>(id);
      } else {
        flags[e] = 1;
      }
      out = !granted ? kFail
                     : (c.n < dinomo::MAX_CHAIN ? kLinkSeen : kLinkUnseen);
    }
    const bool settled =
        key != dinomo::EMPTY && out != kLinkUnseen;  // kFail settles too
    const int32_t g = grp[e];
    if (settled)
      status[g] = static_cast<int32_t>(e << 2) |
                  (out == kFail ? kSettledFail : kSettledOk);
    // a settled key's slot ends with its last occurrence's ptr
    const int32_t ptr = (settled && out != kFail) ? last_ptr[g] : ptrs[e];
    int32_t o = dinomo::EMPTY;
    if (out == kUpdate) {
      o = c.v[mb][dinomo::SLOTS + ms];
      put(mb, ms, key, ptr);
    } else if (out == kFill) {
      put(eb, es, key, ptr);
    } else if (out != kFail) {
      const int tail = c.n - 1;
      c.v[tail][dinomo::LINK] = link_id;
      if (kApply)
        lines[static_cast<int64_t>(c.id[tail]) * dinomo::LINE + dinomo::LINK] =
            link_id;
      if (out == kLinkSeen) {
        const int li = c.n++;
        c.id[li] = link_id;
#pragma unroll
        for (int t = 0; t < dinomo::LINE; ++t) c.v[li][t] = dinomo::EMPTY;
        put(li, 0, key, ptr);
      } else if (kApply) {
        lines[static_cast<int64_t>(link_id) * dinomo::LINE] = key;
        lines[static_cast<int64_t>(link_id) * dinomo::LINE + dinomo::SLOTS] =
            ptr;
      }
    }
    if (kApply) {
      old[e] = o;
      ok[e] = out != kFail;
      fresh += out != kUpdate && out != kFail;
    }
  }
};

// One thread per chain: plan (kApply false) or apply.
template <bool kApply>
__global__ void chain_kernel(Walker<kApply> w, const int64_t* __restrict__ key2s,
                             const int64_t* __restrict__ order2, int64_t n,
                             int64_t num_buckets,
                             const int32_t* __restrict__ overflow_head,
                             int32_t* __restrict__ num_new) {
  const int64_t q = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x;
  if (q >= n) return;
  const int64_t k2 = key2s[q];
  const int64_t bucket = k2 & ((int64_t{1} << kBucketBits) - 1);
  if ((k2 >> kBucketBits) != 0 || bucket == num_buckets) return;
  if (q > 0 && key2s[q - 1] == k2) return;
  if (kApply) w.head = *overflow_head;
  w.fresh = 0;
  w.load(bucket);
  // the chain's first occurrences, in log order, while every key settles
  int64_t f = q;
  int64_t open_at = -1;
  for (; f < n && key2s[f] == k2; ++f) {
    const int64_t e = order2[f];
    w.walk(e);
    if ((w.status[w.grp[e]] & 3) == kOpen) {
      open_at = e;
      ++f;
      break;
    }
  }
  if (open_at >= 0) {
    // the rest of the chain in log order: first occurrences, and the
    // later occurrences of keys not settled when they come
    const int64_t rk = (int64_t{1} << kBucketBits) | bucket;
    int64_t r = lower_bound(key2s, n, rk);
    const int64_t r_end = upper_bound(key2s, n, rk);
    int64_t lo = r, hi = r_end;  // first later occurrence past open_at
    while (lo < hi) {
      const int64_t mid = (lo + hi) >> 1;
      if (order2[mid] <= open_at) lo = mid + 1; else hi = mid;
    }
    r = lo;
    for (;;) {
      const bool has_f = f < n && key2s[f] == k2;
      const bool has_r = r < r_end;
      if (!has_f && !has_r) break;
      if (has_f && (!has_r || order2[f] < order2[r])) {
        w.walk(order2[f++]);
      } else {
        const int64_t e = order2[r++];
        if ((w.status[w.grp[e]] & 3) == kOpen) w.walk(e);
      }
    }
  }
  if (kApply && w.fresh) atomicAdd(num_new, w.fresh);
}

__global__ void fill_kernel(const int32_t* __restrict__ ptrs,
                            const bool* __restrict__ mask,
                            const int32_t* __restrict__ grp,
                            const int32_t* __restrict__ prev,
                            const int32_t* __restrict__ status,
                            const int32_t* __restrict__ incl, int64_t n,
                            int64_t total, int32_t* __restrict__ overflow_head,
                            int32_t* __restrict__ old,
                            int32_t* __restrict__ ok) {
  const int64_t e = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x;
  if (e == 0) {
    const int64_t head = static_cast<int64_t>(*overflow_head) + incl[n - 1];
    *overflow_head = static_cast<int32_t>(head < total ? head : total);
  }
  if (e >= n) return;
  if (mask != nullptr && !mask[e]) {
    old[e] = dinomo::EMPTY;
    ok[e] = 0;
    return;
  }
  const int32_t st = status[grp[e]];
  if ((st & 3) == kOpen || e <= (st >> 2)) return;  // walked in apply
  const bool good = (st & 3) == kSettledOk;
  old[e] = good ? ptrs[prev[e]] : dinomo::EMPTY;
  ok[e] = good;
}

unsigned blocks(int64_t n) {
  return static_cast<unsigned>((n + kThreads - 1) / kThreads);
}

}  // namespace

// key1 (n,) int64 out: (primary bucket, key) per entry, masked entries at
// bucket num_buckets.
extern "C" int clht_insert_prepare(const int32_t* keys, const bool* mask,
                                   int64_t n, int64_t num_buckets,
                                   int64_t* key1, cudaStream_t stream) {
  prepare_kernel<<<blocks(n), kThreads, 0, stream>>>(keys, mask, n,
                                                     num_buckets, key1);
  return static_cast<int>(cudaGetLastError());
}

// key1s, order1: key1 stably sorted and its permutation. Writes grp,
// prev, last_ptr, key2 and zeroes flags and both status arrays (all (n,)).
extern "C" int clht_insert_mark(const int64_t* key1s, const int64_t* order1,
                                const int32_t* ptrs, int64_t n, int32_t* grp,
                                int32_t* prev, int32_t* last_ptr,
                                int64_t* key2, int32_t* flags,
                                int32_t* status1, int32_t* status2,
                                cudaStream_t stream) {
  mark_kernel<<<blocks(n), kThreads, 0, stream>>>(
      key1s, order1, ptrs, n, grp, prev, last_ptr, key2, flags, status1,
      status2);
  return static_cast<int>(cudaGetLastError());
}

// key2s, order2: key2 stably sorted and its permutation. Sets the link
// flags of the entries that link a bucket when every link is granted.
extern "C" int clht_insert_plan(const int32_t* lines, int64_t num_buckets,
                                const int32_t* keys, const int32_t* ptrs,
                                const int64_t* key2s, const int64_t* order2,
                                int64_t n, const int32_t* grp,
                                const int32_t* last_ptr, int32_t* flags,
                                int32_t* status1, cudaStream_t stream) {
  Walker<false> w{};
  w.lines = const_cast<int32_t*>(lines);  // plan reads the lines only
  w.keys = keys;
  w.ptrs = ptrs;
  w.grp = grp;
  w.last_ptr = last_ptr;
  w.flags = flags;
  w.status = status1;
  chain_kernel<false><<<blocks(n), kThreads, 0, stream>>>(
      w, key2s, order2, n, num_buckets, nullptr, nullptr);
  return static_cast<int>(cudaGetLastError());
}

// incl: inclusive count of the link flags in log order. Applies the
// batch to the lines, writes old, ok (int32), num_new and the cursor.
extern "C" int clht_insert_launch(
    int32_t* lines, int64_t total, int64_t num_buckets, int32_t* overflow_head,
    const int32_t* keys, const int32_t* ptrs, const bool* mask, int64_t n,
    const int64_t* key2s, const int64_t* order2, const int32_t* grp,
    const int32_t* prev, const int32_t* last_ptr, const int32_t* flags,
    const int32_t* incl, int32_t* status2, int32_t* old, int32_t* ok,
    int32_t* num_new, cudaStream_t stream) {
  Walker<true> w{};
  w.lines = lines;
  w.total = total;
  w.keys = keys;
  w.ptrs = ptrs;
  w.grp = grp;
  w.last_ptr = last_ptr;
  w.flags = const_cast<int32_t*>(flags);  // apply reads the flags only
  w.incl = incl;
  w.status = status2;
  w.old = old;
  w.ok = ok;
  chain_kernel<true><<<blocks(n), kThreads, 0, stream>>>(
      w, key2s, order2, n, num_buckets, overflow_head, num_new);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  fill_kernel<<<blocks(n), kThreads, 0, stream>>>(
      ptrs, mask, grp, prev, status2, incl, n, total, overflow_head, old, ok);
  return static_cast<int>(cudaGetLastError());
}
