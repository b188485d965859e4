// Kernel E: one KN window of the DAC state machine, the compiled batch
// engine's single dispatch.
//
// Replaces src/repro/kernels/batch_executor/ops.py:fused_window (the
// jitted lax program _fused_window_impl), whose numpy oracle is
// ref.py:fused_window_ref. Per op, in order: value hits, shortcut hits
// with the Eq. 1 promote decision (integer threshold table, the count
// histogram's victim sum), make-space (demote LRU values, reinserting
// each as a shortcut while that leaves room, then evict LFU shortcuts),
// prefetch-resolved misses and staged write fills. It stops before the
// first op it cannot decide exactly (the cut reasons of ref.py) and
// returns how far it got.
//
// Every op depends on the state the ops before it leave, so the loop is
// sequential: one warp, every lane running the same scalar machine on the
// same values (the state's registers are warp-uniform; lane 0 alone
// stores), and the lanes together doing the two pieces of parallel work:
// - Victims. The LRU victim is argmin (stamp, key) over value entries,
//   the LFU victim argmin (count, key) over shortcuts. Each is the root of
//   a tournament min-tree in global memory, (value, key) int2 nodes in
//   heap order (root 1, leaf k at S + k), absent entries at 2^31 - 1. As
//   the pairs are unique, any tree's root is the lexicographic argmin, so
//   the reference's tie rules (even leaf first, then (value, key)) hold.
//   A leaf update re-mins its root path with the warp: lane j reads the
//   sibling at height j (all at once: one memory latency, not H), a
//   prefix-min over the lanes gives every path node, and lane j writes
//   the path node at height j. Lane j alone touches height j, so no lane
//   reads a node another lane wrote. The root comes back by a shuffle:
//   it is never read from memory. The reference carries each LRU
//   winner's length and count up its tree so that XLA's make-space loop
//   reads nothing it does not write; here a victim's length and count
//   are read from the state at its key, which holds the same values (a
//   live LRU leaf's payload is always its entry's length and count).
// - The Eq. 1 victim sum: the 64-bucket histogram (shared memory) scanned
//   by the warp, two buckets a lane.
// The entry kind is carried in the state (the reference derives it from
// the trees); the returned kind is the same.
//
// The trees are built from the state by fused_window_build (a launch of
// 1024-leaf blocks for the lower ten levels in shared memory, then one
// block for the rest), at an upload; they stay valid while only this
// kernel changes the state, so a resident KN builds them once a residency
// and not once a dispatch.
//
// Arithmetic: the state is int32, as the reference's; sums that are
// compared run in 64 bits. The jit engine's upload guards keep every value
// (capacity, clock, counts, lengths, pointers) below 2^30 or 2^31, so
// nothing wraps. A key outside [0, S) stops the loop with cut -1.
//
// Bound on an H100 SXM: latency. The work is a chain of dependent reads
// per op (the op's entry, then each tree update's siblings), a few
// hundred ns each from L2 or device memory; the bytes (the window's six
// inputs, the per-op reads and the tree paths touched, the two outputs)
// move in microseconds at 3.35 TB/s.
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int32_t kBig = 0x7fffffff;
constexpr int64_t kShortcut = 32;   // SHORTCUT_BYTES
constexpr int64_t kOverhead = 40;   // VALUE_OVERHEAD_BYTES
constexpr int kHistMax = 64;        // CNT_HIST_MAX
constexpr int kHeader = 10;         // n_exec, cut, the eight registers
constexpr unsigned kFull = 0xffffffffu;
constexpr int kBuildThreads = 512;
constexpr int kBuildChunk = 1024;   // leaves a build block reduces
constexpr int kTopThreads = 1024;

enum { OP_READ = 0, OP_WRITE = 1 };
enum { EV_VALUE_HIT = 0, EV_SHORTCUT_HIT, EV_PROMOTE, EV_MISS_FILL,
       EV_MISS_ABSENT, EV_WRITE };
enum { CUT_NONE = 0, CUT_SEGCACHE, CUT_PREFETCH, CUT_SPILL, CUT_EMA,
       CUT_TABLE };
constexpr int32_t kCutBadKey = -1;
constexpr int32_t PM_INVALID = -2, PM_ABSENT = -1;

__device__ __forceinline__ int2 lexmin(int2 a, int2 b) {
  return (b.x < a.x || (b.x == a.x && b.y < a.y)) ? b : a;
}

__device__ __forceinline__ int2 shfl_up2(int2 v, int d) {
  return make_int2(__shfl_up_sync(kFull, v.x, d),
                   __shfl_up_sync(kFull, v.y, d));
}

__device__ __forceinline__ int2 shfl2(int2 v, int src) {
  return make_int2(__shfl_sync(kFull, v.x, src),
                   __shfl_sync(kFull, v.y, src));
}

// ---------------------------------------------------------------- build
__global__ void build_low_kernel(const int32_t* __restrict__ kind,
                                 const int32_t* __restrict__ count,
                                 const int32_t* __restrict__ stamp,
                                 int64_t S, int chunk, int2* lru, int2* lfu) {
  __shared__ int2 a[kBuildChunk];
  __shared__ int2 b[kBuildChunk];
  const int t = threadIdx.x;
  const int64_t base = blockIdx.x * static_cast<int64_t>(chunk);
  for (int j = t; j < chunk; j += blockDim.x) {
    const int64_t k = base + j;
    const int32_t kd = kind[k];
    const int2 x = make_int2(kd == 2 ? stamp[k] : kBig,
                             static_cast<int32_t>(k));
    const int2 y = make_int2(kd == 1 ? count[k] : kBig,
                             static_cast<int32_t>(k));
    a[j] = x;
    b[j] = y;
    lru[S + k] = x;
    lfu[S + k] = y;
  }
  int h = 1;
  for (int w = chunk >> 1; w >= 1; w >>= 1, ++h) {
    __syncthreads();
    int2 x, y;
    if (t < w) {
      x = lexmin(a[2 * t], a[2 * t + 1]);
      y = lexmin(b[2 * t], b[2 * t + 1]);
    }
    __syncthreads();
    if (t < w) {
      a[t] = x;
      b[t] = y;
      const int64_t node = ((S + base) >> h) + t;
      lru[node] = x;
      lfu[node] = y;
    }
  }
}

// Heights h0..H from the nodes below them, one block (its writes are
// visible to its threads after each barrier).
__global__ void build_top_kernel(int64_t S, int h0, int H, int2* lru,
                                 int2* lfu) {
  for (int h = h0; h <= H; ++h) {
    const int64_t first = S >> h;
    for (int64_t j = threadIdx.x; j < first; j += blockDim.x) {
      const int64_t i = first + j;
      lru[i] = lexmin(lru[2 * i], lru[2 * i + 1]);
      lfu[i] = lexmin(lfu[2 * i], lfu[2 * i + 1]);
    }
    __syncthreads();
  }
}

// ------------------------------------------------------------ the machine
struct Tree {
  int2* node;
  int2 root;    // warp-uniform copy of node[1]
};

struct Machine {
  // state arrays (S,) and the window
  int32_t* kind;
  int32_t* count;
  int32_t* stamp;
  int32_t* length;
  int32_t* ptr;
  int32_t* wrote;
  int* hist;        // shared, CNT_HIST_MAX + 1 buckets
  int64_t S;
  int H;
  int64_t cap;
  int lane;
  Tree lru, lfu;
  // registers (warp-uniform)
  int32_t used, clock, zshort, nvals, nshort, ema_dirty, demotions,
      evictions;
  // the current op's key and its leaves' pending values
  int32_t k;
  bool lru_dirty, lfu_dirty;
  int32_t lru_val, lfu_val;

  __device__ __forceinline__ bool lead() const { return lane == 0; }

  // Set leaf ka of tree a (if da) and leaf kb of tree b (if db) and re-min
  // their root paths: the siblings of both paths are loaded first.
  __device__ void set2(bool da, int32_t ka, int32_t va, bool db,
                       int32_t kb, int32_t vb) {
    const int64_t la = S + ka, lb = S + kb;
    int2 sa = make_int2(kBig, kBig), sb = make_int2(kBig, kBig);
    if (da && lane < H) sa = lru.node[(la >> lane) ^ 1];
    if (db && lane < H) sb = lfu.node[(lb >> lane) ^ 1];
    if (da) lru.root = path(lru.node, la, make_int2(va, ka), sa);
    if (db) lfu.root = path(lfu.node, lb, make_int2(vb, kb), sb);
  }

  // The prefix-min up the path from leaf `leaf` (value `v`) over the
  // lanes' siblings `sib`; writes the path, returns the root.
  __device__ int2 path(int2* node, int64_t leaf, int2 v, int2 sib) {
    int2 m = lexmin(sib, v);
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int2 o = shfl_up2(m, d);
      if (lane >= d) m = lexmin(m, o);
    }
    int2 e = shfl_up2(m, 1);
    if (lane == 0) e = v;
    if (lane <= H) node[leaf >> lane] = e;
    return shfl2(m, H - 1);
  }

  __device__ void flush() {
    if (lru_dirty || lfu_dirty)
      set2(lru_dirty, k, lru_val, lfu_dirty, k, lfu_val);
    lru_dirty = lfu_dirty = false;
  }

  __device__ void hist_add(int32_t c, int d) {
    if (lead()) hist[c < kHistMax ? c : kHistMax] += d;
  }

  // ArrayDAC._make_space: demote LRU values (reinserting each as a
  // shortcut when that still leaves room), then evict LFU shortcuts.
  __device__ void make_space(int64_t need) {
    if (!(used + need > cap && (nvals > 0 || nshort > 0))) return;
    flush();                  // the op's key leaves both pools first
    while (used + need > cap && nvals > 0) {
      const int32_t v = lru.root.y;
      const int32_t lv = length[v];
      const int32_t cv = count[v];
      used -= lv + static_cast<int32_t>(kOverhead);
      nvals -= 1;
      demotions += 1;
      const bool reins = used + kShortcut + need <= cap;
      if (lead()) kind[v] = reins ? 1 : 0;
      if (reins) {
        used += static_cast<int32_t>(kShortcut);
        nshort += 1;
        if (cv == 0) zshort += 1;
        hist_add(cv, 1);
      }
      set2(true, v, kBig, reins, v, cv);
    }
    while (used + need > cap && nshort > 0) {
      const int32_t v = lfu.root.y;
      const int32_t cv = lfu.root.x;     // a shortcut's LFU leaf: its count
      if (lead()) kind[v] = 0;
      used -= static_cast<int32_t>(kShortcut);
      nshort -= 1;
      if (cv == 0) zshort -= 1;
      hist_add(cv, -1);
      evictions += 1;
      set2(false, 0, 0, true, v, kBig);
    }
  }

  __device__ void insert_shortcut(int32_t p, int32_t ln, int32_t cnt) {
    make_space(kShortcut);
    if (used + kShortcut > cap) return;   // smaller than one entry: skip
    if (lead()) {
      kind[k] = 1;
      ptr[k] = p;
      length[k] = ln;
      count[k] = cnt;
    }
    used += static_cast<int32_t>(kShortcut);
    nshort += 1;
    if (cnt == 0) zshort += 1;
    hist_add(cnt, 1);
    lfu_dirty = true;
    lfu_val = cnt;
  }

  // ArrayDAC._insert_value for an absent key; `prechecked` skips the
  // make-space (the caller proved the fit).
  __device__ void insert_value(int32_t p, int32_t ln, int32_t cnt,
                               bool prechecked) {
    const int64_t need = ln + kOverhead;
    if (!prechecked) make_space(need);
    if (used + need > cap) {
      insert_shortcut(p, ln, cnt);
      return;
    }
    if (lead()) {
      kind[k] = 2;
      ptr[k] = p;
      length[k] = ln;
      count[k] = cnt;
      stamp[k] = clock;
    }
    lru_dirty = true;
    lru_val = clock;
    clock += 1;
    used += static_cast<int32_t>(need);
    nvals += 1;
  }

  // ref._victim_sum_shifted over the shared histogram, two buckets a lane.
  __device__ bool victim_sum(int64_t n_evict, int32_t c, int64_t& vsum) {
    int64_t h[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int b = lane + 32 * r;
      int64_t m = hist[b] - (b == c - 1 ? 1 : 0);
      h[r] = m > 0 ? m : 0;
    }
    int64_t base = 0, got = 0, tot = 0;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      int64_t cum = h[r];
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const int64_t o = __shfl_up_sync(kFull, cum, d);
        if (lane >= d) cum += o;
      }
      const int64_t before = base + cum - h[r];
      int64_t take = n_evict - before;
      take = take < 0 ? 0 : (take > h[r] ? h[r] : take);
      got += take;
      tot += take * (lane + 32 * r);
      base += __shfl_sync(kFull, cum, 31);
    }
#pragma unroll
    for (int d = 16; d >= 1; d >>= 1) {
      got += __shfl_xor_sync(kFull, got, d);
      tot += __shfl_xor_sync(kFull, tot, d);
    }
    vsum = tot;
    return got < n_evict;
  }

  // ref._promote_decision_precheck: (cut, promote) with the hit
  // bookkeeping shifted in, the state untouched.
  __device__ int precheck(int32_t c, int32_t ln, const int32_t* vmax,
                          int64_t tn, bool& promote) {
    promote = false;
    const int64_t need = ln + kOverhead - kShortcut;
    const int64_t free = cap - used;
    if (free >= need) {
      promote = true;
      return CUT_NONE;
    }
    const int64_t n_evict = (need - free + kShortcut - 1) / kShortcut;
    const int64_t zs = zshort - (c == 1 ? 1 : 0);
    if (zs >= n_evict) {
      promote = true;
      return CUT_NONE;
    }
    if (static_cast<int64_t>(nshort) - 1 < n_evict) return CUT_NONE;
    if (ema_dirty) return CUT_EMA;
    int64_t vsum = 0;
    if (victim_sum(n_evict, c, vsum)) return CUT_SPILL;
    if (c >= tn) {
      if (vsum <= vmax[tn - 1]) {
        promote = true;
        return CUT_NONE;
      }
      return CUT_TABLE;
    }
    promote = vsum <= vmax[c];
    return CUT_NONE;
  }
};

__global__ void __launch_bounds__(32)
fused_window_kernel(int32_t* kind, int32_t* count, int32_t* stamp,
                    int32_t* length, int32_t* ptr, int32_t* wrote,
                    int32_t* hist_g, int32_t* regs, int64_t S, int H,
                    int2* lru, int2* lfu, const int32_t* __restrict__ ops,
                    const int32_t* __restrict__ keys,
                    const int32_t* __restrict__ wptr,
                    const int32_t* __restrict__ pm_ptr,
                    const int32_t* __restrict__ pm_len,
                    const int32_t* __restrict__ seg0, int64_t n, int64_t w,
                    int64_t cap, int32_t write_bytes,
                    const int32_t* __restrict__ vmax, int64_t tn,
                    int32_t* packed) {
  __shared__ int hist[kHistMax + 1];
  const int lane = threadIdx.x;
  for (int b = lane; b <= kHistMax; b += 32) hist[b] = hist_g[b];
  Machine m;
  m.kind = kind;
  m.count = count;
  m.stamp = stamp;
  m.length = length;
  m.ptr = ptr;
  m.wrote = wrote;
  m.hist = hist;
  m.S = S;
  m.H = H;
  m.cap = cap;
  m.lane = lane;
  m.lru.node = lru;
  m.lfu.node = lfu;
  m.lru.root = lru[1];
  m.lfu.root = lfu[1];
  m.used = regs[0];
  m.clock = regs[1];
  m.zshort = regs[2];
  m.nvals = regs[3];
  m.nshort = regs[4];
  m.ema_dirty = regs[5];
  m.demotions = regs[6];
  m.evictions = regs[7];
  m.lru_dirty = m.lfu_dirty = false;
  __syncwarp();
  int32_t* events = packed + kHeader;
  int32_t* out_ptr = packed + kHeader + w;
  const int64_t vbb = static_cast<int64_t>(write_bytes) + kOverhead;
  int cut = CUT_NONE;
  int64_t i = 0;
  int32_t t_op = 0, t_key = 0, t_wptr = 0, t_pp = 0, t_pl = 0, t_seg = 0;
  for (; i < n; ++i) {
    const int j = static_cast<int>(i & 31);
    if (j == 0) {             // the next 32 ops' inputs, one a lane
      const int64_t q = i + lane;
      if (q < n) {
        t_op = ops[q];
        t_key = keys[q];
        t_wptr = wptr[q];
        t_pp = pm_ptr[q];
        t_pl = pm_len[q];
        t_seg = seg0[q];
      }
    }
    const int32_t op = __shfl_sync(kFull, t_op, j);
    const int32_t k = __shfl_sync(kFull, t_key, j);
    const int32_t wp = __shfl_sync(kFull, t_wptr, j);
    const int32_t pp = __shfl_sync(kFull, t_pp, j);
    const int32_t pl = __shfl_sync(kFull, t_pl, j);
    const int32_t sg = __shfl_sync(kFull, t_seg, j);
    if (k < 0 || k >= S) {
      cut = kCutBadKey;
      break;
    }
    m.k = k;
    const int32_t kd = kind[k];
    const int32_t c_old = count[k];
    const int32_t ln_old = length[k];
    const int32_t p_old = ptr[k];
    const int32_t wr = wrote[k];
    int32_t ev, outp;
    if (op == OP_WRITE) {
      int32_t cpri = 0;
      if (kd == 2) {
        m.used -= ln_old + static_cast<int32_t>(kOverhead);
        m.nvals -= 1;
        cpri = c_old;
        m.lru_dirty = true;
        m.lru_val = kBig;
      } else if (kd == 1) {
        m.used -= static_cast<int32_t>(kShortcut);
        m.nshort -= 1;
        if (c_old == 0) m.zshort -= 1;
        m.hist_add(c_old, -1);
        cpri = c_old;
        m.lfu_dirty = true;
        m.lfu_val = kBig;
      }
      if (kd != 0 && m.lead()) kind[k] = 0;
      if (m.used + vbb <= cap)
        m.insert_value(wp, write_bytes, cpri, true);
      else
        m.insert_shortcut(wp, write_bytes, cpri);
      if (m.lead()) wrote[k] = 1;
      ev = EV_WRITE;
      outp = wp;
    } else if (kd == 2) {
      if (m.lead()) {
        count[k] = c_old + 1;
        stamp[k] = m.clock;
      }
      m.lru_dirty = true;
      m.lru_val = m.clock;
      m.clock += 1;
      ev = EV_VALUE_HIT;
      outp = p_old;
    } else if (kd == 1) {
      const int32_t c = c_old + 1;
      bool promote;
      const int reason = m.precheck(c, ln_old, vmax, tn, promote);
      if (reason != CUT_NONE) {
        cut = reason;
        break;
      }
      if (m.lead()) count[k] = c;
      if (c == 1) m.zshort -= 1;
      m.hist_add(c - 1, -1);
      m.hist_add(c, 1);
      outp = p_old;
      if (promote) {
        if (m.lead()) kind[k] = 0;
        m.used -= static_cast<int32_t>(kShortcut);
        m.nshort -= 1;
        if (c == 0) m.zshort -= 1;
        m.hist_add(c, -1);
        m.lfu_dirty = true;
        m.lfu_val = kBig;
        m.insert_value(p_old, ln_old, c, false);
        ev = EV_PROMOTE;
      } else {
        m.lfu_dirty = true;
        m.lfu_val = c;
        ev = EV_SHORTCUT_HIT;
      }
    } else {
      if (sg || wr) {
        cut = CUT_SEGCACHE;
        break;
      }
      if (pp == PM_INVALID) {
        cut = CUT_PREFETCH;
        break;
      }
      if (pp == PM_ABSENT) {
        ev = EV_MISS_ABSENT;
        outp = -1;
      } else {
        m.ema_dirty = 1;
        if (m.used + static_cast<int64_t>(pl) + kOverhead <= cap)
          m.insert_value(pp, pl, 1, true);
        else
          m.insert_shortcut(pp, pl, 1);
        ev = EV_MISS_FILL;
        outp = pp;
      }
    }
    m.flush();
    if (m.lead()) {
      events[i] = ev;
      out_ptr[i] = outp;
    }
    __syncwarp();           // lane 0's stores, seen by every lane
  }
  for (int64_t q = i + lane; q < w; q += 32) {
    events[q] = 0;
    out_ptr[q] = -1;
  }
  if (lane == 0) {
    const int32_t r[8] = {m.used, m.clock, m.zshort, m.nvals,
                          m.nshort, m.ema_dirty, m.demotions, m.evictions};
    packed[0] = static_cast<int32_t>(i);
    packed[1] = cut;
    for (int q = 0; q < 8; ++q) {
      regs[q] = r[q];
      packed[2 + q] = r[q];
    }
  }
  __syncwarp();
  for (int b = lane; b <= kHistMax; b += 32) hist_g[b] = hist[b];
}

int log2_exact(int64_t s) {
  int h = 0;
  while ((int64_t{1} << h) < s) ++h;
  return h;
}

}  // namespace

// Build both trees (2S int2 nodes each) from kind, count and stamp.
extern "C" int fused_window_build(const int32_t* kind, const int32_t* count,
                                  const int32_t* stamp, int64_t S,
                                  int2* lru, int2* lfu, cudaStream_t stream) {
  if (S < 2 || (S & (S - 1)) || S > (int64_t{1} << 30))
    return static_cast<int>(cudaErrorInvalidValue);
  const int chunk = S < kBuildChunk ? static_cast<int>(S) : kBuildChunk;
  build_low_kernel<<<static_cast<unsigned>(S / chunk), kBuildThreads, 0,
                     stream>>>(kind, count, stamp, S, chunk, lru, lfu);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int H = log2_exact(S);
  const int h0 = log2_exact(chunk) + 1;
  if (h0 <= H) {
    build_top_kernel<<<1, kTopThreads, 0, stream>>>(S, h0, H, lru, lfu);
    err = cudaGetLastError();
  }
  return static_cast<int>(err);
}

// Run up to n ops of the window (ops..seg0, each of w entries) over the
// state and its trees, in place; packed (10 + 2w int32) receives n_exec,
// the cut, the eight registers, then events and out_ptr (w each).
extern "C" int fused_window_launch(
    int32_t* kind, int32_t* count, int32_t* stamp, int32_t* length,
    int32_t* ptr, int32_t* wrote, int32_t* hist, int32_t* regs, int64_t S,
    int2* lru, int2* lfu, const int32_t* ops, const int32_t* keys,
    const int32_t* wptr, const int32_t* pm_ptr, const int32_t* pm_len,
    const int32_t* seg0, int64_t n, int64_t w, int64_t cap,
    int64_t write_bytes, const int32_t* vmax, int64_t tn, int32_t* packed,
    cudaStream_t stream) {
  if (S < 2 || (S & (S - 1)) || S > (int64_t{1} << 30) || n < 0 || n > w ||
      tn < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  fused_window_kernel<<<1, 32, 0, stream>>>(
      kind, count, stamp, length, ptr, wrote, hist, regs, S, log2_exact(S),
      lru, lfu, ops, keys, wptr, pm_ptr, pm_len, seg0, n, w, cap,
      static_cast<int32_t>(write_bytes), vmax, tn, packed);
  return static_cast<int>(cudaGetLastError());
}
