// Kernel E: the KN windows of the DAC state machine, the compiled batch
// engine's dispatches, every KN's window of one step in one launch; and the
// three small kernels that move a resident state's changed slots.
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
// One block a job (a KN's window over its own state, described by a row
// of int64 descriptors). Every op depends on the state the ops before it
// leave, so the op loop is sequential: warp 0 runs it, every lane running
// the same scalar machine on the same values (the registers are
// warp-uniform; lane 0 alone stores). The other seven warps wait at a
// named barrier and join warp 0 for the block-wide work it hands them.
// What the design does about the op's dependent memory latencies:
// - Entry prefetch. At the start of each group of 32 ops, lane q loads the
//   entry fields (kind, count, length, ptr, wrote) of op q's key: one
//   memory latency a group, not one an op (the group's inputs were loaded
//   a group ahead). The machine forwards its own writes since that load:
//   after each op every lane whose prefetched key is the op's key takes
//   the key's final fields, and each victim's new kind goes to the lanes
//   holding it.
// - Victims. The LRU victim is argmin (stamp, key) over value entries,
//   the LFU victim argmin (count, key) over shortcuts. Each is the root of
//   a tournament min-tree, (value, key) int2 nodes in heap order (root 1,
//   leaf k at S + k), absent entries at 2^31 - 1; the pairs are unique, so
//   any tree's root is the lexicographic argmin and the reference's tie
//   rules hold. The top twelve levels (nodes below 4096) live in shared
//   memory for the launch and are written back at its end; the rest in
//   global memory.
// - Deferred repair. An op's own leaf change (a value hit's stamp, a
//   shortcut hit's count, an insert or removal) is written to its leaf and
//   noted; the paths are repaired only when a root is read (make-space)
//   and at the end of the launch. Up to eight noted leaves a tree are
//   repaired by warp 0, each in one memory latency: lane j reads the
//   sibling at height j, a prefix-min over the lanes gives every path
//   node, lane j writes the node at height j. More are repaired by the
//   whole block, level by level (each level one latency and one barrier
//   for all noted leaves). Make-space's own victims change two leaves
//   each and read the roots next, so each is repaired at once by warp 0,
//   its fields and both paths' siblings loaded together.
// - Dirty record. Every slot the launch writes (the ops' keys, the
//   victims) is noted in shared memory; the block adds the notes to the
//   job's record (a bitmap and a list, each slot once) with atomics when
//   the notes fill and at the end, so the jit engine moves back only the
//   slots that changed (fused_window_gather).
// - The Eq. 1 victim sum: the 64-bucket histogram (shared memory) scanned
//   by the warp, two buckets a lane; the promote table in shared memory.
// The entry kind is carried in the state (the reference derives it from
// the trees); the returned kind is the same.
//
// The trees are built from the state by fused_window_build (a launch of
// 1024-leaf blocks for the lower ten levels in shared memory, then one
// block for the rest) at a full upload, and repaired by
// fused_window_scatter for the slots a delta upload writes; they stay
// valid while only these kernels change the state.
//
// Arithmetic: the state is int32, as the reference's; sums that are
// compared run in 64 bits. The jit engine's upload guards keep every value
// (capacity, clock, counts, lengths, pointers) below 2^30 or 2^31, so
// nothing wraps. A key outside [0, S) stops the loop with cut -1.
//
// Bound on an H100 SXM: latency. The work is a chain of dependent steps
// per op, a few hundred ns each where one reads L2 or device memory; the
// bytes (the window's six inputs, the per-op entries, the tree paths
// touched, the outputs) move in microseconds at 3.35 TB/s.
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int32_t kBig = 0x7fffffff;
constexpr int32_t kMin = -2147483647 - 1;
constexpr int64_t kShortcut = 32;   // SHORTCUT_BYTES
constexpr int64_t kOverhead = 40;   // VALUE_OVERHEAD_BYTES
constexpr int kHistMax = 64;        // CNT_HIST_MAX
constexpr int kRegs = 8;            // NUM_REGS
constexpr int kMeta = kHistMax + 1 + kRegs;
constexpr int kHeader = 10;         // n_exec, cut, the eight registers
constexpr unsigned kFull = 0xffffffffu;
constexpr int kBuildThreads = 512;
constexpr int kBuildChunk = 1024;   // leaves a build block reduces
constexpr int kTopThreads = 1024;
constexpr int kRepairMax = 2048;    // slots a scatter repairs; more: rebuild
constexpr int kThreads = 256;       // a job's block: warp 0 and 7 helpers
constexpr int kTop = 4096;          // tree nodes [1, kTop) in shared memory
constexpr int kPend = 1024;         // noted leaves a tree before a repair
constexpr int kWarpRepair = 8;      // noted leaves a tree warp 0 repairs
constexpr int kTouch = 1024;        // noted slots before a flush
constexpr int kVmax = 4096;         // promote-table rows in shared memory
constexpr int kDesc = 32;           // int64 fields of a job's descriptor
constexpr int kCmdService = 1, kCmdDone = 2;

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

// Barrier 1 over the block. Not .aligned: warp 0 reaches it from inside
// the machine while the helpers wait at another instruction.
__device__ __forceinline__ void bar(int nthreads) {
  asm volatile("barrier.sync 1, %0;" ::"r"(nthreads) : "memory");
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

int log2_exact(int64_t s) {
  int h = 0;
  while ((int64_t{1} << h) < s) ++h;
  return h;
}

cudaError_t build(const int32_t* kind, const int32_t* count,
                  const int32_t* stamp, int64_t S, int2* lru, int2* lfu,
                  cudaStream_t stream) {
  const int chunk = S < kBuildChunk ? static_cast<int>(S) : kBuildChunk;
  build_low_kernel<<<static_cast<unsigned>(S / chunk), kBuildThreads, 0,
                     stream>>>(kind, count, stamp, S, chunk, lru, lfu);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int H = log2_exact(S);
  const int h0 = log2_exact(chunk) + 1;
  if (h0 <= H) {
    build_top_kernel<<<1, kTopThreads, 0, stream>>>(S, h0, H, lru, lfu);
    err = cudaGetLastError();
  }
  return err;
}

// ------------------------------------------------------------ the block
struct Ctl {
  int cmd, npl, npf, ntouch, dcount;
};

// What every thread of a job's block shares.
struct Block {
  int64_t S, T;      // slots; tree nodes below T live in shared memory
  int H, tid, nthreads;
  int2 *node_lru, *node_lfu, *top_lru, *top_lfu, *pend_lru, *pend_lfu;
  int32_t* touch;
  unsigned* bits;    // the dirty record's bitmap (null: no record)
  int32_t* list;     // and its list
  Ctl* ctl;
};

// The block's service, run by every thread after warp 0's request: repair
// the noted leaves' paths level by level, then add the noted slots to the
// dirty record, each once (a bit set by atomicOr: the lane that set it
// appends).
__device__ void service_body(const Block& b) {
  const int npl = b.ctl->npl, npf = b.ctl->npf, nt = b.ctl->ntouch;
  const int np = npl + npf;
  if (np > 0) {
    for (int h = 1; h <= b.H; ++h) {
      for (int t = b.tid; t < np; t += b.nthreads) {
        const bool l = t < npl;
        const int32_t key = l ? b.pend_lru[t].x : b.pend_lfu[t - npl].x;
        int2* node = l ? b.node_lru : b.node_lfu;
        int2* top = l ? b.top_lru : b.top_lfu;
        const int64_t i = (b.S + key) >> h;
        const int64_t c = 2 * i;
        const int2 x = c < b.T ? top[c] : node[c];
        const int2 y = c + 1 < b.T ? top[c + 1] : node[c + 1];
        const int2 m = lexmin(x, y);
        if (i < b.T)
          top[i] = m;
        else
          node[i] = m;
      }
      bar(b.nthreads);
    }
  }
  if (nt > 0 && b.bits != nullptr) {
    const int warp = b.tid >> 5, lane = b.tid & 31;
    for (int base = warp * 32; base < nt; base += b.nthreads) {
      const int t = base + lane;
      bool fresh = false;
      int32_t key = 0;
      if (t < nt) {
        key = b.touch[t];
        const unsigned bit = 1u << (key & 31);
        fresh = !(atomicOr(&b.bits[key >> 5], bit) & bit);
      }
      const unsigned m = __ballot_sync(kFull, fresh);
      int at = 0;
      if (lane == 0 && m) at = atomicAdd(&b.ctl->dcount, __popc(m));
      at = __shfl_sync(kFull, at, 0);
      if (fresh) b.list[at + __popc(m & ((1u << lane) - 1u))] = key;
    }
  }
  bar(b.nthreads);
}

// ------------------------------------------------------------ the machine
struct Tree {
  int2* node;   // global, 2S nodes
  int2* top;    // shared, nodes [0, T)
  int2 root;    // warp-uniform copy of node 1
};

struct Machine {
  // state arrays (S,)
  int32_t* kind;
  int32_t* count;
  int32_t* stamp;
  int32_t* length;
  int32_t* ptr;
  int32_t* wrote;
  int* hist;                // shared, CNT_HIST_MAX + 1 buckets
  const int32_t* vmax_g;
  const int32_t* vmax_s;    // shared, the first kVmax rows
  int64_t tn;
  int64_t S, T;
  int H;
  int64_t cap;
  int lane;
  Tree lru, lfu;
  const Block* blk;
  int npl, npf, ntouch;     // noted leaves, noted slots (warp-uniform)
  bool track;               // the job has a dirty record
  // registers (warp-uniform)
  int32_t used, clock, zshort, nvals, nshort, ema_dirty, demotions,
      evictions;
  // the current op's key, its leaves' pending values, its final fields
  int32_t k;
  bool lru_dirty, lfu_dirty;
  int32_t lru_val, lfu_val;
  int32_t fk_kind, fk_count, fk_len, fk_ptr, fk_wrote;
  // lane q: the prefetched key of op q of the group and its fields
  int32_t t_key, e_kind, e_count, e_len, e_ptr, e_wrote;

  __device__ __forceinline__ bool lead() const { return lane == 0; }

  __device__ __forceinline__ int2 ld(const Tree& t, int64_t i) const {
    return i < T ? t.top[i] : t.node[i];
  }

  __device__ __forceinline__ void st(Tree& t, int64_t i, int2 v) const {
    if (i < T)
      t.top[i] = v;
    else
      t.node[i] = v;
  }

  __device__ __forceinline__ int32_t vm(int64_t i) const {
    return i < kVmax ? vmax_s[i] : vmax_g[i];
  }

  // Hand the block the noted leaves and slots (they are repaired and
  // recorded when it returns) and re-read the roots.
  __device__ void request() {
    if (lead()) {
      blk->ctl->cmd = kCmdService;
      blk->ctl->npl = npl;
      blk->ctl->npf = npf;
      blk->ctl->ntouch = ntouch;
    }
    __syncwarp();
    bar(blk->nthreads);
    service_body(*blk);
    npl = npf = ntouch = 0;
    lru.root = lru.top[1];
    lfu.root = lfu.top[1];
  }

  // Set leaf ka of the LRU tree (if da) and leaf kb of the LFU tree (if
  // db) and re-min their root paths at once: the siblings of both paths
  // are loaded first. Valid only when no other leaf of either is noted.
  __device__ void set2(bool da, int32_t ka, int32_t va, bool db,
                       int32_t kb, int32_t vb) {
    const int64_t la = S + ka, lb = S + kb;
    int2 sa = make_int2(kBig, kBig), sb = make_int2(kBig, kBig);
    if (da && lane < H) sa = ld(lru, (la >> lane) ^ 1);
    if (db && lane < H) sb = ld(lfu, (lb >> lane) ^ 1);
    if (da) lru.root = path(lru, la, make_int2(va, ka), sa);
    if (db) lfu.root = path(lfu, lb, make_int2(vb, kb), sb);
  }

  // The prefix-min up the path from leaf `leaf` (value `v`) over the
  // lanes' siblings `sib`; writes the path, returns the root.
  __device__ int2 path(Tree& t, int64_t leaf, int2 v, int2 sib) {
    int2 m = lexmin(sib, v);
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int2 o = shfl_up2(m, d);
      if (lane >= d) m = lexmin(m, o);
    }
    int2 e = shfl_up2(m, 1);
    if (lane == 0) e = v;
    if (lane <= H) st(t, leaf >> lane, e);
    return shfl2(m, H - 1);
  }

  // Write leaf `key` of a tree and note it for repair (the op loop keeps
  // room for it).
  __device__ void note_leaf(bool is_lru, int32_t key, int32_t v) {
    Tree& t = is_lru ? lru : lfu;
    if (lead()) {
      t.node[S + key] = make_int2(v, key);
      (is_lru ? blk->pend_lru : blk->pend_lfu)[is_lru ? npl : npf] =
          make_int2(key, v);
    }
    if (is_lru)
      ++npl;
    else
      ++npf;
  }

  // Note a slot the launch wrote, for the dirty record (the op loop and
  // make-space keep room for it).
  __device__ void note_slot(int32_t key) {
    if (!track) return;
    if (lead()) blk->touch[ntouch] = key;
    ++ntouch;
  }

  // Make both roots exact. A few noted leaves are repaired by the warp,
  // one path update (one latency) a leaf of each tree in turn: whatever
  // the order, the last update through a node sees its other children
  // final. More go to the block (a barrier a level).
  __device__ void settle() {
    if (npl + npf == 0) return;
    __syncwarp();
    if (npl <= kWarpRepair && npf <= kWarpRepair) {
      const int m = npl > npf ? npl : npf;
      for (int q = 0; q < m; ++q) {
        const int2 a = blk->pend_lru[q < npl ? q : 0];
        const int2 b = blk->pend_lfu[q < npf ? q : 0];
        set2(q < npl, a.x, a.y, q < npf, b.x, b.y);
      }
      npl = npf = 0;
      return;
    }
    request();
  }

  // The op's own leaf changes, noted.
  __device__ void flush() {
    if (lru_dirty) note_leaf(true, k, lru_val);
    if (lfu_dirty) note_leaf(false, k, lfu_val);
    lru_dirty = lfu_dirty = false;
  }

  // A victim's new kind: stored, and forwarded to the lanes holding it.
  __device__ void set_victim_kind(int32_t v, int32_t kd) {
    if (lead()) kind[v] = kd;
    if (t_key == v) e_kind = kd;
    note_slot(v);
  }

  // kind, ptr, length and count of the op's key.
  __device__ void put(int32_t kd, int32_t p, int32_t ln, int32_t cnt) {
    if (lead()) {
      kind[k] = kd;
      ptr[k] = p;
      length[k] = ln;
      count[k] = cnt;
    }
    fk_kind = kd;
    fk_ptr = p;
    fk_len = ln;
    fk_count = cnt;
  }

  __device__ void hist_add(int32_t c, int d) {
    if (lead()) hist[c < kHistMax ? c : kHistMax] += d;
  }

  // ArrayDAC._make_space: demote LRU values (reinserting each as a
  // shortcut when that still leaves room), then evict LFU shortcuts.
  __device__ void make_space(int64_t need) {
    if (!(used + need > cap && (nvals > 0 || nshort > 0))) return;
    flush();                  // the op's key leaves both pools first
    settle();
    while (used + need > cap && nvals > 0) {
      if (ntouch >= kTouch - 1) request();   // room: the victim, the op
      // the victim's fields and both paths' siblings in one latency
      const int32_t v = lru.root.y;
      const int64_t leaf = S + v;
      int2 sa = make_int2(kBig, kBig), sb = make_int2(kBig, kBig);
      if (lane < H) {
        sa = ld(lru, (leaf >> lane) ^ 1);
        sb = ld(lfu, (leaf >> lane) ^ 1);
      }
      const int32_t lv = length[v];
      const int32_t cv = count[v];
      used -= lv + static_cast<int32_t>(kOverhead);
      nvals -= 1;
      demotions += 1;
      const bool reins = used + kShortcut + need <= cap;
      if (reins) {
        used += static_cast<int32_t>(kShortcut);
        nshort += 1;
        if (cv == 0) zshort += 1;
        hist_add(cv, 1);
      }
      lru.root = path(lru, leaf, make_int2(kBig, v), sa);
      if (reins) lfu.root = path(lfu, leaf, make_int2(cv, v), sb);
      set_victim_kind(v, reins ? 1 : 0);
    }
    while (used + need > cap && nshort > 0) {
      if (ntouch >= kTouch - 1) request();
      const int32_t v = lfu.root.y;
      const int32_t cv = lfu.root.x;     // a shortcut's LFU leaf: its count
      used -= static_cast<int32_t>(kShortcut);
      nshort -= 1;
      if (cv == 0) zshort -= 1;
      hist_add(cv, -1);
      evictions += 1;
      set2(false, 0, 0, true, v, kBig);
      set_victim_kind(v, 0);
    }
  }

  __device__ void insert_shortcut(int32_t p, int32_t ln, int32_t cnt) {
    make_space(kShortcut);
    if (used + kShortcut > cap) return;   // smaller than one entry: skip
    put(1, p, ln, cnt);
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
    put(2, p, ln, cnt);
    if (lead()) stamp[k] = clock;
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
  __device__ int precheck(int32_t c, int32_t ln, bool& promote) {
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
      if (vsum <= vm(tn - 1)) {
        promote = true;
        return CUT_NONE;
      }
      return CUT_TABLE;
    }
    promote = vsum <= vm(c);
    return CUT_NONE;
  }
};

// One job's window, run by warp 0 of its block (see the head comment).
__device__ void run_machine(Machine& m, const int32_t* __restrict__ ops,
                            const int32_t* __restrict__ keys,
                            const int32_t* __restrict__ wptr,
                            const int32_t* __restrict__ pm_ptr,
                            const int32_t* __restrict__ pm_len,
                            const int32_t* __restrict__ seg0, int64_t n,
                            int64_t w, int32_t write_bytes,
                            int32_t* packed, int64_t& n_exec, int& cut_out) {
  const int lane = m.lane;
  int32_t* events = packed + kHeader;
  int32_t* out_ptr = packed + kHeader + w;
  const int64_t vbb = static_cast<int64_t>(write_bytes) + kOverhead;
  const int64_t S = m.S;
  int cut = CUT_NONE;
  int64_t i = 0;
  // the group's inputs, and the next group's (loaded a group ahead)
  int32_t t_op = 0, t_wptr = 0, t_pp = 0, t_pl = 0, t_seg = 0;
  int32_t n_op = 0, n_key = 0, n_wptr = 0, n_pp = 0, n_pl = 0, n_seg = 0;
  auto load_next = [&](int64_t base) {
    const int64_t q = base + lane;
    if (q < n) {
      n_op = ops[q];
      n_key = keys[q];
      n_wptr = wptr[q];
      n_pp = pm_ptr[q];
      n_pl = pm_len[q];
      n_seg = seg0[q];
    }
  };
  load_next(0);
  m.t_key = -1;
  for (; i < n; ++i) {
    const int j = static_cast<int>(i & 31);
    if (j == 0) {
      t_op = n_op;
      m.t_key = n_key;
      t_wptr = n_wptr;
      t_pp = n_pp;
      t_pl = n_pl;
      t_seg = n_seg;
      load_next(i + 32);
      // the group's entries, one a lane: one latency for 32 ops
      if (i + lane < n && m.t_key >= 0 && m.t_key < S) {
        const int32_t q = m.t_key;
        m.e_kind = m.kind[q];
        m.e_count = m.count[q];
        m.e_len = m.length[q];
        m.e_ptr = m.ptr[q];
        m.e_wrote = m.wrote[q];
      } else {
        m.t_key = -1;
      }
    }
    // room for what an op notes besides its victims: two leaves a tree,
    // its own slot (one place that hands the block its work: the
    // service's code is inlined at each)
    if (m.npl > kPend - 2 || m.npf > kPend - 2 || m.ntouch > kTouch - 1)
      m.request();
    const int32_t op = __shfl_sync(kFull, t_op, j);
    const int32_t k = __shfl_sync(kFull, m.t_key, j);
    const int32_t wp = __shfl_sync(kFull, t_wptr, j);
    const int32_t pp = __shfl_sync(kFull, t_pp, j);
    const int32_t pl = __shfl_sync(kFull, t_pl, j);
    const int32_t sg = __shfl_sync(kFull, t_seg, j);
    if (k < 0) {        // lanes drop keys outside [0, S) at the load
      cut = kCutBadKey;
      break;
    }
    const int32_t kd = __shfl_sync(kFull, m.e_kind, j);
    const int32_t c_old = __shfl_sync(kFull, m.e_count, j);
    const int32_t ln_old = __shfl_sync(kFull, m.e_len, j);
    const int32_t p_old = __shfl_sync(kFull, m.e_ptr, j);
    const int32_t wr = __shfl_sync(kFull, m.e_wrote, j);
    m.k = k;
    m.fk_kind = kd;
    m.fk_count = c_old;
    m.fk_len = ln_old;
    m.fk_ptr = p_old;
    m.fk_wrote = wr;
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
      if (kd != 0) {
        if (m.lead()) m.kind[k] = 0;
        m.fk_kind = 0;
      }
      if (m.used + vbb <= m.cap)
        m.insert_value(wp, write_bytes, cpri, true);
      else
        m.insert_shortcut(wp, write_bytes, cpri);
      if (m.lead()) m.wrote[k] = 1;
      m.fk_wrote = 1;
      ev = EV_WRITE;
      outp = wp;
    } else if (kd == 2) {
      if (m.lead()) {
        m.count[k] = c_old + 1;
        m.stamp[k] = m.clock;
      }
      m.fk_count = c_old + 1;
      m.lru_dirty = true;
      m.lru_val = m.clock;
      m.clock += 1;
      ev = EV_VALUE_HIT;
      outp = p_old;
    } else if (kd == 1) {
      const int32_t c = c_old + 1;
      bool promote;
      const int reason = m.precheck(c, ln_old, promote);
      if (reason != CUT_NONE) {
        cut = reason;
        break;
      }
      if (m.lead()) m.count[k] = c;
      m.fk_count = c;
      if (c == 1) m.zshort -= 1;
      m.hist_add(c - 1, -1);
      m.hist_add(c, 1);
      outp = p_old;
      if (promote) {
        if (m.lead()) m.kind[k] = 0;
        m.fk_kind = 0;
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
        if (m.used + static_cast<int64_t>(pl) + kOverhead <= m.cap)
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
    // forward the key's final fields to the lanes that prefetched it
    if (m.t_key == k) {
      m.e_kind = m.fk_kind;
      m.e_count = m.fk_count;
      m.e_len = m.fk_len;
      m.e_ptr = m.fk_ptr;
      m.e_wrote = m.fk_wrote;
    }
    if (ev != EV_MISS_ABSENT) m.note_slot(k);
    __syncwarp();           // lane 0's stores, seen by every lane
  }
  for (int64_t q = i + lane; q < w; q += 32) {
    events[q] = 0;
    out_ptr[q] = -1;
  }
  n_exec = i;
  cut_out = cut;
}

__global__ void __launch_bounds__(kThreads)
fused_windows_kernel(const int64_t* __restrict__ descs) {
  extern __shared__ int4 smem4[];
  const int64_t* d = descs + static_cast<int64_t>(blockIdx.x) * kDesc;
  int32_t* st[8];
#pragma unroll
  for (int q = 0; q < 8; ++q) st[q] = reinterpret_cast<int32_t*>(d[q]);
  const int64_t S = d[8];
  int2* lru = reinterpret_cast<int2*>(d[9]);
  int2* lfu = reinterpret_cast<int2*>(d[10]);
  int32_t* dirty = reinterpret_cast<int32_t*>(d[11]);
  const int32_t* win[6];
#pragma unroll
  for (int q = 0; q < 6; ++q) win[q] = reinterpret_cast<const int32_t*>(d[12 + q]);
  const int64_t n = d[18], w = d[19], cap = d[20];
  const int32_t write_bytes = static_cast<int32_t>(d[21]);
  const int32_t* vmax = reinterpret_cast<const int32_t*>(d[22]);
  const int64_t tn = d[23];
  int32_t* packed = reinterpret_cast<int32_t*>(d[24]);

  // shared memory: the trees' top levels, the noted leaves and slots, the
  // promote table, the histogram and the control words
  int2* top_lru = reinterpret_cast<int2*>(smem4);
  int2* top_lfu = top_lru + kTop;
  int2* pend_lru = top_lfu + kTop;
  int2* pend_lfu = pend_lru + kPend;
  int32_t* touch = reinterpret_cast<int32_t*>(pend_lfu + kPend);
  int32_t* vmax_s = touch + kTouch;
  int* hist = vmax_s + kVmax;
  Ctl* ctl = reinterpret_cast<Ctl*>(hist + kHistMax + 4);

  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  const int64_t T = S < kTop ? S : kTop;
  const int64_t words = (S + 31) / 32;
  Block blk;
  blk.S = S;
  blk.T = T;
  blk.H = 63 - __clzll(static_cast<unsigned long long>(S));
  blk.tid = tid;
  blk.nthreads = nthreads;
  blk.node_lru = lru;
  blk.node_lfu = lfu;
  blk.top_lru = top_lru;
  blk.top_lfu = top_lfu;
  blk.pend_lru = pend_lru;
  blk.pend_lfu = pend_lfu;
  blk.touch = touch;
  blk.bits = dirty ? reinterpret_cast<unsigned*>(dirty + 1) : nullptr;
  blk.list = dirty ? dirty + 1 + words : nullptr;
  blk.ctl = ctl;

  for (int64_t i = 1 + tid; i < T; i += nthreads) {
    top_lru[i] = lru[i];
    top_lfu[i] = lfu[i];
  }
  const int64_t tv = tn < kVmax ? tn : kVmax;
  for (int64_t i = tid; i < tv; i += nthreads) vmax_s[i] = vmax[i];
  for (int b = tid; b <= kHistMax; b += nthreads) hist[b] = st[6][b];
  if (tid == 0) {
    ctl->cmd = 0;
    ctl->dcount = dirty ? dirty[0] : 0;
  }
  bar(nthreads);

  if (tid < 32) {
    Machine m;
    m.kind = st[0];
    m.count = st[1];
    m.stamp = st[2];
    m.length = st[3];
    m.ptr = st[4];
    m.wrote = st[5];
    m.hist = hist;
    m.vmax_g = vmax;
    m.vmax_s = vmax_s;
    m.tn = tn;
    m.S = S;
    m.T = T;
    m.H = blk.H;
    m.cap = cap;
    m.lane = tid;
    m.lru.node = lru;
    m.lfu.node = lfu;
    m.lru.top = top_lru;
    m.lfu.top = top_lfu;
    m.lru.root = top_lru[1];
    m.lfu.root = top_lfu[1];
    m.blk = &blk;
    m.npl = m.npf = m.ntouch = 0;
    m.track = dirty != nullptr;
    const int32_t* regs = st[7];
    m.used = regs[0];
    m.clock = regs[1];
    m.zshort = regs[2];
    m.nvals = regs[3];
    m.nshort = regs[4];
    m.ema_dirty = regs[5];
    m.demotions = regs[6];
    m.evictions = regs[7];
    m.lru_dirty = m.lfu_dirty = false;
    m.e_kind = m.e_count = m.e_len = m.e_ptr = m.e_wrote = 0;
    int64_t n_exec = 0;
    int cut = CUT_NONE;
    run_machine(m, win[0], win[1], win[2], win[3], win[4], win[5], n, w,
                write_bytes, packed, n_exec, cut);
    m.request();              // the last repair and record flush
    if (tid == 0) {
      const int32_t r[8] = {m.used, m.clock, m.zshort, m.nvals,
                            m.nshort, m.ema_dirty, m.demotions,
                            m.evictions};
      packed[0] = static_cast<int32_t>(n_exec);
      packed[1] = cut;
      for (int q = 0; q < 8; ++q) {
        st[7][q] = r[q];
        packed[2 + q] = r[q];
      }
      ctl->cmd = kCmdDone;
    }
    __syncwarp();
    bar(nthreads);
  } else {
    while (true) {
      bar(nthreads);
      if (ctl->cmd == kCmdDone) break;
      service_body(blk);
    }
  }
  // every thread: the top levels and the histogram back to memory
  for (int64_t i = 1 + tid; i < T; i += nthreads) {
    lru[i] = top_lru[i];
    lfu[i] = top_lfu[i];
  }
  for (int b = tid; b <= kHistMax; b += nthreads) st[6][b] = hist[b];
  if (tid == 0) {
    packed[kHeader + 2 * w] = ctl->dcount;
    if (dirty) dirty[0] = ctl->dcount;
  }
}

constexpr size_t kSmemBytes =
    2 * kTop * sizeof(int2) + 2 * kPend * sizeof(int2) +
    kTouch * sizeof(int32_t) + kVmax * sizeof(int32_t) +
    (kHistMax + 4) * sizeof(int) + sizeof(Ctl);

// ------------------------------------------------------- moving slots
// [hist, regs, keys (n), kind, count, stamp, length, ptr (n each)] of the
// dirty record's n slots; their bits, their wrote flags and the count are
// cleared.
__global__ void gather_kernel(const int32_t* __restrict__ kind,
                              const int32_t* __restrict__ count,
                              const int32_t* __restrict__ stamp,
                              const int32_t* __restrict__ length,
                              const int32_t* __restrict__ ptr,
                              int32_t* wrote, const int32_t* hist,
                              const int32_t* regs, int32_t* dirty,
                              int64_t words, int64_t n, int32_t* out) {
  const int64_t t = blockIdx.x * static_cast<int64_t>(blockDim.x) +
                    threadIdx.x;
  if (t < kMeta) out[t] = t <= kHistMax ? hist[t] : regs[t - kHistMax - 1];
  unsigned* bits = reinterpret_cast<unsigned*>(dirty + 1);
  const int32_t* list = dirty + 1 + words;
  int32_t* o = out + kMeta;
  for (int64_t q = t; q < n; q += static_cast<int64_t>(gridDim.x) *
                                   blockDim.x) {
    const int32_t k = list[q];
    o[q] = k;
    o[n + q] = kind[k];
    o[2 * n + q] = count[k];
    o[3 * n + q] = stamp[k];
    o[4 * n + q] = length[k];
    o[5 * n + q] = ptr[k];
    wrote[k] = 0;
    atomicAnd(&bits[k >> 5], ~(1u << (k & 31)));
  }
  if (t == 0) dirty[0] = 0;
}

// The slots of a record in gather's layout written into the state, each
// slot's tree leaves set to match.
__global__ void scatter_kernel(int32_t* kind, int32_t* count, int32_t* stamp,
                               int32_t* length, int32_t* ptr, int32_t* hist,
                               int32_t* regs, int64_t S, int2* lru, int2* lfu,
                               const int32_t* __restrict__ rec, int64_t n) {
  const int64_t t = blockIdx.x * static_cast<int64_t>(blockDim.x) +
                    threadIdx.x;
  if (t < kMeta) {
    if (t <= kHistMax)
      hist[t] = rec[t];
    else
      regs[t - kHistMax - 1] = rec[t];
  }
  const int32_t* r = rec + kMeta;
  for (int64_t q = t; q < n; q += static_cast<int64_t>(gridDim.x) *
                                   blockDim.x) {
    const int32_t k = r[q];
    const int32_t kd = r[n + q], cn = r[2 * n + q], sp = r[3 * n + q];
    kind[k] = kd;
    count[k] = cn;
    stamp[k] = sp;
    length[k] = r[4 * n + q];
    ptr[k] = r[5 * n + q];
    lru[S + k] = make_int2(kd == 2 ? sp : kBig, k);
    lfu[S + k] = make_int2(kd == 1 ? cn : kBig, k);
  }
}

// The root paths of n leaves, level by level, in one block.
__global__ void repair_kernel(int64_t S, int H, int2* lru, int2* lfu,
                              const int32_t* __restrict__ keys, int64_t n) {
  for (int h = 1; h <= H; ++h) {
    for (int64_t t = threadIdx.x; t < n; t += blockDim.x) {
      const int64_t i = (S + keys[t]) >> h;
      lru[i] = lexmin(lru[2 * i], lru[2 * i + 1]);
      lfu[i] = lexmin(lfu[2 * i], lfu[2 * i + 1]);
    }
    __syncthreads();
  }
}

__global__ void guards_init_kernel(int32_t* out) {
  if (threadIdx.x < 3) out[threadIdx.x] = kMin;
}

// The largest count, ptr and length over the live slots of [0, n).
__global__ void guards_kernel(const int32_t* __restrict__ kind,
                              const int32_t* __restrict__ count,
                              const int32_t* __restrict__ length,
                              const int32_t* __restrict__ ptr, int64_t n,
                              int32_t* out) {
  __shared__ int32_t part[3][32];
  int32_t mc = kMin, mp = kMin, ml = kMin;
  for (int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) +
                   threadIdx.x;
       i < n; i += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    if (kind[i] != 0) {
      mc = max(mc, count[i]);
      mp = max(mp, ptr[i]);
      ml = max(ml, length[i]);
    }
  }
#pragma unroll
  for (int d = 16; d >= 1; d >>= 1) {
    mc = max(mc, __shfl_xor_sync(kFull, mc, d));
    mp = max(mp, __shfl_xor_sync(kFull, mp, d));
    ml = max(ml, __shfl_xor_sync(kFull, ml, d));
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) {
    part[0][warp] = mc;
    part[1][warp] = mp;
    part[2][warp] = ml;
  }
  __syncthreads();
  if (threadIdx.x < 3) {
    int32_t m = kMin;
    for (int q = 0; q < static_cast<int>(blockDim.x >> 5); ++q)
      m = max(m, part[threadIdx.x][q]);
    atomicMax(&out[threadIdx.x], m);
  }
}

}  // namespace

// Build both trees (2S int2 nodes each) from kind, count and stamp.
extern "C" int fused_window_build(const int32_t* kind, const int32_t* count,
                                  const int32_t* stamp, int64_t S,
                                  int2* lru, int2* lfu, cudaStream_t stream) {
  if (S < 2 || (S & (S - 1)) || S > (int64_t{1} << 30))
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(build(kind, count, stamp, S, lru, lfu, stream));
}

// Run k jobs' windows, one block a job; descs is (k, 32) int64 on the
// card: the eight state pointers, S, the two trees, the dirty record (or
// 0), the six window arrays, n, w, cap, write_bytes, vmax, its rows, and
// packed (10 + 2w + 1 int32: n_exec, the cut, the eight registers, events
// and out_ptr (w each), the dirty record's count).
extern "C" int fused_windows_launch(const int64_t* descs, int64_t k,
                                    cudaStream_t stream) {
  if (k < 1 || k > (int64_t{1} << 20))
    return static_cast<int>(cudaErrorInvalidValue);
  static bool sized = false;
  if (!sized) {
    const cudaError_t err = cudaFuncSetAttribute(
        fused_windows_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(kSmemBytes));
    if (err != cudaSuccess) return static_cast<int>(err);
    sized = true;
  }
  fused_windows_kernel<<<static_cast<unsigned>(k), kThreads, kSmemBytes,
                         stream>>>(descs);
  return static_cast<int>(cudaGetLastError());
}

// The dirty record's n slots (n its count) with their fields into out
// (73 + 6n int32); the record emptied, the slots' wrote flags cleared.
extern "C" int fused_window_gather(const int32_t* kind, const int32_t* count,
                                   const int32_t* stamp,
                                   const int32_t* length, const int32_t* ptr,
                                   int32_t* wrote, const int32_t* hist,
                                   const int32_t* regs, int64_t S,
                                   int32_t* dirty, int64_t n, int32_t* out,
                                   cudaStream_t stream) {
  if (S < 2 || n < 0 || n > S) return static_cast<int>(cudaErrorInvalidValue);
  int64_t blocks = (n + 255) / 256;
  blocks = blocks < 1 ? 1 : (blocks > 1024 ? 1024 : blocks);
  gather_kernel<<<static_cast<unsigned>(blocks), 256, 0, stream>>>(
      kind, count, stamp, length, ptr, wrote, hist, regs, dirty,
      (S + 31) / 32, n, out);
  return static_cast<int>(cudaGetLastError());
}

// A record of n slots (gather's layout) written into the state; the trees
// repaired for them (rebuilt when they are many).
extern "C" int fused_window_scatter(int32_t* kind, int32_t* count,
                                    int32_t* stamp, int32_t* length,
                                    int32_t* ptr, int32_t* wrote,
                                    int32_t* hist, int32_t* regs, int64_t S,
                                    int2* lru, int2* lfu, const int32_t* rec,
                                    int64_t n, cudaStream_t stream) {
  (void)wrote;
  if (S < 2 || (S & (S - 1)) || S > (int64_t{1} << 30) || n < 0 || n > S)
    return static_cast<int>(cudaErrorInvalidValue);
  int64_t blocks = (n + 255) / 256;
  blocks = blocks < 1 ? 1 : (blocks > 1024 ? 1024 : blocks);
  scatter_kernel<<<static_cast<unsigned>(blocks), 256, 0, stream>>>(
      kind, count, stamp, length, ptr, hist, regs, S, lru, lfu, rec, n);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || n == 0) return static_cast<int>(err);
  if (n > kRepairMax) return static_cast<int>(
      build(kind, count, stamp, S, lru, lfu, stream));
  repair_kernel<<<1, 1024, 0, stream>>>(S, log2_exact(S), lru, lfu,
                                        rec + kMeta, n);
  return static_cast<int>(cudaGetLastError());
}

// The three guard maxima (count, ptr, length over live slots of [0, n))
// into out; -2^31 where no slot is live.
extern "C" int fused_window_guards(const int32_t* kind, const int32_t* count,
                                   const int32_t* length, const int32_t* ptr,
                                   int64_t n, int32_t* out,
                                   cudaStream_t stream) {
  if (n < 0) return static_cast<int>(cudaErrorInvalidValue);
  guards_init_kernel<<<1, 32, 0, stream>>>(out);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || n == 0) return static_cast<int>(err);
  int64_t blocks = (n + 1023) / 1024;
  blocks = blocks > 528 ? 528 : blocks;
  guards_kernel<<<static_cast<unsigned>(blocks), 1024, 0, stream>>>(
      kind, count, length, ptr, n, out);
  return static_cast<int>(cudaGetLastError());
}
