// Kernel 4: the planned cache-transition space machine.
//
// Replaces the Pallas kernel
// src/repro/kernels/cache_transition/cache_transition.py:cache_transition
// (_transition_kernel), the device twin of the host planner
// core/transition.py:plan_dac_window. Per op row (code, rm, vb, zhit,
// zfill) it decides an Eq. 1 fast-path promote or a fill's value-vs-shortcut
// class against the running occupancy u, and makes space by consuming a
// frozen queue of LRU victims, of which only the final one of a make-space
// may re-insert as a 32-byte shortcut. Outputs per op: dec, victims
// consumed so far, u after the op.
//
// Every op depends on the (u, z, victim cursor) the ops before it leave.
// The earlier design carried that state on one thread at about 270 cycles
// an op, even over neutral rows: about 100 instructions an op, most of them
// on the dependent chain, issued by one warp with nothing to overlap them.
// A leaner serial loop (the decode below, int32) still took about 165
// cycles an op, so this design scans with a whole warp:
// - Decoding does not depend on the state: the block decodes a tile of
//   rows into shared memory as (thr, d1, d0, zd, code). An op's test is
//   u - thr <= 0 (a fill's value fits, or Eq. 1's free space) or, for a
//   promote, also u - thr <= 32 z: Eq. 1's n_evict = -floor((room - need)
//   / 32) needs no division. The occupancy after its insert is u + d1 or
//   u + d0. u is kept less the capacity, z as 32 z.
// - A make-space stops at the first victim after which the insert fits,
//   and only that one may re-insert a shortcut (once u + 32 + ins <= cap,
//   u + ins <= cap ends the loop). So it consumes the least k >= 1 victims
//   whose sum reaches u + ins - cap, then adds 32 if it still fits. The
//   block stages the inclusive prefix sums of the queue from the cursor
//   (a tile of them, int64) in shared memory; where they are
//   nondecreasing (no negative victim in the tile), k is found by a
//   galloping search. A make-space that runs past the staged tile stops
//   the scan before its op; the block stages the queue again from the
//   cursor and the scan goes on from that op.
// - Warp 0 scans 32 ops a round, one a lane, in int32: each lane guesses
//   its incoming state as the round's state plus the warp's exclusive
//   prefix sum of the changes the ops before it make at their own
//   guesses, and the round repeats that until no guess moves. Lane 0's
//   guess is always exact, and a lane whose predecessors are exact is
//   exact at the next pass, so the fixed point is the exact scan; it takes
//   as many passes as there are lanes whose change depends on state the
//   round started without (at most 33; a neutral round takes one). int32 holds where the block's maxima over the tile (of |rm|,
//   |vb|, |zhit|, |zfill| and the staged victims) bound every value of
//   the exact scan, which every window of the KN path meets.
// - Otherwise (a negative victim in the staged tile, values near int32's
//   range, or one make-space longer than a tile) thread 0 scans in int64,
//   decoding each row from device memory and walking victims one by one
//   where the staged tile cannot serve: exact, and never taken by a real
//   queue (a victim's gross bytes are its length + 40).
// - Outputs go to shared memory and are written back coalesced per tile.
// Arithmetic is 64-bit, so nothing wraps before the int32 outputs; the
// wrapper refuses a capacity whose largest insert would not fit them, and
// a starting state outside int32.
//
// Bound on an H100 SXM: latency, not bytes or operations. Per op 32 B of
// row read and 12 B of outputs written, plus 4 B per victim consumed, over
// 3.35 TB/s: about 0.007 us for a 512-op window. The scan's rounds are
// chains of warp shuffles and compares: a few hundred cycles a pass.
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kRowTile = 512;      // op rows staged per tile
constexpr int kQueueTile = 2048;   // victims whose prefix sums are staged
constexpr int kPer = kQueueTile / kThreads;
constexpr int64_t kShortcut = 32;  // SHORTCUT_BYTES
constexpr int64_t kNarrow = int64_t{1} << 29;  // int32 scan: |values| below
constexpr unsigned kFull = 0xFFFFFFFFu;

// One op as the scan reads it. pred is the op's test (a fill's "the value
// fits", a promote's Eq. 1): u - thr <= 0, or for a promote also
// u - thr <= 32 z after its zero-count hit. The occupancy after the op's
// insert, before any make-space, is u + (pred ? d1 : d0). thr is kept
// less the capacity, as the scan keeps u.
struct alignas(16) Op {
  int64_t thr, d1, d0;
  int32_t zd;    // a promote's zhit, a fill's zfill, else 0
  int32_t code;  // 1 promote, 2 fill, 3 delete, else neutral (0)
};

// Row i decoded; mag gets the largest |rm|, |vb| it uses.
__device__ __forceinline__ Op decode(const int4* ops, int64_t i,
                                     int64_t& mag) {
  const int4 r = ops[2 * i];  // lanes 0-3: code, rm, vb, zhit
  const int32_t zfill = reinterpret_cast<const int32_t*>(ops)[8 * i + 4];
  const int64_t rm = r.y, vb = r.z;
  Op op;
  op.code = (r.x >= 1 && r.x <= 3) ? r.x : 0;
  op.thr = 0;
  op.d1 = op.d0 = 0;
  op.zd = 0;
  if (op.code == 1) {                    // promote (Eq. 1)
    op.thr = kShortcut - vb;
    op.d1 = vb - kShortcut;
    op.zd = r.w;
  } else if (op.code == 2) {             // fill
    op.thr = rm - vb;
    op.d1 = vb - rm;
    op.d0 = kShortcut - rm;
    op.zd = zfill;
  } else if (op.code == 3) {             // delete
    op.d1 = op.d0 = -rm;
  }
  if (op.code != 0) mag = max(mag, max(rm < 0 ? -rm : rm, vb < 0 ? -vb : vb));
  return op;
}

__device__ __forceinline__ int64_t warp_max(int64_t x) {
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) x = max(x, __shfl_xor_sync(kFull, x, d));
  return x;
}

// What the block staged: whether the queue tile has no negative victim,
// and block-wide maxima of the rows' |rm|, |vb|, of |zd|, and of a victim.
struct Staged {
  bool mono;
  int64_t mag, zd, victim;
};

// Inclusive prefix sums of victims[q0, q0 + qn) into pre[1..qn], pre[0] =
// 0, and the block-wide maxima of this thread's mag and zd. Every thread
// calls it.
__device__ Staged stage_queue(const int32_t* __restrict__ victims,
                              int64_t q0, int qn, int64_t mag, int64_t zd,
                              int64_t* pre, int64_t* warp_sums,
                              int64_t (*warp_max3)[3]) {
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  int64_t v[kPer];
  int64_t run = 0, top = 0;
  bool neg = false;
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int idx = tid * kPer + i;
    const int64_t x = idx < qn ? victims[q0 + idx] : 0;
    neg |= x < 0;
    top = max(top, x);
    run += x;
    v[i] = run;
  }
  int64_t scan = run;  // inclusive scan of the threads' sums in the warp
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int64_t y = __shfl_up_sync(kFull, scan, d);
    if (lane >= d) scan += y;
  }
  mag = warp_max(mag);
  zd = warp_max(zd);
  top = warp_max(top);
  if (lane == 31) warp_sums[warp] = scan;
  if (lane == 0) {
    warp_max3[warp][0] = mag;
    warp_max3[warp][1] = zd;
    warp_max3[warp][2] = top;
  }
  Staged st;
  st.mono = !__syncthreads_or(neg);
  st.mag = st.zd = st.victim = 0;
  int64_t off = scan - run;
  for (int w = 0; w < warp; ++w) off += warp_sums[w];
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    st.mag = max(st.mag, warp_max3[w][0]);
    st.zd = max(st.zd, warp_max3[w][1]);
    st.victim = max(st.victim, warp_max3[w][2]);
  }
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int idx = tid * kPer + i;
    if (idx < qn) pre[idx + 1] = off + v[i];
  }
  if (tid == 0) pre[0] = 0;
  return st;
}

// A make-space for an op whose occupancy less the capacity is x > 0 after
// its insert, at cursor q0 + k (k <= qn), by a search of the staged prefix
// sums. Returns false, changing nothing, where they cannot hold it while
// more victims follow; else consumes the victims it needs, or all that
// are staged, and moves k past them.
__device__ __forceinline__ bool make_space(int64_t& x, int& k,
                                           const int64_t* __restrict__ pre,
                                           int qn, bool more) {
  const int64_t target = pre[k] + x;
  if (pre[qn] < target && more) return false;
  int hi;
  if (pre[qn] < target) {
    hi = qn;                                      // the queue runs out
  } else if (pre[k + 1] >= target) {
    hi = k + 1;                                   // one victim
  } else {                                        // gallop, then bisect
    int lo = k + 1, step = 1;
    hi = qn;
    while (lo + step < hi) {
      if (pre[lo + step] >= target) {
        hi = lo + step;
        break;
      }
      lo += step;
      step <<= 1;
    }
    while (hi - lo > 1) {
      const int mid = (lo + hi) >> 1;
      if (pre[mid] >= target) hi = mid; else lo = mid;
    }
  }
  x -= pre[hi] - pre[k];
  if (x + kShortcut <= 0) x += kShortcut;
  k = hi;
  return true;
}

__device__ __forceinline__ int32_t wrap_add(int32_t a, int32_t b) {
  return static_cast<int32_t>(static_cast<uint32_t>(a) +
                              static_cast<uint32_t>(b));
}

__device__ __forceinline__ int32_t wrap_sub(int32_t a, int32_t b) {
  return static_cast<int32_t>(static_cast<uint32_t>(a) -
                              static_cast<uint32_t>(b));
}

// The scan state of the int32 scan: occupancy less the capacity, 32 x the
// zero count, the cursor less q0.
struct State {
  int32_t uh, zz, k;
};

// One op at state g, in int32 (wrapping: a lane's state may be a wrong
// guess, whose result is discarded): its change of state, its decision,
// and whether its make-space needs the queue staged again (`brk`).
__device__ __forceinline__ State step(const int4 r, const State g,
                                      const int64_t* __restrict__ pre,
                                      int64_t q0, int qn, bool more,
                                      int64_t nv, bool& dec, bool& brk) {
  const int code = r.w & 3;
  const int32_t zs = (r.w >> 2) * static_cast<int32_t>(kShortcut);
  const bool pro = code == 1;
  const int32_t z1 = pro ? wrap_sub(g.zz, zs) : g.zz;
  const int32_t w = wrap_sub(g.uh, r.x);
  const bool pred = w <= 0 || (pro && w <= z1);
  int32_t u2 = wrap_add(g.uh, pred ? r.y : r.z);
  int k = min(max(g.k, 0), qn);           // in range whatever the guess
  brk = false;
  if (u2 > 0 && q0 + k < nv) {                    // make space
    int64_t x = u2;
    brk = !make_space(x, k, pre, qn, more);
    u2 = static_cast<int32_t>(x);
  }
  dec = pred && (pro || code == 2);
  State d;
  d.uh = wrap_sub(u2, g.uh);
  d.zz = wrap_sub((code == 2 && !pred) ? wrap_add(z1, zs) : z1, g.zz);
  d.k = wrap_sub(k, g.k);
  return d;
}

__device__ __forceinline__ int32_t warp_exclusive_sum(int32_t x, int lane) {
  int32_t s = x;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int32_t y = __shfl_up_sync(kFull, s, d);
    if (lane >= d) s = wrap_add(s, y);
  }
  return wrap_sub(s, x);
}

// The scan of ops [start, count) of the staged tile by warp 0, in int32,
// from the packed rows in shared memory, where the block's maxima bound
// every value of the exact scan below kNarrow. Each round takes 32 ops, one
// a lane: every lane guesses its state as the round's state plus the sum
// of the changes the ops before it make at their guesses, and the guesses
// are formed again until none moves. Lane 0's guess is exact; once the
// lanes before a lane are exact, its next guess is; so the fixed point is
// the exact scan, reached in as many passes as there are lanes whose
// change depends on a state the round started without (at most 33). Every lane of warp 0 calls it with
// the same state (uh = u - cap, zz = 32 z, vi == q0) and gets the state
// after the scan. Returns the first op not scanned: count, or an op whose
// make-space needs the queue staged again from the cursor, or more than a
// tile (then `wide` is set: the wide scan takes that op).
__device__ int scan_narrow(const int4* __restrict__ rec,
                           const int64_t* __restrict__ pre,
                           int4* __restrict__ out, int start, int count,
                           int64_t& uh_io, int64_t& zz_io, int64_t& vi,
                           int64_t q0, int qn, bool more, int64_t cap,
                           int64_t nv, bool& wide) {
  const int lane = threadIdx.x & 31;
  State s{static_cast<int32_t>(uh_io), static_cast<int32_t>(zz_io), 0};
  const uint32_t cap32 = static_cast<uint32_t>(cap);
  int j0 = start;
  bool stop = false;
  while (j0 < count && !stop) {
    const int m = min(32, count - j0);
    const int4 r = lane < m ? rec[j0 + lane] : make_int4(0, 0, 0, 0);
    State g = s, d;
    bool dec, brk;
    for (;;) {
      d = step(r, g, pre, q0, qn, more, nv, dec, brk);
      State ng;
      ng.uh = wrap_add(s.uh, warp_exclusive_sum(d.uh, lane));
      ng.zz = wrap_add(s.zz, warp_exclusive_sum(d.zz, lane));
      ng.k = wrap_add(s.k, warp_exclusive_sum(d.k, lane));
      const bool moved =
          lane < m && (ng.uh != g.uh || ng.zz != g.zz || ng.k != g.k);
      g = ng;
      if (!__any_sync(kFull, moved)) break;
    }
    // every guess is exact: commit the lanes before the first that must
    // stop
    const unsigned bm = __ballot_sync(kFull, lane < m && brk);
    const int c = bm ? __ffs(bm) - 1 : m;
    const State post{wrap_add(g.uh, d.uh), wrap_add(g.zz, d.zz),
                     wrap_add(g.k, d.k)};
    if (lane < c)
      out[j0 + lane] = make_int4(
          dec, static_cast<int32_t>(q0 + post.k),
          static_cast<int32_t>(static_cast<uint32_t>(post.uh) + cap32), 0);
    if (c > 0) {
      s.uh = __shfl_sync(kFull, post.uh, c - 1);
      s.zz = __shfl_sync(kFull, post.zz, c - 1);
      s.k = __shfl_sync(kFull, post.k, c - 1);
    }
    j0 += c;
    if (bm) {
      stop = true;
      wide = s.k == 0;             // more than a tile from the cursor
    }
  }
  uh_io = s.uh;
  zz_io = s.zz;
  vi = q0 + s.k;
  return j0;
}

// The same scan in int64 for any tile by thread 0, decoding each row from
// device memory; it walks victims one by one where the staged tile has a
// negative victim or cannot serve a make-space from the cursor.
__device__ int scan_wide(const int4* __restrict__ rows,
                         const int64_t* __restrict__ pre,
                         int4* __restrict__ out, int64_t base, int start,
                         int count, int64_t& uh, int64_t& zz, int64_t& vi,
                         int64_t q0, int qn, bool mono, bool more,
                         int64_t cap, const int32_t* __restrict__ victims,
                         int64_t nv) {
  int64_t unused = 0;
  int j = start;
  for (; j < count; ++j) {
    const Op op = decode(rows, base + j, unused);
    const int64_t zs = int64_t{op.zd} * kShortcut;
    const int64_t z1 = op.code == 1 ? zz - zs : zz;
    const int64_t w = uh - op.thr;
    const bool pred = w <= 0 || (op.code == 1 && w <= z1);
    int64_t x = uh + (pred ? op.d1 : op.d0);
    if (x > 0 && vi < nv) {                       // make space
      if (mono) {
        int k = static_cast<int>(min(vi - q0, int64_t{qn + 1}));
        if (k > qn || !make_space(x, k, pre, qn, more)) {
          if (vi > q0) break;      // stage the queue from the cursor
        } else {
          vi = q0 + k;
        }
      }
      while (x > 0 && vi < nv) {                  // one by one
        x -= victims[vi];
        ++vi;
        if (x + kShortcut <= 0) x += kShortcut;
      }
    }
    uh = x;
    zz = (op.code == 2 && !pred) ? z1 + zs : z1;
    out[j] = make_int4(pred && (op.code == 1 || op.code == 2),
                       static_cast<int32_t>(vi),
                       static_cast<int32_t>(uh + cap), 0);
  }
  return j;
}

__device__ __forceinline__ int64_t abs64(int64_t x) { return x < 0 ? -x : x; }

__global__ void __launch_bounds__(kThreads)
    cache_transition_kernel(const int4* __restrict__ ops, int64_t n,
                            const int32_t* __restrict__ victims, int64_t nv,
                            int64_t used0, int64_t z0, int64_t cap,
                            int32_t* __restrict__ dec,
                            int32_t* __restrict__ nvic,
                            int32_t* __restrict__ used) {
  __shared__ int4 s_rec[kRowTile + 1];       // +1: the scan reads one ahead
  __shared__ int64_t s_pre[kQueueTile + 1];  // prefix sums from the cursor
  __shared__ int64_t s_warp[kWarps];
  __shared__ int64_t s_max[kWarps][3];
  __shared__ int4 s_out[kRowTile];           // (dec, nvic, used, -) per op
  __shared__ int64_t s_vi;
  __shared__ int s_stop;
  const int tid = threadIdx.x;
  // the scan's state, in thread 0: occupancy less the capacity, 32 x the
  // zero count, the cursor; and whether the next scan must be wide
  int64_t uh = used0 - cap, zz = z0 * kShortcut, vi = 0;
  bool wide = false;
  int64_t q0 = 0;                     // the cursor, where the queue is staged
  int64_t base = 0;                   // the row tile
  int start = 0;                      // its first op not yet scanned
  int64_t mag = 0, zd = 0;            // this thread's rows' maxima
  while (base < n) {
    const int count = n - base < kRowTile ? static_cast<int>(n - base)
                                          : kRowTile;
    if (start == 0) {
      mag = zd = 0;
      for (int i = tid; i < count; i += kThreads) {
        const Op op = decode(ops, base + i, mag);
        zd = max(zd, abs64(op.zd));
        // packed for the int32 scan (exact where it runs): thr, d1, d0,
        // zd << 2 | code
        s_rec[i] = make_int4(static_cast<int32_t>(op.thr),
                             static_cast<int32_t>(op.d1),
                             static_cast<int32_t>(op.d0),
                             static_cast<int32_t>(
                                 (static_cast<uint32_t>(op.zd) << 2) |
                                 static_cast<uint32_t>(op.code)));
      }
    }
    const int qn = nv - q0 < kQueueTile ? static_cast<int>(nv - q0)
                                        : kQueueTile;
    const Staged st = stage_queue(victims, q0, qn, mag, zd, s_pre, s_warp,
                                  s_max);
    const bool more = q0 + qn < nv;   // victims past the staged tile
    __syncthreads();
    if (tid < 32) {
      // int32 where every value of the exact scan stays below kNarrow:
      // |uh| grows by at most 2 mag + 64 an op and is at most victim + 32
      // after a make-space; 32 z by at most 32 zd an op. The state lives
      // in thread 0; warp 0 runs the int32 scan, thread 0 the int64 one.
      const int64_t ops_left = count - start;
      bool narrow = st.mono && !wide && abs64(uh) < kNarrow &&
                    abs64(zz) < kNarrow && st.mag < kNarrow &&
                    st.zd < kNarrow && st.victim < kNarrow;
      if (narrow) {
        const int64_t grow = 2 * st.mag + 2 * kShortcut;
        const int64_t bu = max(abs64(uh), st.victim + kShortcut) +
                           (ops_left + 1) * grow;
        const int64_t bz = abs64(zz) + (ops_left + 1) * kShortcut * st.zd;
        narrow = bu < kNarrow && bz < kNarrow;
      }
      narrow = __shfl_sync(kFull, narrow, 0);
      wide = false;
      int j = start;
      if (narrow) {
        uh = __shfl_sync(kFull, uh, 0);
        zz = __shfl_sync(kFull, zz, 0);
        j = scan_narrow(s_rec, s_pre, s_out, start, count, uh, zz, vi, q0,
                        qn, more, cap, nv, wide);
      } else if (tid == 0) {
        j = scan_wide(ops, s_pre, s_out, base, start, count, uh, zz, vi, q0,
                      qn, st.mono, more, cap, victims, nv);
      }
      if (tid == 0) {
        s_stop = j;
        s_vi = vi;
      }
    }
    __syncthreads();
    const int stop = s_stop;
    for (int i = start + tid; i < stop; i += kThreads) {
      const int4 o = s_out[i];
      dec[base + i] = o.x;
      nvic[base + i] = o.y;
      used[base + i] = o.z;
    }
    if (stop == count) {
      base += kRowTile;
      start = 0;
    } else {
      start = stop;
    }
    q0 = s_vi;
  }
}

}  // namespace

extern "C" int cache_transition_launch(const int32_t* ops, int64_t n,
                                       const int32_t* victims, int64_t nv,
                                       int64_t used0, int64_t z0, int64_t cap,
                                       int32_t* dec, int32_t* nvic,
                                       int32_t* used, cudaStream_t stream) {
  if (n <= 0) return 0;
  cache_transition_kernel<<<1, kThreads, 0, stream>>>(
      reinterpret_cast<const int4*>(ops), n, victims, nv, used0, z0, cap, dec,
      nvic, used);
  return static_cast<int>(cudaGetLastError());
}
