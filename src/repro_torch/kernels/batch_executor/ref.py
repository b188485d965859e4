"""The plain version of kernel E (``csrc/fused_window.cu``): the port's
copy of the reference's numpy oracle (``repro.kernels.batch_executor.
ref``), which defines the fused batch executor's per-op contract bit
for bit.

``fused_window_ref`` executes one KN window of the batched data plane
-- reads and staged writes against an ArrayDAC-backed cache -- as a
sequential per-op state machine over dense per-key arrays, exactly
mirroring the scalar semantics of ``core.dac`` (Table 3 / Eq. 1 of the
paper):

  * value hit:      count += 1, recency stamp = clock++
  * shortcut hit:   count += 1, live-count histogram update, then the
                    Eq. 1 promotion decision; a promotion removes the
                    shortcut and inserts the value with the full
                    demote-LRU-values / evict-LFU-shortcuts make-space
                    loop
  * predicted miss: resolved against the window's prefetched probe
                    results (``pm_ptr``); a found key fills exactly as
                    ``fill_after_miss`` (value entry when it fits for
                    free, else a shortcut via make-space)
  * write:          the log plane is staged ahead of the window, so a
                    write is ``fill_after_write(segment_cached=True)``:
                    remove the prior entry, insert a value entry when
                    it fits for free, else a shortcut via make-space

The LRU victim is argmin (stamp, key) over live value entries and the
LFU victim argmin (count, key) over live shortcuts, which equals what
the cache's lazy heaps pop (stamps are unique and monotone; heap records
refresh on staleness). Here each is a scan over the slots, O(S) an
eviction; the kernel keeps two min-trees instead.

Truncation contract: the machine stops *before* the first op it cannot
prove on the device and returns how far it got (``n_exec``) plus a
reason code; the caller replays the residual through the host's exact
per-op machinery. Cut triggers:

  CUT_SEGCACHE   a kind-0 read whose key may live in the KN's segment
                 cache (in it at window start, or written earlier in
                 this batch) -- the segcache fill path stays on host
  CUT_PREFETCH   a kind-0 read with no provably-fresh prefetch (probe
                 bucket dirtied since batch start): needs a live index
                 lookup
  CUT_SPILL      an Eq. 1 decision whose victim set spills past the
                 count histogram (a needed victim has count >=
                 CNT_HIST_MAX): needs the exact heap peek
  CUT_EMA        an Eq. 1 decision after an in-window miss: the miss
                 RT EMA moved, so the precomputed promote threshold
                 table is stale
  CUT_TABLE      an Eq. 1 decision whose candidate count exceeds the
                 threshold table's range and whose victim sum is not
                 provably below the table's last row

The promote threshold table (``build_promote_table``) discretizes
Eq. 1's float comparison ``count * avg_shortcut_hit_rts >= victim_sum
* avg_miss_rts`` into exact integer rows: row c holds the largest
victim sum that still promotes a candidate of count c, evaluated in
float64 exactly as the reference -- so the device compares integers
and can never diverge by a rounding flip.
"""

from __future__ import annotations

import numpy as np

from ...core.dac import CNT_HIST_MAX, SHORTCUT_BYTES, VALUE_OVERHEAD_BYTES

# op codes of a window entry
OP_READ, OP_WRITE = 0, 1

# per-op event codes of the executed prefix
EV_VALUE_HIT = 0
EV_SHORTCUT_HIT = 1
EV_PROMOTE = 2          # shortcut hit whose Eq. 1 decision promoted
EV_MISS_FILL = 3        # prefetch-resolved miss, filled (EMA noted)
EV_MISS_ABSENT = 4      # prefetch says absent: index traversal only
EV_WRITE = 5

# truncation reason codes (0 = ran to the end of the window)
CUT_NONE = 0
CUT_SEGCACHE = 1
CUT_PREFETCH = 2
CUT_SPILL = 3
CUT_EMA = 4
CUT_TABLE = 5

# prefetch sentinel values (pm_ptr)
PM_INVALID = -2         # no provably-fresh prefetch: cut on touch
PM_ABSENT = -1          # index probe proved the key absent

# promote threshold table length (count axis); candidates with count
# >= TABLE_N fall back to the last row's sufficiency check or cut
TABLE_N = 4096

# register indices of the packed scalar state
R_USED, R_CLOCK, R_ZSHORT, R_NVALS, R_NSHORT, R_EMA_DIRTY, \
    R_DEMOTIONS, R_EVICTIONS = range(8)
NUM_REGS = 8


def build_promote_table(avg_miss_rts: float,
                        avg_shortcut_hit_rts: float = 1.0,
                        n: int = TABLE_N) -> np.ndarray:
    """Row c = the largest integer victim sum v with ``c * ashr >=
    v * amr`` under float64 arithmetic (-1 if even v=0 fails; it
    cannot for c >= 0 and amr >= 0).  Rows are nondecreasing in c, so
    ``vsum <= table[min(c, n-1)]`` is exact for c < n and a sufficient
    promote condition for c >= n."""
    c = np.arange(n, dtype=np.float64) * float(avg_shortcut_hit_rts)
    amr = float(avg_miss_rts)
    if amr <= 0.0:
        return np.full(n, np.iinfo(np.int32).max // 2, np.int32)
    v0 = np.floor(c / amr)
    # float64 division can land one off the exact comparison boundary:
    # test the neighborhood with the reference's own product rounding
    best = np.full(n, -1.0)
    for d in (-2.0, -1.0, 0.0, 1.0, 2.0):
        v = np.maximum(v0 + d, 0.0)
        ok = c >= v * amr
        best = np.where(ok, np.maximum(best, v), best)
    out = np.minimum(best, np.iinfo(np.int32).max // 2)
    return out.astype(np.int32)


def init_state(kind, count, stamp, length, ptr, hist, used, clock,
               zshort, nvals, nshort):
    """Pack host cache arrays into the executor's state tuple (copies;
    int32 throughout -- callers guard the ranges)."""
    n = kind.shape[0]
    regs = np.zeros(NUM_REGS, np.int32)
    regs[R_USED] = used
    regs[R_CLOCK] = clock
    regs[R_ZSHORT] = zshort
    regs[R_NVALS] = nvals
    regs[R_NSHORT] = nshort
    return (np.asarray(kind, np.int32).copy(),
            np.asarray(count, np.int32).copy(),
            np.asarray(stamp, np.int32).copy(),
            np.asarray(length, np.int32).copy(),
            np.asarray(ptr, np.int32).copy(),
            np.zeros(n, np.int32),                  # wrote-this-batch
            np.asarray(hist, np.int32).copy(),
            regs)


class _S:
    """Mutable view over one state tuple (reference machine only)."""

    __slots__ = ("kind", "count", "stamp", "length", "ptr", "wrote",
                 "hist", "regs", "cap")

    def __init__(self, state, cap):
        (self.kind, self.count, self.stamp, self.length, self.ptr,
         self.wrote, self.hist, self.regs) = state
        self.cap = int(cap)

    def tuple(self):
        return (self.kind, self.count, self.stamp, self.length,
                self.ptr, self.wrote, self.hist, self.regs)


def _lru_victim(s: _S):
    """argmin (stamp, key) over live value entries (== lazy-heap pop)."""
    ks = np.flatnonzero(s.kind == 2)
    st = s.stamp[ks]
    m = st.min()
    return int(ks[st == m].min())


def _lfu_victim(s: _S):
    """argmin (count, key) over live shortcuts (== lazy-heap pop)."""
    ks = np.flatnonzero(s.kind == 1)
    ct = s.count[ks]
    m = ct.min()
    return int(ks[ct == m].min())


def _make_space(s: _S, need: int) -> None:
    """``ArrayDAC._make_space``: demote LRU values (reinserting each as
    a shortcut when that still leaves room), then evict LFU shortcuts."""
    r = s.regs
    while r[R_USED] + need > s.cap and r[R_NVALS] > 0:
        v = _lru_victim(s)
        r[R_USED] -= s.length[v] + VALUE_OVERHEAD_BYTES
        r[R_NVALS] -= 1
        s.kind[v] = 0
        r[R_DEMOTIONS] += 1
        if r[R_USED] + SHORTCUT_BYTES + need <= s.cap:
            cv = int(s.count[v])
            s.kind[v] = 1
            r[R_USED] += SHORTCUT_BYTES
            r[R_NSHORT] += 1
            if cv == 0:
                r[R_ZSHORT] += 1
            s.hist[min(cv, CNT_HIST_MAX)] += 1
    while r[R_USED] + need > s.cap and r[R_NSHORT] > 0:
        v = _lfu_victim(s)
        cv = int(s.count[v])
        s.kind[v] = 0
        r[R_USED] -= SHORTCUT_BYTES
        r[R_NSHORT] -= 1
        if cv == 0:
            r[R_ZSHORT] -= 1
        s.hist[min(cv, CNT_HIST_MAX)] -= 1
        r[R_EVICTIONS] += 1


def _insert_value(s: _S, k: int, ptr: int, length: int, count: int,
                  prechecked: bool) -> None:
    """``ArrayDAC._insert_value`` for an absent key: make space, insert
    the value entry, falling back to a shortcut when it still does not
    fit.  ``prechecked`` skips make-space (the caller proved the fit,
    as fill_after_miss/_write do before choosing this path)."""
    r = s.regs
    need = length + VALUE_OVERHEAD_BYTES
    if not prechecked:
        _make_space(s, need)
    if r[R_USED] + need > s.cap:
        _insert_shortcut(s, k, ptr, length, count)
        return
    s.kind[k] = 2
    s.ptr[k] = ptr
    s.length[k] = length
    s.count[k] = count
    s.stamp[k] = r[R_CLOCK]
    r[R_CLOCK] += 1
    r[R_USED] += need
    r[R_NVALS] += 1


def _insert_shortcut(s: _S, k: int, ptr: int, length: int,
                     count: int) -> None:
    r = s.regs
    _make_space(s, SHORTCUT_BYTES)
    if r[R_USED] + SHORTCUT_BYTES > s.cap:
        return          # cache smaller than one entry: degenerate, skip
    s.kind[k] = 1
    s.ptr[k] = ptr
    s.length[k] = length
    s.count[k] = count
    r[R_USED] += SHORTCUT_BYTES
    r[R_NSHORT] += 1
    if count == 0:
        r[R_ZSHORT] += 1
    s.hist[min(count, CNT_HIST_MAX)] += 1


def _remove(s: _S, k: int) -> int:
    """Remove any prior entry for k; returns its count (0 if absent)."""
    r = s.regs
    kd = int(s.kind[k])
    if kd == 0:
        return 0
    c = int(s.count[k])
    if kd == 2:
        r[R_USED] -= s.length[k] + VALUE_OVERHEAD_BYTES
        r[R_NVALS] -= 1
    else:
        r[R_USED] -= SHORTCUT_BYTES
        r[R_NSHORT] -= 1
        if c == 0:
            r[R_ZSHORT] -= 1
        s.hist[min(c, CNT_HIST_MAX)] -= 1
    s.kind[k] = 0
    return c


def fused_window_ref(state, ops, keys, wptr, pm_ptr, pm_len, seg0, n,
                     cap, write_bytes, vmax):
    """Run up to ``n`` window ops; returns ``(n_exec, state', events,
    out_ptr, cut_reason)``.  State arrays are copied (functional).

    events/out_ptr are (len(ops),) int32, meaningful for the executed
    prefix [0, n_exec); out_ptr holds the heap pointer a read resolved
    to (-1 for a proven-absent miss) and the staged pointer a write
    installed."""
    s = _S(tuple(a.copy() for a in state), cap)
    r = s.regs
    w = len(ops)
    events = np.zeros(w, np.int32)
    out_ptr = np.full(w, -1, np.int32)
    vbb = int(write_bytes) + VALUE_OVERHEAD_BYTES
    cut = CUT_NONE
    i = 0
    while i < int(n):
        k = int(keys[i])
        if ops[i] == OP_WRITE:
            p = int(wptr[i])
            cpri = _remove(s, k)
            if r[R_USED] + vbb <= s.cap:
                _insert_value(s, k, p, int(write_bytes), cpri,
                              prechecked=True)
            else:
                _insert_shortcut(s, k, p, int(write_bytes), cpri)
            s.wrote[k] = 1
            events[i] = EV_WRITE
            out_ptr[i] = p
            i += 1
            continue
        kd = int(s.kind[k])
        if kd == 2:
            s.count[k] += 1
            s.stamp[k] = r[R_CLOCK]
            r[R_CLOCK] += 1
            events[i] = EV_VALUE_HIT
            out_ptr[i] = s.ptr[k]
            i += 1
            continue
        if kd == 1:
            c = int(s.count[k]) + 1
            ln = int(s.length[k])
            cut, promote = _promote_decision_precheck(s, c, ln, vmax)
            if cut:
                break
            s.count[k] = c
            if c == 1:
                r[R_ZSHORT] -= 1
            s.hist[min(c - 1, CNT_HIST_MAX)] -= 1
            s.hist[min(c, CNT_HIST_MAX)] += 1
            out_ptr[i] = s.ptr[k]
            if promote:
                p, cnt = int(s.ptr[k]), int(s.count[k])
                s.kind[k] = 0
                r[R_USED] -= SHORTCUT_BYTES
                r[R_NSHORT] -= 1
                if cnt == 0:
                    r[R_ZSHORT] -= 1
                s.hist[min(cnt, CNT_HIST_MAX)] -= 1
                _insert_value(s, k, p, ln, cnt, prechecked=False)
                events[i] = EV_PROMOTE
            else:
                events[i] = EV_SHORTCUT_HIT
            i += 1
            continue
        # kind-0 read: segcache-backed and unprefetched keys stay host
        if seg0[i] or s.wrote[k]:
            cut = CUT_SEGCACHE
            break
        pp = int(pm_ptr[i])
        if pp == PM_INVALID:
            cut = CUT_PREFETCH
            break
        if pp == PM_ABSENT:
            events[i] = EV_MISS_ABSENT
            out_ptr[i] = -1
            i += 1
            continue
        # fill_after_miss(k, pp, pm_len[i]) with count=1; the miss RT
        # moves the EMA, so later Eq. 1 table decisions must cut
        r[R_EMA_DIRTY] = 1
        ln = int(pm_len[i])
        if r[R_USED] + ln + VALUE_OVERHEAD_BYTES <= s.cap:
            _insert_value(s, k, pp, ln, 1, prechecked=True)
        else:
            _insert_shortcut(s, k, pp, ln, 1)
        events[i] = EV_MISS_FILL
        out_ptr[i] = pp
        i += 1
    return i, s.tuple(), events, out_ptr, cut


def _promote_decision_precheck(s: _S, c: int, ln: int, vmax):
    """The Eq. 1 decision evaluated *as if* the hit bookkeeping had
    been applied (count -> c, histogram bucket moved), without mutating
    state -- a cut must leave the op untouched for the host replay.
    Histogram-dependent quantities shift accordingly: the candidate's
    entry sits at bucket min(c, CNT_HIST_MAX) and the zero-shortcut
    pool has lost the candidate when c == 1."""
    r = s.regs
    need = ln + VALUE_OVERHEAD_BYTES - SHORTCUT_BYTES
    free = s.cap - int(r[R_USED])
    if free >= need:
        return CUT_NONE, True
    n_evict = -(-(need - free) // SHORTCUT_BYTES)
    zshort = int(r[R_ZSHORT]) - (1 if c == 1 else 0)
    if zshort >= n_evict:
        return CUT_NONE, True
    if int(r[R_NSHORT]) - 1 < n_evict:
        return CUT_NONE, False
    if r[R_EMA_DIRTY]:
        return CUT_EMA, False
    spill, vsum = _victim_sum_shifted(s, n_evict, c)
    if spill:
        return CUT_SPILL, False
    tn = vmax.shape[0]
    if c >= tn:
        if vsum <= int(vmax[tn - 1]):
            return CUT_NONE, True
        return CUT_TABLE, False
    return CUT_NONE, vsum <= int(vmax[c])


def _victim_sum_shifted(s: _S, n_evict: int, c: int):
    """``_victim_sum`` over the histogram as it would look after the
    hit bookkeeping: the candidate moved from bucket min(c-1, max) to
    min(c, max), and the scan excludes one entry at bucket c.  Net
    effect on the scanned range [0, CNT_HIST_MAX): one entry removed
    at bucket min(c-1, CNT_HIST_MAX-1) when c-1 fits the range."""
    got = 0
    total = 0
    excl = c - 1 if c - 1 < CNT_HIST_MAX else None
    for b in range(CNT_HIST_MAX):
        m = int(s.hist[b])
        if b == excl:
            m -= 1
        if m <= 0:
            continue
        take = m if m <= n_evict - got else n_evict - got
        total += take * b
        got += take
        if got == n_evict:
            return False, total
    return True, 0


def fused_windows_ref(jobs):
    """The plain version of ``fused_windows``: ``fused_window_ref`` on each
    job's (state, window (six arrays), n, cap, write_bytes, vmax) in
    turn. The jobs' states are distinct, so the order cannot matter."""
    return [fused_window_ref(state, *window, n, cap, wb, vmax)
            for state, window, n, cap, wb, vmax in jobs]


def dirty_slots_ref(before, after) -> np.ndarray:
    """The plain version of a launch's dirty record: every slot where any
    of the six per-slot arrays (kind, count, stamp, length, ptr, wrote)
    differs between ``before`` and ``after``, ascending."""
    changed = np.zeros(before[0].shape[0], bool)
    for a, b in zip(before[:6], after[:6], strict=True):
        changed |= a != b
    return np.flatnonzero(changed)


def guard_maxima_ref(kind, count, ptr, length, nslots: int) -> np.ndarray:
    """The plain version of ``guard_maxima``: (3,) int32, the largest
    count, ptr and length over the live slots (kind != 0) of [0, nslots),
    -2^31 where none is live."""
    live = kind[:nslots] != 0
    lo = np.iinfo(np.int32).min
    return np.array([a[:nslots][live].max(initial=lo)
                     for a in (count, ptr, length)], np.int32)
