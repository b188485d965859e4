"""The disaggregated PM pool: ground truth for data + metadata.

Per the paper (Secs. 3.1-3.2, 4): the pool stores
  * the value log segments (values live *inside* log entries; the index
    points straight at them),
  * the CLHT metadata index,
  * the indirection table for selectively-replicated hot keys,
  * ownership/replication policy metadata (so failed KNs/RNs can rebuild
    their soft state).

This module is the port's copy of the reference's per-op pool
(python/numpy), behaviour for behaviour: the host ``NumpyCLHT`` is the
index's truth, which the scalar per-op paths read and write. The pool
also keeps ``index_dev``, a packed int32 copy of that index on its
device (``core.clht.CLHT``), equal to the host index row for row: the
rows the host index noted since the last batched read go to the card
before the next one, as one upload and one row scatter (the first read
uploads the whole table). ``index_lookup_batch`` then runs on the card:
the bucket hash, kernel A (``kernels.clht_probe``) over the primary
lines, and the chain walk for keys that missed a chained line. The
pool exposes *mechanics* only; timing and asynchrony belong to the
cluster, which is not ported yet.
"""

from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass, field

import numpy as np
import torch

from ..device import resolve_device
from ..kernels.clht_probe.ops import lookup_walk
from . import sanitize
from .clht import CLHT, LINE, LINK, SLOTS, NumpyCLHT
from .faults import CRASH_POINTS, KNCrash
from .log import PySegment
from .transition import (MERGE_PLAN_STATS, MIN_MERGE_PLAN_OPS,
                         plan_merge_window)

_I32_MAX = (1 << 31) - 1


def _check_int32(what: str, a: np.ndarray, lo: int = -1) -> None:
    """The card's index holds int32: every key or pointer in it is -1
    (empty) or in [0, 2^31), and a key read from it lies in int32's
    range (``lo`` -2^31). Anything else raises; nothing falls back to
    the host walk."""
    if a.size and (int(a.min()) < lo or int(a.max()) > _I32_MAX):
        raise ValueError(f"{what}: values outside [{lo}, 2^31) cannot go "
                         f"to the card's int32 index")


def _pack_rows(index: NumpyCLHT, rows) -> np.ndarray:
    """The host index's ``rows`` as packed int32 bucket lines (keys,
    pointers, chain link, pad -1), checked for the int32 range."""
    k, p, nx = index.keys[rows], index.ptrs[rows], index.nxt[rows]
    _check_int32("index keys", k)
    _check_int32("index pointers", p)
    lines = np.full((k.shape[0], LINE), -1, np.int32)
    lines[:, :SLOTS] = k
    lines[:, SLOTS:LINK] = p
    lines[:, LINK] = nx
    return lines


@dataclass
class GCStats:
    segments_created: int = 0
    segments_collected: int = 0
    entries_merged: int = 0


@dataclass
class FencedWrite:
    """A DPM mutation rejected by the epoch fence: the caller presented
    a stale ownership generation (it lost the range since it captured
    the token -- the zombie-owner case under imperfect failure
    detection).  The write was a clean no-op: no heap row, no log
    entry, no index scatter, no accounting change.  Falsy, so callers
    that treat the result as a success flag fail closed; machine
    checkable via ``isinstance(r, FencedWrite)``."""
    kn: str
    op: str
    token: int | None
    current: int | None

    def __bool__(self) -> bool:
        return False


class DPMPool:
    def __init__(self, num_buckets: int = 1 << 18,
                 segment_capacity: int = 2048,
                 unmerged_threshold: int = 2,
                 vectorized: bool = True, device=None):
        # ``vectorized=False`` keeps the per-entry merge path -- the
        # oracle the batched merge plane is property-tested against
        self.vectorized = vectorized
        # opt-in per-epoch merge allowance: when set, merge_budget
        # debits it so a batched flush (or a stall storm) cannot merge
        # more per epoch than the DPM processors could; merge_all (the
        # synchronous reconfiguration/recovery merge) bypasses it.
        self.merge_allowance: int | None = None
        # (keys, buckets) sets updated by merges while tracking is on:
        # the batch engine uses them to spot prefetched index probes
        # that went stale mid-batch (key remapped / chain grew)
        self._dirty: tuple[set, set] | None = None
        self.index = NumpyCLHT(num_buckets)
        # the packed copy of ``index`` on the device, made at the first
        # batched read (core.clht.CLHT; see sync_index)
        self.device = resolve_device(device)
        self.index_dev: CLHT | None = None
        # value heap: ptr -> payload / length / owning segment
        self.heap_val: list = []
        self.heap_len: list[int] = []
        self.heap_seg: list[PySegment | None] = []
        # per-KN exclusive logs: active segment last
        self.segments: dict[str, list[PySegment]] = {}
        self.segment_capacity = segment_capacity
        self.unmerged_threshold = unmerged_threshold
        self.merge_backlog: deque[tuple[PySegment, int]] = deque()
        # wall-clock spent inside merge_budget/merge_all: the bench's
        # per-row merge wall-time share
        self.merge_wall_s = 0.0
        # exactly-once retry contract (the open-loop request plane):
        # request IDs ride inside durable log entries; this table maps a
        # *sealed* entry's request ID to its heap pointer, so a client
        # retry of an already-applied write deduplicates instead of
        # double-applying.  Derived state: recovery unregisters IDs
        # whose torn entries were discarded (the retry then applies
        # fresh -- still exactly once overall).
        self.req_index: dict[int, int] = {}
        # indirection table for replicated keys: key -> ptr  (CAS target)
        self.indirect: dict[int, int] = {}
        self._indirect_version = 0
        self._indirect_cache: tuple[int, np.ndarray] | None = None
        # durable policy metadata (ownership map snapshots, Sec. 3.5)
        self.policy_metadata: dict = {}
        self.gc = GCStats()
        # optional fault-injection plane (faults.FaultPlane); when armed,
        # the write/merge paths below raise KNCrash at named crash
        # points, leaving exactly the torn state a fail-stop would
        self.faults = None
        # epoch fence table (Sec. 3.5 under imperfect failure
        # detection): the current ownership generation per KN, published
        # by the cluster at every reconfiguration.  Every mutation entry
        # point validates the caller's token against it; stale writers
        # get a FencedWrite no-op recorded in ``fenced_writes``.
        self.fence: dict[str, int] = {}
        self.fenced_writes: list[FencedWrite] = []

    # ----- epoch fencing (zombie-owner protection) ---------------------------
    def publish_fences(self, fences: dict) -> None:
        """Install the ownership map's fence generations as the pool's
        authoritative fence table -- the 'fence word' a real DPM would
        keep next to each KN's log head.  For every KN whose generation
        changed, each of its segments records a watermark: entries
        appended from here on must carry the new generation, so a
        zombie write that somehow slipped past the fence is detectable
        forever after (``verify_integrity``).  KNs absent from the new
        table (failed / removed) are fenced at generation infinity:
        any token they still hold is stale.  Monotone per KN: a
        replayed stale ownership snapshot can never wind a fence back
        and re-validate a zombie's token."""
        for kn, gen in fences.items():
            old = self.fence.get(kn)
            if old is not None and gen <= old:
                continue
            for seg in self.segments.get(kn, ()):
                seg.gen_marks.append((len(seg.entries), gen))
            self.fence[kn] = gen
        for kn in [k for k in self.fence if k not in fences]:
            for seg in self.segments.get(kn, ()):
                seg.gen_marks.append((len(seg.entries),
                                      self.fence[kn] + 1))
            del self.fence[kn]

    def fence_token(self, kn: str) -> int | None:
        return self.fence.get(kn)

    def _check_fence(self, kn, token, op: str):
        """Validate a mutation's fence token.  Returns None when the
        write may proceed, or the FencedWrite no-op record (already
        logged in ``fenced_writes``) when the caller's generation is
        stale.  ``token=None`` marks a management-plane caller
        (reconfiguration, recovery, DPM processors, warm loads) --
        exempt from fencing, but under REPRO_SANITIZE a KN-context
        caller mutating fenced state without presenting a token is a
        fence *bypass* and trips OwnershipViolation at the store."""
        cur = self.fence.get(kn) if kn is not None else None
        if token is None:
            if sanitize.enabled() and cur is not None:
                ctx = sanitize.current()
                if ctx is not None and ctx != sanitize.MANAGEMENT:
                    raise sanitize.OwnershipViolation(
                        f"{op}: KN context {ctx!r} mutated fenced DPM "
                        f"state of {kn!r} without a fence token "
                        f"(fence bypass)")
            return None
        if cur is None or token != cur:
            rec = FencedWrite(kn=kn, op=op, token=token, current=cur)
            self.fenced_writes.append(rec)
            return rec
        return None

    def _gen_of(self, kn: str, token) -> int:
        """The generation to stamp on entries this write appends."""
        return token if token is not None else self.fence.get(kn, 0)

    # ----- value heap --------------------------------------------------------
    def alloc_value(self, value, length: int,
                    seg: PySegment | None = None) -> int:
        ptr = len(self.heap_val)
        self.heap_val.append(value)
        self.heap_len.append(length)
        self.heap_seg.append(seg)
        return ptr

    def read_value(self, ptr: int):
        return self.heap_val[ptr], self.heap_len[ptr]

    # ----- exclusive per-KN logs (one-sided writes) ---------------------------
    def new_segment(self, kn: str) -> PySegment:
        """A fresh segment for ``kn``, watermarked with its current
        fence generation (if fenced) so stale-generation entries are
        detectable from the segment's first row."""
        seg = PySegment(self.segment_capacity, kn)
        g = self.fence.get(kn)
        if g is not None:
            seg.gen_marks.append((0, g))
        return seg

    def register_kn(self, kn: str) -> None:
        self.segments.setdefault(kn, [self.new_segment(kn)])

    def drop_kn(self, kn: str) -> None:
        self.segments.pop(kn, None)

    def active_segment(self, kn: str) -> PySegment:
        return self.segments[kn][-1]

    def unmerged_count(self, kn: str) -> int:
        """Segments of this KN not yet fully merged (active excluded).
        Fully-merged sealed segments are pruned as a side effect: they
        can never become unmerged again, and without pruning this scan
        is O(total segments ever written) on every write."""
        segs = self.segments.get(kn)
        if segs is None:
            return 0
        if len(segs) > 1:
            keep = [s for s in segs[:-1]
                    if s.merged_upto < len(s.entries)]
            if len(keep) + 1 < len(segs):
                keep.append(segs[-1])
                self.segments[kn] = segs = keep
        return len(segs) - 1

    # ----- staged oplog (the batched write plane) ----------------------------
    def alloc_values_batch(self, values, lengths) -> int:
        """Bulk heap extension for a staged oplog flush: entry i of the
        flush gets pointer ``base + i``. Owning segments are recorded
        when the entries land via fill_segments_batch."""
        base = len(self.heap_val)
        self.heap_val.extend(values)
        self.heap_len.extend(lengths)
        self.heap_seg.extend([None] * (len(self.heap_val) - base))
        return base

    def register_reqs(self, req_ids, ptrs) -> None:
        """Record sealed entries' request IDs (-1 entries skipped): the
        durable applied-set the exactly-once retry contract dedups
        against."""
        ri = self.req_index
        for r, p in zip(req_ids, ptrs):
            if r >= 0:
                ri[r] = p

    def req_applied(self, req_id: int) -> bool:
        """Has a *sealed* log entry for this request ID landed?  The
        KN-side dedup check a retry pays one RT for."""
        return req_id in self.req_index

    def retire_reqs(self, watermark: int) -> int:
        """Compact the applied-set: forget request IDs below
        ``watermark``.  Without this the dedup table grows one entry
        per write for the life of the pool.

        The caller owns the safety argument: ``watermark`` must be a
        *retry horizon* -- every request with ``req_id < watermark``
        has reached a terminal state at its client (completed, shed,
        or retries exhausted), so no future ``req_applied`` probe for
        it can ever arrive.  Dropping only such IDs preserves
        exactly-once across crash/recover: a recovery that discards a
        torn entry unregisters its ID itself (``recover_kn``), and a
        retry that could still probe is by definition at or above the
        watermark.  Returns the number of entries dropped."""
        ri = self.req_index
        dead = [r for r in ri if r < watermark]
        for r in dead:
            del ri[r]
        return len(dead)

    def fill_segments_batch(self, kn: str, keys, ptrs,
                            req_ids=None, token=None):
        """Append a run of staged (key, ptr) entries to the KN's log,
        creating (but NOT enqueuing) rotated segments: the caller must
        replay the rotation events in global op order, because per-op
        log_write pushes to the *shared* merge backlog at rotation time
        and the backlog is consumed FIFO across KNs. Returns the
        filled-up segments, in order, or a FencedWrite no-op when
        ``token`` is a stale ownership generation."""
        fenced = self._check_fence(kn, token, "fill_segments_batch")
        if fenced is not None:
            return fenced
        gen = self._gen_of(kn, token)
        segs = self.segments[kn]
        seg = segs[-1]
        cap = self.segment_capacity
        rotated: list[PySegment] = []
        hs = self.heap_seg
        fp = self.faults
        i, n = 0, len(keys)
        while i < n:
            if len(seg.entries) >= cap:
                # defensively rotate a full active segment (log_write
                # never leaves one, but a caller could)
                if fp is not None and \
                        fp.take_crash(CRASH_POINTS.LOG_ROTATION, kn, 1) is not None:
                    raise KNCrash(kn, CRASH_POINTS.LOG_ROTATION)
                rotated.append(seg)
                seg = self.new_segment(kn)
                segs.append(seg)
                self.gc.segments_created += 1
            take = min(cap - len(seg.entries), n - i)
            if fp is not None:
                j = fp.take_crash(CRASH_POINTS.LOG_PRE_SEAL, kn, take)
                if j is not None:
                    # j entries of this run sealed; the (j+1)-th landed
                    # torn (value bytes written, seal byte lost)
                    ki = keys[i:i + j + 1]
                    pi = ptrs[i:i + j + 1]
                    ri = ([-1] * (j + 1) if req_ids is None
                          else req_ids[i:i + j + 1])
                    seg.entries.extend(zip(ki, pi))
                    seg.sealed.extend([True] * j + [False])
                    seg.reqs.extend(ri)
                    seg.gens.extend([gen] * (j + 1))
                    seg.valid += j + 1
                    for p in pi:
                        hs[p] = seg
                    # only the sealed prefix is applied; the torn
                    # entry's request stays retryable
                    self.register_reqs(ri[:j], pi[:j])
                    raise KNCrash(kn, CRASH_POINTS.LOG_PRE_SEAL)
            ki = keys[i:i + take]
            pi = ptrs[i:i + take]
            seg.entries.extend(zip(ki, pi))
            seg.sealed.extend([True] * take)
            seg.gens.extend([gen] * take)
            seg.valid += take
            for p in pi:
                hs[p] = seg
            if req_ids is None:
                seg.reqs.extend([-1] * take)
            else:
                ri = req_ids[i:i + take]
                seg.reqs.extend(ri)
                self.register_reqs(ri, pi)
            i += take
            if len(seg.entries) >= cap:
                # crash at the rotation boundary: the segment is full
                # and fully sealed but was never published to the shared
                # merge backlog (the caller enqueues rotations after
                # this returns) -- recovery must rediscover it by
                # scanning the KN's segments
                if fp is not None and \
                        fp.take_crash(CRASH_POINTS.LOG_ROTATION, kn, 1) is not None:
                    raise KNCrash(kn, CRASH_POINTS.LOG_ROTATION)
                rotated.append(seg)
                seg = self.new_segment(kn)
                segs.append(seg)
                self.gc.segments_created += 1
        return rotated

    def log_write_batch(self, kn: str, keys, values, lengths,
                        req_ids=None, token=None):
        """Batched ``log_write``: one heap extension + one segment fill
        for a run of same-KN entries, rotated segments enqueued for
        async merge in order. Element-wise equivalent to per-entry
        log_write calls. Returns (ptrs, rotations), or a FencedWrite
        no-op (checked *before* the heap extension: a stale flush
        leaves no partial scatter)."""
        fenced = self._check_fence(kn, token, "log_write_batch")
        if fenced is not None:
            return fenced
        base = self.alloc_values_batch(values, lengths)
        ptrs = list(range(base, base + len(keys)))
        rotated = self.fill_segments_batch(kn, keys, ptrs, req_ids=req_ids,
                                           token=token)
        for seg in rotated:
            self.merge_backlog.append((seg, 0))
        return ptrs, len(rotated)

    def log_write(self, kn: str, key: int, value, length: int,
                  sealed: bool = True, req_id: int = -1, token=None):
        """Append one entry to the KN's active segment. Returns
        (ptr, rotated): ``rotated`` tells the caller a segment filled up
        and was queued for async merge -- the KN must block if its
        un-merged backlog now exceeds the threshold (paper Sec. 4).
        A stale ``token`` returns a FencedWrite no-op instead."""
        fenced = self._check_fence(kn, token, "log_write")
        if fenced is not None:
            return fenced
        gen = self._gen_of(kn, token)
        seg = self.active_segment(kn)
        fp = self.faults
        if fp is not None and sealed and \
                fp.take_crash(CRASH_POINTS.LOG_PRE_SEAL, kn, 1) is not None:
            ptr = self.alloc_value(value, length, seg)
            # seal byte never landed: the request stays retryable
            seg.append(key, ptr, sealed=False, req=req_id, gen=gen)
            raise KNCrash(kn, CRASH_POINTS.LOG_PRE_SEAL)
        ptr = self.alloc_value(value, length, seg)
        seg.append(key, ptr, sealed=sealed, req=req_id, gen=gen)
        if sealed and req_id >= 0:
            self.req_index[req_id] = ptr
        rotated = False
        if seg.full():
            if fp is not None and \
                    fp.take_crash(CRASH_POINTS.LOG_ROTATION, kn, 1) is not None:
                raise KNCrash(kn, CRASH_POINTS.LOG_ROTATION)  # never published
            self.merge_backlog.append((seg, 0))
            self.segments[kn].append(self.new_segment(kn))
            self.gc.segments_created += 1
            rotated = True
        return ptr, rotated

    def write_blocked(self, kn: str) -> bool:
        return self.unmerged_count(kn) > self.unmerged_threshold

    def write_once(self, kn: str, key: int, value, length: int,
                   req_id: int, token=None):
        """The retry contract in one call: check-then-write.  A client
        that timed out retries the *same* request ID; if a sealed log
        entry for it already landed (the original attempt was applied,
        only the ack was lost), the write is a dedup no-op -- otherwise
        it applies fresh.  Returns (ptr, applied): ``applied`` False
        means deduplicated.  Exactly-once overall: at most one sealed
        entry per request ID ever exists.  A stale ``token`` returns
        the FencedWrite no-op from log_write."""
        if req_id >= 0 and self.req_applied(req_id):
            return self.req_index[req_id], False
        r = self.log_write(kn, key, value, length, req_id=req_id,
                           token=token)
        if isinstance(r, FencedWrite):
            return r
        ptr, _rotated = r
        return ptr, True

    # ----- asynchronous merge (DPM processors) --------------------------------
    def merge_budget(self, ops: int) -> int:
        """Merge up to ``ops`` log entries from the backlog, strictly in
        order within each segment. When ``merge_allowance`` is set (the
        per-epoch DPM-processor budget), the budget clamps the merge
        window itself (plan_merge_window's ``max_ops``), and the
        allowance is debited exactly once, here, by the entry count
        merge_entries_batch reports -- a truncated plan plus its scalar
        replay can never double-charge the epoch budget. Returns
        entries merged."""
        if self.merge_allowance is not None:
            ops = min(ops, self.merge_allowance)
        done = 0
        t0 = time.perf_counter()
        # merges run as DPM processors (management plane), even when a
        # KN's blocked write path invoked them inline
        with sanitize.management():
            while self.merge_backlog and done < ops:
                seg, _ = self.merge_backlog.popleft()
                entries = seg.sealed_entries()
                if seg.merged_upto < len(entries):
                    merged = self.merge_entries_batch(
                        entries[seg.merged_upto:], seg,
                        max_ops=ops - done)
                    seg.merged_upto += merged
                    done += merged
                if seg.merged_upto < len(entries):
                    self.merge_backlog.appendleft((seg, 0))
                else:
                    self._maybe_collect(seg)
        if self.merge_allowance is not None:
            self.merge_allowance -= done
        self.merge_wall_s += time.perf_counter() - t0
        return done

    def merge_all(self, kn: str | None = None) -> int:
        """Synchronous merge of all pending entries (reconfiguration step
        3 / failure recovery: 'merges all pending logs from the KNs
        involved before allowing the other KNs to serve reads').
        Deliberately exempt from ``merge_allowance``: the protocol's
        synchronous merges must complete regardless of the async
        DPM-processor budget."""
        done = 0
        t0 = time.perf_counter()
        with sanitize.management():
            # backlog first (order preserved), filtered by KN if given
            keep: deque = deque()
            while self.merge_backlog:
                seg, _ = self.merge_backlog.popleft()
                if kn is not None and seg.kn != kn:
                    keep.append((seg, 0))
                    continue
                entries = seg.sealed_entries()
                todo = entries[seg.merged_upto:]
                if todo:
                    self.merge_entries_batch(todo, seg)
                    done += len(todo)
                seg.merged_upto = len(entries)
                self._maybe_collect(seg)
            self.merge_backlog = keep
            # then active segments
            for owner, segs in self.segments.items():
                if kn is not None and owner != kn:
                    continue
                act = segs[-1]
                entries = act.sealed_entries()
                todo = entries[act.merged_upto:]
                if todo:
                    self.merge_entries_batch(todo, act)
                    done += len(todo)
                act.merged_upto = len(entries)
                if entries:
                    self.segments[owner] = [self.new_segment(owner)]
        self.merge_wall_s += time.perf_counter() - t0
        return done

    def merge_entries_batch(self, entries, seg: PySegment,
                            max_ops: int | None = None, token=None):
        """Merge a run of (key, ptr) entries of one segment in order --
        element-wise equivalent to per-entry ``_merge_entry`` (property
        tested). The run goes through the planned merge plane: each
        window plans as one vectorized sweep (transition.
        plan_merge_window -- grouped bucket targets, per-bucket slot
        assignment, old-pointer supersession, indirect filtering) and
        applies in bulk (apply_merge_plan); the entry at a plan's
        self-truncation point (a tombstone, or a bucket whose chain
        must grow) replays through the exact scalar ``_merge_entry``
        before re-planning. ``max_ops`` (the remaining per-epoch merge
        allowance) clamps the plan itself. Returns entries merged --
        the caller's single accounting point, so a truncated plan plus
        its replay is never double-charged.  A stale ``token`` (a
        zombie trying to push its own window into the index) returns a
        FencedWrite no-op before anything touches the index."""
        fenced = self._check_fence(seg.kn, token, "merge_entries_batch")
        if fenced is not None:
            return fenced
        n = len(entries)
        if max_ops is not None and max_ops < n:
            n = max_ops
            entries = entries[:n]
        fp = self.faults
        if fp is not None and fp.armed and n:
            kn = seg.kn
            j = fp.take_crash(CRASH_POINTS.MERGE_MID_APPLY, kn, n)
            if j is not None:
                # a prefix of the window reached the index; the merge
                # cursor (the caller's merged_upto advance) never did
                for key, ptr in entries[:j]:
                    self._merge_entry(key, ptr, seg)
                raise KNCrash(kn, CRASH_POINTS.MERGE_MID_APPLY)
            if fp.take_crash(CRASH_POINTS.MERGE_POST_APPLY, kn, 1) is not None:
                # the whole window applied; cursor/allowance accounting
                # never ran, so recovery will replay these entries
                for key, ptr in entries:
                    self._merge_entry(key, ptr, seg)
                raise KNCrash(kn, CRASH_POINTS.MERGE_POST_APPLY)
        if not self.vectorized or n < MIN_MERGE_PLAN_OPS:
            for key, ptr in entries:
                self._merge_entry(key, ptr, seg)
            if self.vectorized:       # the oracle plane never counts
                MERGE_PLAN_STATS["replayed_windows"] += 1
                MERGE_PLAN_STATS["replayed_entries"] += n
            return n
        arr = np.asarray(entries, dtype=np.int64)
        keys, ptrs = arr[:, 0], arr[:, 1]
        ind = self._indirect_keys_array() if self.indirect else None
        i = 0
        while i < n:
            plan = plan_merge_window(self.index, keys[i:], ptrs[i:],
                                     indirect_keys=ind)
            if plan is None:
                self._merge_entry(int(keys[i]), int(ptrs[i]), seg)
                MERGE_PLAN_STATS["replayed_windows"] += 1
                MERGE_PLAN_STATS["replayed_entries"] += 1
                i += 1
                continue
            self.apply_merge_plan(plan)
            MERGE_PLAN_STATS["planned_windows"] += 1
            MERGE_PLAN_STATS["planned_entries"] += plan.ops
            i += plan.ops
        return n

    def apply_merge_plan(self, plan, token=None, kn=None):
        """Apply one planned merge window against the pool: bulk index
        scatters (NumpyCLHT.apply_merge_plan), one-pass supersession
        invalidation with per-segment GC accounting, and dirty-key
        tracking for the batch engine's prefetched probes. Planned
        windows never grow bucket chains (overflow truncates the plan),
        so there are no bucket-growth hazards to record.  When the
        applying caller is a KN (``kn``/``token`` given) the fence is
        validated first: a stale applier gets a FencedWrite no-op --
        no scatter, no GC accounting."""
        if kn is not None or token is not None:
            fenced = self._check_fence(kn, token, "apply_merge_plan")
            if fenced is not None:
                return fenced
        self.gc.entries_merged += plan.ops
        self.index.apply_merge_plan(plan)
        if self._dirty is not None:
            self._dirty[0].update(plan.live_keys.tolist())
        inv = plan.inv_ptrs
        if inv.size:
            hv, hs = self.heap_val, self.heap_seg
            touched = {}
            for o in inv.tolist():
                hv[o] = None                    # value superseded
                s = hs[o]
                if s is not None:
                    s.valid -= 1
                    touched[id(s)] = s
            for s in touched.values():
                self._maybe_collect(s)

    def _merge_entry(self, key: int, ptr: int, seg: PySegment) -> None:
        if key < 0:   # tombstone entry: key encoded as -(key+1)
            real = -key - 1
            old, found = self.index.delete(real)
            if self._dirty is not None:
                self._dirty[0].add(real)
            if found and old is not None:
                self._invalidate_ptr(old)
            self.gc.entries_merged += 1
            seg.valid -= 1
            return
        # Replicated keys publish through the one-sided CAS on the
        # indirection slot at write time; merging the log entry again
        # must NOT touch the slot (it could rewind past a newer CAS).
        # The entry only needed GC accounting, which cas_indirect
        # already performed for superseded pointers.
        if key in self.indirect:
            pass
        else:
            head0 = self.index.overflow_head
            old, ok = self.index.insert(key, ptr)
            if self._dirty is not None:
                self._dirty[0].add(key)
                if self.index.overflow_head != head0:
                    self._dirty[1].add(self.index._bucket(key))
            if ok and old is not None and old != ptr:
                self._invalidate_ptr(old)
        self.gc.entries_merged += 1

    def track_merge_dirty(self) -> tuple[set, set]:
        """Start recording (keys remapped, primary buckets grown) by
        merges -- the batch engine's probe-staleness oracle. Returns the
        live (keys, buckets) set pair."""
        self._dirty = (set(), set())
        return self._dirty

    def untrack_merge_dirty(self) -> None:
        self._dirty = None

    def _invalidate_ptr(self, ptr: int) -> None:
        seg = self.heap_seg[ptr]
        self.heap_val[ptr] = None       # value superseded
        if seg is not None:
            seg.valid -= 1
            self._maybe_collect(seg)

    def _maybe_collect(self, seg: PySegment) -> None:
        """Paper Sec. 4: a segment whose invalid count equals its total
        count is garbage-collected by a DPM processor."""
        if seg.full() and seg.valid <= 0:
            self.gc.segments_collected += 1
            seg.entries.clear()
            seg.sealed.clear()
            seg.reqs.clear()
            seg.gens.clear()

    # ----- crash recovery (paper Sec. 3.6) ------------------------------------
    def recover_kn(self, kn: str, token=None):
        """Crash-consistent recovery of one KN's DPM state.  The KN
        fail-stopped at an arbitrary point; its segments survive in PM
        but nothing else can be trusted:

          1. discard unsealed segment tails -- a torn entry invalidates
             itself and everything after it, because merge order must
             match request order (``PySegment.recover_torn``, the same
             semantics as the tensor plane's ``log.recover_segment``);
          2. replay every sealed-but-unmerged entry, oldest first,
             through the planned merge path.  Replay is idempotent on
             the index: re-inserting a (key, ptr) it already holds
             supersedes nothing, re-deleting a tombstoned key finds
             nothing.  This also rediscovers full segments a crash at
             the rotation boundary never published to the backlog;
          3. purge the KN's segments from the shared merge backlog (the
             replay just consumed them; a later merge_budget must not
             touch a dead KN's log);
          4. repair indirection slots left dangling by a CAS that raced
             a torn entry: rewind to the key's latest live sealed log
             entry -- heap pointers are allocated in global write order,
             so 'latest' is the maximum live pointer;
          5. recompute per-segment GC accounting from ground truth.
             Replay may double-count tombstones (the crash may have
             applied them once already without advancing the cursor), so
             the counters are recomputed, never trusted; dead segments
             then collect.

        The recovered pool is property-tested equal to a reference pool
        that replayed only acknowledged (sealed-before-crash) ops.
        Returns a recovery record with per-phase entry counts, or a
        FencedWrite no-op when ``token`` is stale (a zombie must not
        'recover' -- i.e. replay -- ranges it no longer owns)."""
        fenced = self._check_fence(kn, token, "recover_kn")
        if fenced is not None:
            return fenced
        # recovery runs on a surviving peer: armed crash points for the
        # dead KN must not fire inside the recovery replay itself
        fp, self.faults = self.faults, None
        try:
            segs = list(self.segments.get(kn, ()))
            discarded = 0
            for seg in segs:
                for _key, ptr, req in seg.recover_torn():
                    # the torn entries' value bytes are garbage rows now
                    self.heap_val[ptr] = None
                    self.heap_seg[ptr] = None
                    # a discarded entry was never applied: drop its
                    # request ID so the client's retry goes through
                    # (force_crash can tear entries whose IDs already
                    # registered -- recovery must unregister them)
                    if req >= 0:
                        self.req_index.pop(req, None)
                    discarded += 1
            replayed = 0
            for seg in segs:
                todo = self._replay_screen(seg)
                if todo:
                    self.merge_entries_batch(todo, seg)
                    replayed += len(todo)
                seg.merged_upto = len(seg.entries)
            if any(seg.kn == kn for seg, _ in self.merge_backlog):
                self.merge_backlog = deque(
                    item for item in self.merge_backlog
                    if item[0].kn != kn)
            repaired = self._repair_indirect()
            for seg in segs:
                seg.valid = self._recount_valid(seg)
                self._maybe_collect(seg)
            # the KN resumes serving after recovery; a crash at the
            # rotation boundary leaves its last segment full (replayed
            # above, but never rotated), so retried writes need a fresh
            # active segment to land on
            live = self.segments.setdefault(kn, [])
            if not live or live[-1].full():
                live.append(self.new_segment(kn))
                self.gc.segments_created += 1
            return {"kn": kn, "discarded": discarded, "replayed": replayed,
                    "repaired_indirect": repaired}
        finally:
            self.faults = fp

    def _replay_screen(self, seg: PySegment) -> list[tuple[int, int]]:
        """The recovery replay's idempotence screen.  A crashed merge
        window may have applied a prefix without advancing the cursor,
        so blind replay could *rewind* the index: re-inserting a key's
        older pointer after its newer one already merged would supersede
        the newer value.  Heap pointers are allocated in global write
        order, so the screen is monotone: replay an entry only if the
        index does not already hold its key with an equal-or-newer
        pointer.  (A key absent because its applied entry was followed
        by an applied tombstone replays both -- the pair converges to
        absent again.)  Replicated keys pass through: merging them is a
        no-op by construction (the indirection slot is authoritative)."""
        todo = []
        for key, ptr in seg.entries[seg.merged_upto:]:
            real = -key - 1 if key < 0 else key
            if real in self.indirect:
                todo.append((key, ptr))
                continue
            cur, _ = self.index.lookup(real)
            if cur is not None and cur >= ptr:
                continue        # this write (or a newer one) already merged
            todo.append((key, ptr))
        return todo

    def _recount_valid(self, seg: PySegment) -> int:
        """Ground-truth valid count: a normal entry is live while its
        heap value is, a tombstone is live until merged (its only job is
        to reach the index)."""
        hv = self.heap_val
        valid = 0
        for i, (key, ptr) in enumerate(seg.entries):
            if key < 0:
                valid += i >= seg.merged_upto
            else:
                valid += hv[ptr] is not None
        return valid

    def _repair_indirect(self) -> int:
        """Rewind indirection slots whose target heap row is dead (a CAS
        that raced a torn entry): scan the surviving segments for the
        key's latest live sealed entry (max pointer == newest write).  A
        key with no live entry anywhere lost every acked value's trail
        -- impossible for a single crash, but recovery trusts nothing:
        the slot and index entry drop so reads observe absence rather
        than garbage."""
        nheap = len(self.heap_val)
        broken = [key for key, ptr in self.indirect.items()
                  if not 0 <= ptr < nheap or self.heap_val[ptr] is None]
        for key in broken:
            best = -1
            for segs in self.segments.values():
                for seg in segs:
                    for (k, p), s in zip(seg.entries, seg.sealed):
                        if s and k == key and p > best and \
                                self.heap_val[p] is not None:
                            best = p
            if best >= 0:
                self.indirect[key] = best
            else:
                del self.indirect[key]
                self.index.delete(key)
            self._indirect_version += 1
        return len(broken)

    def verify_integrity(self) -> list[str]:
        """Crash-consistency invariant checker (the recovery property
        tests' acceptance gate and the scenario harness's post-crash
        SLO).  Returns human-readable violations, [] when healthy:

          * seal patterns are prefixes (a torn entry taints its tail),
          * merge cursors stay within the sealed prefix,
          * live index entries point at live heap rows (replicated keys
            resolve through the indirection table instead -- their
            direct index pointers dangle by design after the first CAS),
          * indirection slots point at live heap rows,
          * per-segment GC accounting matches a ground-truth recount.
        """
        problems: list[str] = []
        nheap = len(self.heap_val)
        heap_live = np.fromiter((v is not None for v in self.heap_val),
                                dtype=bool, count=nheap)
        for kn, segs in self.segments.items():
            for si, seg in enumerate(segs):
                if not seg.entries:
                    continue        # fresh or collected (entries cleared)
                try:
                    cut = seg.sealed.index(False)
                except ValueError:
                    cut = len(seg.sealed)
                if any(seg.sealed[cut:]):
                    problems.append(f"{kn}/seg{si}: sealed entry after "
                                    f"a torn one (non-prefix seal)")
                if seg.merged_upto > cut:
                    problems.append(f"{kn}/seg{si}: merge cursor "
                                    f"{seg.merged_upto} past sealed "
                                    f"prefix {cut}")
                want = self._recount_valid(seg)
                if seg.valid != want:
                    problems.append(f"{kn}/seg{si}: valid counter "
                                    f"{seg.valid} != recount {want}")
                if len(seg.reqs) != len(seg.entries):
                    problems.append(f"{kn}/seg{si}: request-ID column "
                                    f"misaligned ({len(seg.reqs)} != "
                                    f"{len(seg.entries)} entries)")
                if len(seg.gens) != len(seg.entries):
                    problems.append(f"{kn}/seg{si}: fence-generation "
                                    f"column misaligned ({len(seg.gens)} "
                                    f"!= {len(seg.entries)} entries)")
                else:
                    # no sealed entry may carry a generation older than
                    # the fence watermark in force at its append: such
                    # an entry is a zombie write that bypassed the fence
                    for m, mg in seg.gen_marks:
                        for i in range(m, len(seg.entries)):
                            if seg.sealed[i] and seg.gens[i] < mg:
                                problems.append(
                                    f"{kn}/seg{si}: sealed entry {i} "
                                    f"carries stale generation "
                                    f"{seg.gens[i]} < fence {mg}")
                                break
        keys = self.index.keys.ravel()
        ptrs = self.index.ptrs.ravel()
        live = keys >= 0
        keys, ptrs = keys[live], ptrs[live]
        if keys.size:
            if self.indirect:
                direct = ~np.isin(keys, self._indirect_keys_array())
            else:
                direct = np.ones(keys.shape, dtype=bool)
            bad_range = direct & ((ptrs < 0) | (ptrs >= nheap))
            for k in keys[bad_range][:8].tolist():
                problems.append(f"index key {k}: pointer out of range")
            ok = direct & ~bad_range
            dead = np.zeros(keys.shape, dtype=bool)
            dead[ok] = ~heap_live[ptrs[ok]]
            for k, p in zip(keys[dead][:8].tolist(),
                            ptrs[dead][:8].tolist()):
                problems.append(f"index key {k}: dead value row {p}")
        torn_ptrs = set()
        for segs in self.segments.values():
            for seg in segs:
                if False in seg.sealed:
                    cut = seg.sealed.index(False)
                    torn_ptrs.update(p for _k, p in seg.entries[cut:])
        for key, ptr in self.indirect.items():
            if not 0 <= ptr < nheap or self.heap_val[ptr] is None:
                problems.append(f"indirect key {key}: dead target {ptr}")
            elif ptr in torn_ptrs:
                # a CAS raced a torn entry: readers would observe
                # unsealed bytes through the slot
                problems.append(f"indirect key {key}: unsealed target "
                                f"{ptr}")
        # exactly-once contract: an "applied" request ID must name an
        # in-range pointer whose entry is not torn (a torn entry never
        # happened -- claiming it applied would make a retry dedup
        # against a lost write)
        for req, ptr in self.req_index.items():
            if not 0 <= ptr < nheap:
                problems.append(f"req {req}: pointer {ptr} out of range")
            elif ptr in torn_ptrs:
                problems.append(f"req {req}: registered against torn "
                                f"entry {ptr}")
        return problems

    # ----- index reads (one-sided) --------------------------------------------
    def index_lookup(self, key: int):
        """-> (ptr or None, probe_rts). Replicated keys resolve through
        the indirection table: one extra RT (paper Sec. 3.4). The index
        entry of a shared key names its indirection slot, so the direct
        pointer (possibly superseded by CAS) is never followed."""
        if key in self.indirect:
            _, probes = self.index.lookup(key)
            return self.indirect[key], probes + 1
        return self.index.lookup(key)

    @property
    def meta_version(self) -> int:
        """Changes whenever a batched probe prefetch would go stale."""
        return self.index.version + self._indirect_version

    def _indirect_keys_array(self) -> np.ndarray:
        if self._indirect_cache is None or \
                self._indirect_cache[0] != self._indirect_version:
            arr = np.sort(np.fromiter(self.indirect.keys(), dtype=np.int64,
                                      count=len(self.indirect)))
            self._indirect_cache = (self._indirect_version, arr)
        return self._indirect_cache[1]

    def sync_index(self) -> CLHT:
        """Bring ``index_dev`` level with the host index: at the first
        call the whole table, later the rows the host index noted since
        the previous call, as one upload (each line with its row id) and
        one row scatter. Returns ``index_dev``."""
        idx = self.index
        if self.index_dev is None:
            idx.track_rows()
            lines = torch.from_numpy(_pack_rows(idx, slice(None)))
            self.index_dev = CLHT(
                lines=lines.to(self.device),
                overflow_head=torch.tensor(idx.overflow_head,
                                           dtype=torch.int32,
                                           device=self.device),
                num_buckets=idx.num_buckets)
            return self.index_dev
        rows = idx.noted_rows()
        if rows.size:
            up = np.empty((rows.size, LINE + 1), np.int32)
            up[:, :LINE] = _pack_rows(idx, rows)
            up[:, LINE] = rows
            up = torch.from_numpy(up).to(self.device)
            self.index_dev.lines.index_copy_(0, up[:, LINE].long(),
                                             up[:, :LINE])
            idx.clear_noted()
        self.index_dev.overflow_head.fill_(idx.overflow_head)
        return self.index_dev

    def index_lookup_batch(self, keys: np.ndarray):
        """Vectorized ``index_lookup``: (ptrs, probes) int64 arrays with
        ptr == -1 where absent; element-wise identical to the scalar and
        to ``NumpyCLHT.lookup_batch``. The walk runs on ``index_dev``
        (kernel A over the primary lines, then the chain walk for the
        keys that missed a chained line); a key outside the int32 range
        raises."""
        keys = np.asarray(keys, dtype=np.int64)
        table = self.sync_index()
        _check_int32("index_lookup_batch keys", keys, -_I32_MAX - 1)
        kd = torch.from_numpy(keys.astype(np.int32)).to(self.device)
        ptrs, walked = lookup_walk(table, kd)
        ptrs = ptrs.cpu().numpy().astype(np.int64)
        probes = walked.cpu().numpy().astype(np.int64)
        if self.indirect:
            ind = np.isin(keys, self._indirect_keys_array())
            if ind.any():
                probes = probes + ind          # extra indirection RT
                for i in np.nonzero(ind)[0]:
                    ptrs[i] = self.indirect[int(keys[i])]
        return ptrs, probes

    # ----- indirection (selective replication, one-sided CAS) ----------------
    def install_indirect(self, key: int) -> None:
        if key in self.indirect:
            return
        ptr, _ = self.index.lookup(key)
        if ptr is None:
            return
        self.indirect[key] = ptr
        self._indirect_version += 1
        # the index now names the indirection slot; readers discover
        # 'replicated' status via ownership metadata at RNs/KNs.

    def cas_indirect(self, key: int, expect: int, new: int,
                     kn: str | None = None, token=None):
        """One-sided CAS on a replicated key's indirection slot.  The
        fence validates *before* the compare (a zombie's CAS must not
        even read-modify-write the slot); the armed ``rep.post_cas``
        crash point fires *after* the swing lands but before the
        superseded pointer's GC accounting runs -- the mid-operation
        torn state recovery must repair."""
        fenced = self._check_fence(kn, token, "cas_indirect")
        if fenced is not None:
            return fenced
        cur = self.indirect.get(key)
        if cur != expect:
            return False
        fp = self.faults
        if fp is not None and fp.armed and kn is not None and \
                fp.take_crash(CRASH_POINTS.REP_POST_CAS, kn, 1) is not None:
            # the CAS landed (durable) ...
            self.indirect[key] = new
            self._indirect_version += 1
            seg = self.heap_seg[new] \
                if 0 <= new < len(self.heap_seg) else None
            landed = seg is not None and any(
                p == new and s
                for (_k, p), s in zip(seg.entries, seg.sealed))
            if not landed:
                # ... but the batched plane's log entry for ``new``
                # never did: the slot names a value whose seal byte is
                # missing.  Materialize that exact torn state -- an
                # unsealed entry in the KN's active segment -- so
                # verify_integrity sees 'unsealed target' and recovery
                # rewinds the slot (same shape force_crash leaves).
                act = self.segments[kn][-1]
                act.entries.append((key, new))
                act.sealed.append(False)
                act.reqs.append(-1)
                act.gens.append(self._gen_of(kn, token))
                act.valid += 1
                self.heap_seg[new] = act
            # either way the superseded pointer's invalidation (GC
            # accounting) never ran
            raise KNCrash(kn, CRASH_POINTS.REP_POST_CAS)
        self.indirect[key] = new
        self._indirect_version += 1
        if expect is not None and expect != new:
            self._invalidate_ptr(expect)
        return True

    def read_indirect(self, key: int) -> int | None:
        return self.indirect.get(key)

    def remove_indirect(self, key: int) -> None:
        """De-replication: after owners invalidate their cached entries,
        the indirection slot is dropped and the index points directly."""
        ptr = self.indirect.pop(key, None)
        if ptr is not None:
            self._indirect_version += 1
            self.index.insert(key, ptr)

    # ----- bulk load (experiment setup, bypasses the timed path) -------------
    def bulk_load(self, items, kn: str = "__loader__") -> None:
        self.register_kn(kn)
        for key, value, length in items:
            self.log_write(kn, key, value, length)
        self.merge_all(kn)
        self.drop_kn(kn)
