"""The compiled batch engine: ``execute_batch(engine="jit")``.

The port's copy of the reference's engine (``repro.core.jit_engine``).
Each KN window of the batched data plane runs through kernel E
(``kernels.batch_executor.fused_windows``) instead of the host planner:
the window's DAC transitions -- value/shortcut hits, Eq. 1 promotions
with the full make-space loop, prefetch-resolved misses, staged write
fills -- execute on the card over the KN's per-key state, and the host
only folds the outcome (stats, RT sums, the miss-EMA refold in op order,
segment-cache puts, collected read values) from the returned per-op
event records. Every KN's dispatch of one step of an advance goes into
one launch (``advance``; ``run_window`` is a generator of a window's
dispatches). With ``device="cpu"`` the state is CPU tensors and the
wrappers run their plain versions.

Residency model
---------------
A KN's cache state (kind/count/stamp/length/ptr plus a wrote flag, the
histogram and the registers: one int32 buffer on the device), the two
victim min-trees the kernel keeps and a dirty record (the slots the
kernel wrote) stay on the device from the KN's first dispatch on, across
batches, with an int32 host shadow of the five fields as the device last
saw them. The reference uploads the state once per batch on first use
and scatters it back whenever the host must touch the cache:

  * a truncation cut (the residual replays through the host engine),
  * a host-run span (deletes, short segments, degenerate progress),
  * a replicated-key op or batch end (``sync_all``).

This engine does the same at the same points -- each "upload" and each
"scatter-back" happens where the reference's does, so the host engine
takes exactly the windows the reference's would -- but moves only what
changed. An upload sends the slots the host wrote since the last one
(``ArrayDAC._dirty``, a ``SlotRecord`` the cache keeps while a residency
exists, filtered against the shadow) and scatters them on the card; a
scatter-back gathers the slots the kernel wrote (its dirty record) and
writes them into the cache arrays and the shadow. A full upload happens
on first use and after the record was dropped: ``ArrayDAC.clear`` (a
reconfiguration), a growth of the per-key vectors, or ``drop`` (a KN
removed, failed or handing off ownership).

Scatter-back re-seeds the cache's *lazy* LRU/LFU heaps with one record
per entry whose kind changed on device since the upload (the shadow
holds the kind as uploaded), in key order, as the reference does;
entries whose kind survived keep their existing records, which the lazy
pop discipline self-heals (stale stamp/count records refresh on pop).
The engine is decision-for-decision identical to the host engine
(tests/test_torch_jit_engine.py holds it to the reference's jit engine
and to the port's host engine).

Truncation -> replay contract
-----------------------------
The kernel stops *before* the first op it cannot prove on the device
(segcache-backed or unprefetched reads, histogram spill, EMA-staled or
table-overflow promote decisions; see ``kernels.batch_executor.ref``)
and reports how far it got plus a reason code. The engine scatters
back, replays a short residual (including the blocking op) through the
host engine's exact per-op machinery, and resumes on the device.
Deletes are statically clamped: the dispatch never spans one.
Degenerate progress (repeated cuts with little forward motion) hands
the rest of the window to the host engine.

Everything on the device is int32; the upload guards check the actual
ranges (clock, counts, heap pointers, capacity) and leave the window to
the host engine when any could overflow, as the reference's do: the
three maxima over live entries come from one reduction on the device
(``guard_maxima``) after the upload. The Eq. 1 float comparison is
discretized host-side into an integer threshold table (kept on the
device per miss-RT EMA value), so no float arithmetic runs on the
device.

Transfers, through pinned staging buffers: an upload is one copy in of
the changed slots (index and five fields each) with the histogram and
registers, and the guards' three maxima back; a launch copies every
job's ``n`` live entries of its six op arrays in (one copy) and brings
each job's n_exec, cut, registers, dirty count and ``n`` entries' events
and out_ptr back in one copy; a scatter-back is one copy of the dirty
slots with the histogram and registers. A full upload is one pageable
copy of the packed state.
"""

from __future__ import annotations

import copy
import heapq
import itertools
import time

import numpy as np
import torch

from ..kernels import batch_executor as be
from . import sanitize
from .dac import SlotRecord
from .transition import ENGINE_WALL

_I31 = 2 ** 31 - 1
_GUARD = 2 ** 30          # headroom for clocks/counts that grow per op

#: spans shorter than this never pay a dispatch (the host engine's
#: short-run machinery is faster)
MIN_SPAN = 64
#: residual ops (including the blocking op) replayed on host per cut
REPLAY_OPS = 32
#: max ops per dispatch (windows chunk above this)
W_MAX = 8192
#: consecutive low-progress dispatches before the window goes host
_STALL_CALLS = 3
_STALL_NE = 16

_NHIST = be.CNT_HIST_MAX + 1
_CUT_NAMES = {be.CUT_SEGCACHE: "segcache", be.CUT_PREFETCH: "prefetch",
              be.CUT_SPILL: "spill", be.CUT_EMA: "ema",
              be.CUT_TABLE: "table"}
_FIELDS = ("kind", "count", "stamp", "length", "ptr")


def new_counts() -> dict:
    """The engine's event counts: dispatches (KN windows run on the
    device), launches (kernel-E launches, each one or more dispatches),
    uploads (state moved to the device; full ones, and the others that
    sent a slot, also counted apart) and syncs (scatter-backs), the slots
    the delta uploads and the syncs moved and the bytes of all, host
    replays and cuts by reason."""
    return {"dispatches": 0, "launches": 0, "uploads": 0,
            "full_uploads": 0, "syncs": 0, "host_replays": 0,
            "dispatched_ops": 0, "upload_deltas": 0, "upload_slots": 0,
            "upload_bytes": 0,
            "sync_slots": 0, "sync_bytes": 0,
            **{f"cut_{v}": 0 for v in _CUT_NAMES.values()}}


class _Resident:
    """One KN's device-resident cache state. ``live`` is the reference's
    residency (uploaded, not yet scattered back); the buffers outlive it."""

    __slots__ = ("cache", "kn_name", "record", "buf", "state", "trees",
                 "dirty", "shadow", "nslots", "pad", "live", "dcount",
                 "demo0", "evic0")


class _Job:
    """One prepared dispatch: the window rows and what the fold needs."""

    __slots__ = ("res", "win", "n", "cap", "vmax", "spos", "ck")


class JitEngine:
    """Per-cluster engine; created lazily on the first jit batch."""

    def __init__(self, cluster, device=None):
        self.cluster = cluster
        self.device = cluster.device if device is None else device
        self.resident: dict[str, _Resident] = {}
        self._vmax: dict[float, torch.Tensor] = {}   # amr -> device table
        self._pm_token = None                        # probe_map identity
        self._pm_ptr = self._pm_len = None
        self._pm_probes = self._pm_bucket = None
        self._staging: dict[str, torch.Tensor] = {}
        self.counts = new_counts()

    def __deepcopy__(self, memo):
        """A copied cluster's engine holds no residency (its caches'
        records are not copied either: ``SlotRecord.__deepcopy__``)."""
        # the cluster may be a copy in the making (no attributes yet)
        new = JitEngine(copy.deepcopy(self.cluster, memo), self.device)
        new.counts = dict(self.counts)
        return new

    # ----- staging -------------------------------------------------------
    def _stage(self, role: str, n: int, host: bool) -> torch.Tensor:
        """An int32 staging buffer of at least ``n`` entries, kept per
        role: pinned host memory for the card's copies, or on the
        device."""
        key = ("h:" if host else "d:") + role
        t = self._staging.get(key)
        if t is None or t.numel() < n:
            size = max(n, 2 * (0 if t is None else t.numel()), 1024)
            if not host:
                t = torch.empty(size, dtype=torch.int32, device=self.device)
            elif self.device.type == "cuda":
                t = torch.empty(size, dtype=torch.int32, pin_memory=True)
            else:
                t = torch.empty(size, dtype=torch.int32)
            self._staging[key] = t
        return t[:n]

    def _to_device(self, role: str, a: np.ndarray) -> torch.Tensor:
        """``a`` (int32) on the device through the role's pinned buffer."""
        h = self._stage(role, a.size, True)
        h.numpy()[:] = a
        if self.device.type != "cuda":
            return h
        d = self._stage(role, a.size, False)
        d.copy_(h, non_blocking=True)
        return d

    def _to_host(self, role: str, t: torch.Tensor) -> np.ndarray:
        """The device tensor ``t`` (int32) in the role's pinned buffer,
        after the copy has landed (a view: read it before the role's
        next copy)."""
        if t.device.type != "cuda":
            return t.numpy()
        h = self._stage(role, t.numel(), True)
        h.copy_(t, non_blocking=True)
        torch.cuda.current_stream(t.device).synchronize()
        return h.numpy()

    # ----- per-batch context ---------------------------------------------
    def _ensure_pm(self, probe_map, nbatch, pool) -> None:
        """Densify the batch's probe prefetch map once (dict -> arrays
        indexed by global batch position)."""
        if self._pm_token is probe_map:
            return
        pm_ptr = np.full(nbatch, be.PM_INVALID, np.int64)
        pm_len = np.zeros(nbatch, np.int64)
        pm_probes = np.zeros(nbatch, np.float64)
        pm_bucket = np.full(nbatch, -1, np.int64)
        hl = pool.heap_len
        for p, (pp, probes, bk) in probe_map.items():
            if pp is None:
                pm_ptr[p] = be.PM_ABSENT
            else:
                pm_ptr[p] = pp
                pm_len[p] = hl[pp]
            pm_probes[p] = probes
            pm_bucket[p] = bk
        self._pm_ptr, self._pm_len = pm_ptr, pm_len
        self._pm_probes, self._pm_bucket = pm_probes, pm_bucket
        self._pm_token = probe_map

    def end_batch(self) -> None:
        """Scatter every resident KN back and drop batch context."""
        self.sync_all()
        self._pm_token = None
        self._pm_ptr = self._pm_len = None
        self._pm_probes = self._pm_bucket = None

    # ----- residency -----------------------------------------------------
    def _live(self, name: str) -> bool:
        res = self.resident.get(name)
        return res is not None and res.live

    def drop(self, name: str) -> None:
        """Forget a KN's device copy (its next upload is a full one)."""
        res = self.resident.pop(name, None)
        if res is not None and res.cache._dirty is res.record:
            res.cache._dirty = None

    def _upload(self, kn, cache):
        """Bring the device copy up to the cache (the changed slots, or
        all of them on first use) and make it live; None if the int32
        ranges (or a non-positive capacity) rule the device program out,
        as the reference's guards do."""
        t0 = time.perf_counter()
        nslots = cache.kind.shape[0]
        if not (0 < cache.capacity < _GUARD):
            return None
        if cache._clock >= _GUARD or nslots >= _I31:
            return None
        if len(self.cluster.pool.heap_val) >= _I31:
            return None        # covers every staged/prefetched pointer
        res = self.resident.get(kn.name)
        if res is not None and (res.cache is not cache or res.nslots != nslots
                                or cache._dirty is not res.record):
            self.drop(kn.name)
            res = None
        if res is not None and self._delta(res) is None:
            self.drop(kn.name)
            res = None
        if res is None:
            t1 = time.perf_counter()
            res = self._full(kn, cache)
            ENGINE_WALL["jit_full_upload"] += time.perf_counter() - t1
            if res is None:
                ENGINE_WALL["jit_upload"] += time.perf_counter() - t0
                return None
            self.resident[kn.name] = res
        # the live-entry guards, reduced on the device: the reference's
        # masked maxima over the cache arrays, which the copy now equals
        cmax, pmax, lmax = self._to_host(
            "guards", be.guard_maxima(res.state, nslots)).tolist()
        ENGINE_WALL["jit_upload"] += time.perf_counter() - t0
        if cmax >= _GUARD or pmax >= _I31 or lmax >= _GUARD:
            return None
        res.live = True
        res.demo0 = res.evic0 = 0
        self.counts["uploads"] += 1
        return res

    @staticmethod
    def _regs(cache) -> np.ndarray:
        regs = np.zeros(be.NUM_REGS, np.int32)
        regs[be.R_USED] = cache.used
        regs[be.R_CLOCK] = cache._clock
        regs[be.R_ZSHORT] = cache._zero_shortcuts
        regs[be.R_NVALS] = cache._nvals
        regs[be.R_NSHORT] = cache._nshort
        return regs

    def _full(self, kn, cache):
        """A new residency holding the whole cache; None if a live entry
        is out of the guards' range where int32 could not even hold it
        (a value that does not fit int32 makes the reference's packing
        wrap; its guards then refuse a live one). The packing runs as
        torch CPU copies (threaded), and the packed host buffer stays as
        the shadow."""
        nslots = cache.kind.shape[0]
        arrs = [torch.from_numpy(np.asarray(getattr(cache, f)))
                for f in _FIELDS]
        lo, hi = np.iinfo(np.int32).min, np.iinfo(np.int32).max
        if nslots and any(int(m) < lo or int(x) > hi for m, x in
                          (torch.aminmax(a) for a in arrs[1:])):
            live = cache.kind != 0
            if live.any() and (int(cache.count[live].max()) >= _GUARD
                               or int(cache.ptr[live].max()) >= _I31
                               or int(cache.length[live].max()) >= _GUARD):
                return None
        # the victim trees want a power-of-two leaf count; pad with
        # absent entries (never addressed: keys are < nslots)
        pad = 2
        while pad < nslots:
            pad <<= 1
        # one buffer: kind, count, stamp, length, ptr, wrote (pad each),
        # the histogram, the registers (int32, as init_state packs them)
        # pageable: pinning 50 MB costs about as much as the copy it
        # speeds up, and far more at the process's first pinned buffer
        buf = torch.empty(6 * pad + _NHIST + be.NUM_REGS, dtype=torch.int32)
        rows = buf[:6 * pad].view(6, pad)
        for j, a in enumerate(arrs):
            rows[j, :nslots].copy_(a)          # int64 -> int32, as numpy
        rows[:5, nslots:] = 0
        rows[5] = 0                            # wrote
        buf[6 * pad:6 * pad + _NHIST] = torch.tensor(cache._cnt_hist,
                                                     dtype=torch.int32)
        buf[6 * pad + _NHIST:] = torch.from_numpy(self._regs(cache))
        res = _Resident()
        res.cache = cache
        res.kn_name = kn.name
        res.record = cache._dirty = SlotRecord()
        res.shadow = rows.numpy()[:5, :nslots]
        res.buf = buf.to(self.device, copy=True)
        res.state = _split(res.buf, pad)
        res.trees = be.build_trees(res.state)
        res.dirty = be.new_dirty(pad, self.device)
        res.nslots = nslots
        res.pad = pad
        res.live = False
        res.dcount = 0
        self.counts["full_uploads"] += 1
        self.counts["upload_bytes"] += buf.numel() * 4
        return res

    def _delta(self, res):
        """Send the slots the host wrote since the last upload or
        scatter-back (the record's slots whose fields differ from the
        shadow) with the histogram and registers, and scatter them into
        the device copy. Returns the slots sent (ascending); None if one
        of their values does not fit int32 (the caller then uploads the
        whole cache, as the reference packs it)."""
        cache = res.cache
        keys = res.record.take()
        vals = np.stack([getattr(cache, f)[keys] for f in _FIELDS]) \
            .astype(np.int64)
        moved = (vals != res.shadow[:, keys]).any(axis=0)
        keys, vals = keys[moved], vals[:, moved]
        if vals.size and (vals.min() < np.iinfo(np.int32).min
                          or vals.max() > np.iinfo(np.int32).max):
            return None
        m = keys.size
        rec = np.empty(be.META + (1 + be.FIELDS) * m, np.int32)
        rec[:_NHIST] = cache._cnt_hist
        rec[_NHIST:be.META] = self._regs(cache)
        rec[be.META:be.META + m] = keys
        rec[be.META + m:] = vals.reshape(-1)
        res.shadow[:, keys] = vals
        be.scatter_slots(res.state, res.trees, self._to_device("delta", rec))
        self.counts["upload_deltas"] += m > 0
        self.counts["upload_slots"] += m
        self.counts["upload_bytes"] += rec.nbytes
        return keys

    def sync_kn(self, name: str) -> None:
        """Scatter a live KN's device changes back into its cache (the
        dirty slots' fields, the scalars, the histogram) and re-seed
        lazy-heap records for entries whose kind changed on device."""
        res = self.resident.get(name)
        if res is None or not res.live:
            return
        t0 = time.perf_counter()
        n = res.dcount
        h = self._to_host("sync", be.gather_dirty(res.state, res.dirty, n))
        hist = h[:_NHIST]
        regs = h[_NHIST:be.META]
        keys = h[be.META:be.META + n].astype(np.int64)
        vals = h[be.META + n:].reshape(be.FIELDS, n)
        if n and keys.max() >= res.nslots:
            raise RuntimeError(f"fused_window: {name}'s device copy wrote a "
                               f"pad slot")
        kind0 = res.shadow[0, keys]
        res.shadow[:, keys] = vals
        cache = res.cache
        kind, count, stamp, length, ptr = vals
        with sanitize.owned(res.kn_name):
            cache.kind[keys] = kind.astype(np.int8)
            cache.count[keys] = count
            cache.stamp[keys] = stamp
            cache.length[keys] = length
            cache.ptr[keys] = ptr
        cache._cnt_hist[:] = hist.tolist()
        cache.used = int(regs[be.R_USED])
        cache._clock = int(regs[be.R_CLOCK])
        cache._zero_shortcuts = int(regs[be.R_ZSHORT])
        cache._nvals = int(regs[be.R_NVALS])
        cache._nshort = int(regs[be.R_NSHORT])
        # entries whose kind survived keep their lazy-heap records
        # (stale stamps/counts self-heal on pop); changed kinds need
        # one fresh record to stay visible to victim selection, pushed
        # in key order (each heap's own order is all that matters)
        moved = kind != kind0
        for heap, kd, val in ((cache._lru, 2, stamp), (cache._lfu, 1, count)):
            sel = np.flatnonzero(moved & (kind == kd))
            if sel.size:
                sel = sel[np.argsort(keys[sel])]
                recs = zip(val[sel].tolist(), keys[sel].tolist())
                any(map(heapq.heappush, itertools.repeat(heap), recs))
        res.live = False
        res.dcount = 0
        self.counts["syncs"] += 1
        self.counts["sync_slots"] += n
        self.counts["sync_bytes"] += h.nbytes
        ENGINE_WALL["jit_sync"] += time.perf_counter() - t0

    def sync_all(self) -> None:
        for name in list(self.resident):
            self.sync_kn(name)

    # ----- promote threshold table ---------------------------------------
    def _vmax_for(self, cache) -> torch.Tensor:
        amr = float(cache.avg_miss_rts)
        t = self._vmax.get(amr)
        if t is None:
            if len(self._vmax) > 128:
                self._vmax.clear()
            t = torch.from_numpy(be.build_promote_table(
                amr, float(cache.avg_shortcut_hit_rts))).to(self.device)
            self._vmax[amr] = t
        return t

    # ----- the advance: every KN's dispatches, one launch a step ---------
    def advance(self, steps, host_window) -> None:
        """Drive ``steps`` -- (window, ``run_window`` generator, its ops),
        in KN order -- to their ends: each generator runs to its next
        dispatch, the dispatches of all go into one launch, and each
        folds its result and goes on, in KN order. A window the engine
        declines runs through ``host_window(window, ops)``."""
        active = []
        for w, gen, full in steps:
            self._step(w, gen, full, None, active, host_window)
        while active:
            outs = self._launch([job for *_, job in active])
            cur, active = active, []
            for (w, gen, full, _), out in zip(cur, outs):
                self._step(w, gen, full, out, active, host_window)

    @staticmethod
    def _step(w, gen, full, out, active, host_window) -> None:
        with sanitize.owned(w.kn.name):
            try:
                job = gen.send(out)
            except StopIteration as stop:
                if stop.value is False:
                    # ineligible window (int32 guards / too small)
                    host_window(w, full)
                return
        active.append((w, gen, full, job))

    def _launch(self, jobs) -> list[np.ndarray]:
        """One kernel-E launch over ``jobs``: their windows in through
        one copy, each job's packed result back through one; returns the
        results (views of the pinned buffer), in job order."""
        t0 = time.perf_counter()
        rows = np.concatenate([j.win.reshape(-1) for j in jobs])
        dwin = self._to_device("window", rows)
        wjobs = []
        off = 0
        for j in jobs:
            win = dwin[off:off + 6 * j.n].view(6, j.n)
            off += 6 * j.n
            r = j.res
            wjobs.append(be.WindowJob(r.state, tuple(win), j.n, j.cap,
                                      self.cluster.value_bytes, j.vmax,
                                      r.trees, r.dirty))
        outs = be.fused_windows(wjobs)
        host = self._to_host("out", outs.packed)
        self.counts["launches"] += 1
        ENGINE_WALL["jit_dispatch"] += time.perf_counter() - t0
        got, off = [], 0
        for j in jobs:
            size = be.HEADER + 2 * j.n + 1
            got.append(host[off:off + size])
            off += size
        return got

    # ----- window execution ----------------------------------------------
    def run_window(self, w, full, keys, kinds, plan, probe_map, dkeys,
                   dbuckets, out_values):
        """Execute one KN window (global positions ``full``) through the
        device engine, as a generator: it yields each prepared dispatch
        (``advance`` launches it) and is sent back the dispatch's packed
        result. Returns False when the window is ineligible (the caller
        runs it through the host engine untouched), else True."""
        kn, cache = w.kn, w.cache
        name = kn.name
        if full.size < MIN_SPAN and not self._live(name):
            return False
        c = self.cluster
        self._ensure_pm(probe_map, keys.shape[0], c.pool)
        if not self._live(name) and self._upload(kn, cache) is None:
            return False
        skeys = keys[full]
        sops = kinds[full]
        dpos = np.nonzero(sops == 2)[0]
        di = 0
        lo = 0
        nall = full.size
        stall = 0
        while lo < nall:
            while di < dpos.size and dpos[di] < lo:
                di += 1
            seg_end = int(dpos[di]) if di < dpos.size else nall
            if stall >= _STALL_CALLS:
                self._host_replay(kn, cache, full, skeys, sops, lo,
                                  nall, plan, probe_map, dkeys,
                                  dbuckets, out_values)
                return True
            if seg_end == lo:
                # the op is a delete: segcache pops and invalidation
                # order stay host-side
                self._host_replay(kn, cache, full, skeys, sops, lo,
                                  lo + 1, plan, probe_map, dkeys,
                                  dbuckets, out_values)
                lo += 1
                continue
            if seg_end - lo < MIN_SPAN and not self._live(name):
                # too short to pay a fresh upload: run through the
                # next delete on host, then resume
                host_end = min(seg_end + 1, nall)
                self._host_replay(kn, cache, full, skeys, sops, lo,
                                  host_end, plan, probe_map, dkeys,
                                  dbuckets, out_values)
                lo = host_end
                continue
            if not self._live(name) and self._upload(kn, cache) is None:
                self._host_replay(kn, cache, full, skeys, sops, lo,
                                  nall, plan, probe_map, dkeys,
                                  dbuckets, out_values)
                return True
            res = self.resident[name]
            n = min(seg_end - lo, W_MAX)
            job = self._prepare(kn, cache, res, full, skeys, sops, lo, n,
                                plan, dkeys, dbuckets)
            packed = yield job
            ne, cut = self._finish(kn, cache, job, packed, plan, out_values)
            lo += ne
            if cut:
                stall = stall + 1 if ne < _STALL_NE else 0
                r_end = min(lo + REPLAY_OPS, seg_end)
                self._host_replay(kn, cache, full, skeys, sops, lo,
                                  r_end, plan, probe_map, dkeys,
                                  dbuckets, out_values)
                lo = r_end
            else:
                stall = 0
        return True

    def _host_replay(self, kn, cache, full, skeys, sops, lo, hi, plan,
                     probe_map, dkeys, dbuckets, out_values) -> None:
        """Hand [lo, hi) to the host engine's exact per-op machinery
        (scattering the device state back first)."""
        if hi <= lo:
            return
        self.sync_kn(kn.name)
        self.counts["host_replays"] += 1
        self.cluster._replay_span(kn, cache, True, full[lo:hi],
                                  skeys[lo:hi], sops[lo:hi], plan,
                                  probe_map, dkeys, dbuckets,
                                  out_values)

    # ----- one device dispatch: prepare, then fold ------------------------
    def _prepare(self, kn, cache, res, full, skeys, sops, lo, n, plan,
                 dkeys, dbuckets) -> _Job:
        t0 = time.perf_counter()
        hi = lo + n
        spos = full[lo:hi]
        ck = skeys[lo:hi]
        # the six op arrays as the rows of one (6, n) int32 block
        win = np.zeros((6, n), np.int32)
        ops32, keys32, wptr32, pmp, pml, seg0 = win
        ops32[:] = sops[lo:hi]                 # deletes were clamped out
        keys32[:] = ck
        if plan.nw:
            wr = plan.wrank[spos]
            wptr32[:] = plan.ptrs[np.maximum(wr, 0)]
        pm = self._pm_ptr[spos].copy()
        pml[:] = self._pm_len[spos]
        # a prefetch stays valid only while its key and bucket are
        # untouched by mid-batch merges (the pool's dirty sets); only
        # the window's prefetched positions are looked up
        if dkeys or dbuckets:
            at = np.flatnonzero(pm != be.PM_INVALID)
            if at.size:
                kl = ck[at].tolist()
                bl = self._pm_bucket[spos[at]].tolist()
                stale = [k in dkeys or b in dbuckets
                         for k, b in zip(kl, bl)]
                pm[at[np.array(stale, bool)]] = be.PM_INVALID
        pmp[:] = pm
        # a read may find its key in the segment cache (writes do not
        # look): the window's reads looked up in it as they stand
        segd = kn.segcache
        if segd:
            rd = np.flatnonzero(ops32 == 0)
            if rd.size:
                seg0[rd] = np.fromiter(
                    (k in segd for k in ck[rd].tolist()), bool, rd.size)
        job = _Job()
        job.res, job.win, job.n, job.cap = res, win, n, cache.capacity
        job.vmax = self._vmax_for(cache)
        job.spos, job.ck = spos, ck
        ENGINE_WALL["jit_prep"] += time.perf_counter() - t0
        return job

    def _finish(self, kn, cache, job, host, plan, out_values):
        """Read one dispatch's packed result and fold it; returns
        (n_exec, cut)."""
        t0 = time.perf_counter()
        res, n = job.res, job.n
        ne, cut = int(host[0]), int(host[1])
        if cut == be.CUT_BAD_KEY:
            raise RuntimeError(f"fused_window: a key of {kn.name}'s window "
                               f"lies outside its {res.pad} slots")
        regs = host[2:be.HEADER]
        events = host[be.HEADER:be.HEADER + ne]
        out_ptr = host[be.HEADER + n:be.HEADER + n + ne]
        res.dcount = int(host[be.HEADER + 2 * n])
        self.counts["dispatches"] += 1
        self.counts["dispatched_ops"] += ne
        if cut:
            self.counts[f"cut_{_CUT_NAMES[cut]}"] += 1
        self._fold(kn, cache, res, job.spos[:ne], job.ck[:ne], events,
                   out_ptr, regs, plan, out_values)
        ENGINE_WALL["jit_fold"] += time.perf_counter() - t0
        return ne, cut

    def _fold(self, kn, cache, res, ps, ks, ev, out_ptr, regs, plan,
              out_values) -> None:
        """Fold one executed prefix into the host bookkeeping exactly
        as the host engine would have: stats, RT sums (integer-valued
        floats, so grouping cannot change the result), the sequential
        miss-EMA refold in op order, ordered segment-cache puts, and
        collected read values."""
        ne = ev.size
        if ne == 0:
            return
        st = kn.stats
        cs = cache.stats
        cnt = np.bincount(ev, minlength=6)
        nwr = int(cnt[be.EV_WRITE])
        npr = int(cnt[be.EV_PROMOTE])
        nsh = int(cnt[be.EV_SHORTCUT_HIT])
        st.ops += ne
        st.reads += ne - nwr
        st.writes += nwr
        cs.value_hits += int(cnt[be.EV_VALUE_HIT])
        cs.shortcut_hits += nsh + npr
        cs.promotions += npr
        cs.misses += int(cnt[be.EV_MISS_FILL]) + int(cnt[be.EV_MISS_ABSENT])
        cs.demotions += int(regs[be.R_DEMOTIONS]) - res.demo0
        cs.evictions += int(regs[be.R_EVICTIONS]) - res.evic0
        res.demo0 = int(regs[be.R_DEMOTIONS])
        res.evic0 = int(regs[be.R_EVICTIONS])
        rts = float(nsh + npr)                 # shortcut chases: 1 RT
        mf = np.nonzero(ev == be.EV_MISS_FILL)[0]
        if mf.size:
            pr = self._pm_probes[ps[mf]]
            rts += float(pr.sum()) + mf.size   # traversal + value fetch
            ema = cache._ema
            a = cache.avg_miss_rts
            for r in pr.tolist():              # EMA refold in op order
                a += ema * (r + 1.0 - a)
            cache.avg_miss_rts = a
            if int(regs[be.R_EMA_DIRTY]):
                # the threshold table is rebuilt from the new EMA, so
                # the device's staleness latch can drop: the eight
                # registers go back to the device
                regs = regs.copy()
                regs[be.R_EMA_DIRTY] = 0
                res.state[7].copy_(torch.from_numpy(regs))
        ma = np.nonzero(ev == be.EV_MISS_ABSENT)[0]
        if ma.size:
            rts += float(self._pm_probes[ps[ma]].sum())
        wsel = np.nonzero(ev == be.EV_WRITE)[0]
        if wsel.size:
            wr = plan.wrank[ps[wsel]]
            rts += float(plan.rts[wr].sum())
            segd = kn.segcache
            vb = self.cluster.value_bytes
            kw = ks[wsel].tolist()
            segd.update(zip(kw, ((p, vb) for p in
                                 plan.ptrs[wr].tolist())))
            # C-level move_to_end sweep keeps last-put order; trimming
            # afterwards equals per-put trimming (LRU invariant)
            any(map(segd.move_to_end, kw))
            cap = kn.segcache_cap
            while len(segd) > cap:
                segd.popitem(last=False)
        st.rts += rts
        if out_values is not None:
            hv = self.cluster.pool.heap_val
            rsel = np.nonzero(ev <= be.EV_MISS_FILL)[0]
            for p_, q in zip(ps[rsel].tolist(),
                             out_ptr[rsel].tolist()):
                out_values[p_] = hv[q]


def _split(buf, pad: int):
    """The state tuple as views of one packed buffer (numpy or torch)."""
    cut = [j * pad for j in range(7)] + [6 * pad + _NHIST,
                                         6 * pad + _NHIST + be.NUM_REGS]
    return tuple(buf[a:b] for a, b in zip(cut[:-1], cut[1:]))
