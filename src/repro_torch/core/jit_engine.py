"""The compiled batch engine: ``execute_batch(engine="jit")``.

The port's copy of the reference's engine (``repro.core.jit_engine``).
Each KN window of the batched data plane runs through kernel E
(``kernels.batch_executor.fused_window``) instead of the host planner:
the window's DAC transitions -- value/shortcut hits, Eq. 1 promotions
with the full make-space loop, prefetch-resolved misses, staged write
fills -- execute as one launch over the KN's per-key state on the
cluster's device, and the host only folds the outcome (stats, RT sums,
the miss-EMA refold in op order, segment-cache puts, collected read
values) from the returned per-op event records. With ``device="cpu"``
the state is CPU tensors and the wrapper runs its plain version.

Residency model
---------------
A KN's cache state (kind/count/stamp/length/ptr plus a wrote-this-batch
flag, the histogram and the registers: one int32 buffer on the device)
is uploaded once per batch on first use, with the two victim min-trees
the kernel keeps (built on the card at the upload), and stays resident
across that KN's windows; each launch updates state and trees in place.
It is scattered back to the host cache arrays whenever the host must
touch the cache:

  * a truncation cut (the residual replays through the host engine),
  * a host-run span (deletes, short segments, degenerate progress),
  * a replicated-key op or batch end (``sync_all``).

Scatter-back rewrites the dense arrays and re-seeds the cache's *lazy*
LRU/LFU heaps with one record per entry whose kind changed on device;
entries whose kind survived keep their existing records, which the
lazy pop discipline self-heals (stale stamp/count records refresh on
pop). The engine is decision-for-decision identical to the host
engine (tests/test_torch_jit_engine.py holds it to the reference's jit
engine and to the port's host engine).

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
the host engine when any could overflow, as the reference's do. The
Eq. 1 float comparison is discretized host-side into an integer
threshold table (kept on the device per miss-RT EMA value), so no float
arithmetic runs on the device.

Transfers: an upload is one host-to-device copy of the packed state; a
dispatch copies the window's ``n`` live entries of its six op arrays in
(one copy, no padding) and brings n_exec, the cut, the registers and the
``n`` entries' events and out_ptr back in one copy (after a cut the
entries past n_exec come too, unread: a copy sized by n_exec would wait
on a second synchronisation); a scatter-back is one copy of the packed
state.
"""

from __future__ import annotations

import heapq
import time

import numpy as np
import torch

from ..kernels import batch_executor as be
from . import sanitize
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


def new_counts() -> dict:
    """The engine's event counts: dispatches (kernel-E calls), uploads
    (state moved to the device), syncs (scatter-backs), host replays and
    cuts by reason."""
    return {"dispatches": 0, "uploads": 0, "syncs": 0, "host_replays": 0,
            "dispatched_ops": 0,
            **{f"cut_{v}": 0 for v in _CUT_NAMES.values()}}


class _Resident:
    """One KN's device-resident cache state within a batch."""

    __slots__ = ("cache", "kn_name", "buf", "state", "trees", "nslots",
                 "kind0", "demo0", "evic0")


class JitEngine:
    """Per-cluster engine; created lazily on the first jit batch."""

    def __init__(self, cluster):
        self.cluster = cluster
        self.device = cluster.device
        self.resident: dict[str, _Resident] = {}
        self._vmax: dict[float, torch.Tensor] = {}   # amr -> device table
        self._pm_token = None                        # probe_map identity
        self._pm_ptr = self._pm_len = None
        self._pm_probes = self._pm_bucket = None
        self.counts = new_counts()

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
    def _upload(self, kn, cache, plan):
        """Pack the cache into device state; None if the int32 ranges
        (or a non-positive capacity) rule the device program out."""
        t0 = time.perf_counter()
        nslots = cache.kind.shape[0]
        if not (0 < cache.capacity < _GUARD):
            return None
        if cache._clock >= _GUARD or nslots >= _I31:
            return None
        if len(self.cluster.pool.heap_val) >= _I31:
            return None        # covers every staged/prefetched pointer
        live = cache.kind != 0
        if live.any():
            if int(cache.count[live].max()) >= _GUARD:
                return None
            if int(cache.ptr[live].max()) >= _I31:
                return None
            if int(cache.length[live].max()) >= _GUARD:
                return None
        # the victim trees want a power-of-two leaf count; pad with
        # absent entries (never addressed: keys are < nslots)
        pad = 2
        while pad < nslots:
            pad <<= 1
        # one buffer: kind, count, stamp, length, ptr, wrote (pad each),
        # the histogram, the registers (int32, as init_state packs them)
        buf = np.zeros(6 * pad + _NHIST + be.NUM_REGS, np.int32)
        for j, a in enumerate((cache.kind, cache.count, cache.stamp,
                               cache.length, cache.ptr)):
            buf[j * pad:j * pad + nslots] = a
        buf[6 * pad:6 * pad + _NHIST] = cache._cnt_hist
        regs = buf[6 * pad + _NHIST:]
        regs[be.R_USED] = cache.used
        regs[be.R_CLOCK] = cache._clock
        regs[be.R_ZSHORT] = cache._zero_shortcuts
        regs[be.R_NVALS] = cache._nvals
        regs[be.R_NSHORT] = cache._nshort
        res = _Resident()
        res.cache = cache
        res.kn_name = kn.name
        res.kind0 = buf[:pad].copy()              # host int32 shadow
        res.buf = torch.from_numpy(buf).to(self.device)
        res.state = _split(res.buf, pad)
        res.trees = be.build_trees(res.state)
        res.nslots = nslots
        res.demo0 = 0
        res.evic0 = 0
        self.counts["uploads"] += 1
        ENGINE_WALL["jit_upload"] += time.perf_counter() - t0
        return res

    def sync_kn(self, name: str) -> None:
        """Scatter a resident KN's device state back into its cache
        (arrays, scalars, histogram) and re-seed lazy-heap records for
        entries whose kind changed on device."""
        res = self.resident.pop(name, None)
        if res is None:
            return
        t0 = time.perf_counter()
        buf = res.buf.cpu().numpy()
        kind, count, stamp, length, ptr, _wrote, hist, regs = \
            _split(buf, res.kind0.shape[0])
        cache = res.cache
        ns = res.nslots
        with sanitize.owned(res.kn_name):
            # device arrays are padded to a power of two; only the
            # first ns slots are real (pad entries are never addressed)
            cache.kind[:ns] = kind[:ns].astype(np.int8)
            cache.count[:ns] = count[:ns]
            cache.stamp[:ns] = stamp[:ns]
            cache.length[:ns] = length[:ns]
            cache.ptr[:ns] = ptr[:ns]
        cache._cnt_hist[:] = hist.tolist()
        cache.used = int(regs[be.R_USED])
        cache._clock = int(regs[be.R_CLOCK])
        cache._zero_shortcuts = int(regs[be.R_ZSHORT])
        cache._nvals = int(regs[be.R_NVALS])
        cache._nshort = int(regs[be.R_NSHORT])
        # entries whose kind survived keep their lazy-heap records
        # (stale stamps/counts self-heal on pop); changed kinds need
        # one fresh record to stay visible to victim selection
        lru, lfu = cache._lru, cache._lfu
        for k in np.nonzero(kind != res.kind0)[0].tolist():
            kd = int(kind[k])
            if kd == 2:
                heapq.heappush(lru, (int(stamp[k]), k))
            elif kd == 1:
                heapq.heappush(lfu, (int(count[k]), k))
        self.counts["syncs"] += 1
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

    # ----- window execution ----------------------------------------------
    def run_window(self, w, full, keys, kinds, plan, probe_map, dkeys,
                   dbuckets, out_values) -> bool:
        """Execute one KN window (global positions ``full``) through
        the device engine. Returns False when the window is ineligible
        (the caller runs it through the host engine untouched)."""
        kn, cache = w.kn, w.cache
        name = kn.name
        if full.size < MIN_SPAN and name not in self.resident:
            return False
        c = self.cluster
        self._ensure_pm(probe_map, keys.shape[0], c.pool)
        if name not in self.resident:
            res = self._upload(kn, cache, plan)
            if res is None:
                return False
            self.resident[name] = res
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
            if seg_end - lo < MIN_SPAN and name not in self.resident:
                # too short to pay a fresh upload: run through the
                # next delete on host, then resume
                host_end = min(seg_end + 1, nall)
                self._host_replay(kn, cache, full, skeys, sops, lo,
                                  host_end, plan, probe_map, dkeys,
                                  dbuckets, out_values)
                lo = host_end
                continue
            if name not in self.resident:
                res = self._upload(kn, cache, plan)
                if res is None:
                    self._host_replay(kn, cache, full, skeys, sops, lo,
                                      nall, plan, probe_map, dkeys,
                                      dbuckets, out_values)
                    return True
                self.resident[name] = res
            res = self.resident[name]
            n = min(seg_end - lo, W_MAX)
            ne, cut = self._dispatch(kn, cache, res, full, skeys, sops,
                                     lo, n, plan, dkeys, dbuckets,
                                     out_values)
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

    # ----- one device dispatch + host fold --------------------------------
    def _dispatch(self, kn, cache, res, full, skeys, sops, lo, n, plan,
                  dkeys, dbuckets, out_values):
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
        # untouched by mid-batch merges (the pool's dirty sets)
        if dkeys:
            dk = np.fromiter(dkeys, np.int64, len(dkeys))
            pm[np.isin(ck, dk)] = be.PM_INVALID
        if dbuckets:
            db = np.fromiter(dbuckets, np.int64, len(dbuckets))
            pm[np.isin(self._pm_bucket[spos], db)] = be.PM_INVALID
        pmp[:] = pm
        segd = kn.segcache
        if segd:
            sk = np.fromiter(segd.keys(), np.int64, len(segd))
            seg0[:] = np.isin(ck, sk)
        vmax = self._vmax_for(cache)
        window = torch.from_numpy(win).to(self.device)
        ENGINE_WALL["jit_prep"] += time.perf_counter() - t0

        t0 = time.perf_counter()
        out = be.fused_window(res.state, *window, n, cache.capacity,
                              self.cluster.value_bytes, vmax,
                              trees=res.trees)
        host = out.packed.cpu().numpy()        # the one copy back
        ne, cut = int(host[0]), int(host[1])
        if cut == be.CUT_BAD_KEY:
            raise RuntimeError(f"fused_window: a key of {kn.name}'s window "
                               f"lies outside its {res.kind0.size} slots")
        regs = host[2:be.HEADER]
        events = host[be.HEADER:be.HEADER + ne]
        out_ptr = host[be.HEADER + n:be.HEADER + n + ne]
        self.counts["dispatches"] += 1
        self.counts["dispatched_ops"] += ne
        if cut:
            self.counts[f"cut_{_CUT_NAMES[cut]}"] += 1
        ENGINE_WALL["jit_dispatch"] += time.perf_counter() - t0

        t0 = time.perf_counter()
        self._fold(kn, cache, res, spos[:ne], ck[:ne], events, out_ptr,
                   regs, plan, out_values)
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
