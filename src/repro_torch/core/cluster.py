"""The KN side of the cluster that one planned DAC window reads and
writes (the port's copy of the parts of the reference's
``core/cluster.py`` that ``core.transition.plan_dac_window`` and its
bulk apply touch): the KN's statistics, the staged write plane of a
batch, the KN's window state (its ArrayDAC and its cache of committed
log entries, the segcache), the apply of a planned window, and a bulk
warm-up of the KN's cache.

Routing, ownership, reconfiguration, the write-plane staging and the
per-op replay of windows the planner cannot prove are the rest of the
cluster's host engine; they are not ported yet.
"""

from __future__ import annotations

from collections import OrderedDict
from dataclasses import dataclass

import numpy as np

from .dac import SHORTCUT_BYTES, VALUE_OVERHEAD_BYTES, ArrayDAC


@dataclass
class KNStats:
    ops: int = 0
    rts: float = 0.0
    reads: int = 0
    writes: int = 0
    write_stalls: int = 0
    refused: int = 0

    def reset_window(self):
        self.ops = 0
        self.rts = 0.0
        self.reads = 0
        self.writes = 0


class _WritePlan:
    """One batch's staged write plane: per-write pointers and flush RTs
    in global write order (``wrank`` maps a batch position to its write
    rank), rotation events for the coordinator to replay, and per-KN
    write positions for the stall scan."""
    __slots__ = ("nw", "ptrs", "rts", "wrank", "wkeys", "rotations",
                 "wpos_by_name", "segq", "rot_done", "staged",
                 "ptrs_l", "rts_l", "wrank_l")

    def __init__(self):
        self.nw = 0
        self.ptrs = None
        self.rts = None
        self.wrank = None
        self.wkeys = None
        self.ptrs_l = None
        self.rts_l = None
        self.wrank_l = None
        self.rotations: list = []
        self.wpos_by_name: dict = {}
        self.segq: dict = {}       # kn -> [(segment, lo, hi) ranges]
        self.rot_done: dict = {}   # kn -> rotations executed so far
        self.staged: dict = {}     # kn -> (logical_keys, ptrs) lists


class KVSNode:
    """One KN's window state: its ArrayDAC, its segcache and its stats."""

    def __init__(self, name: str, cache_bytes: int, segcache_cap: int,
                 initial_keys: int = 1024):
        self.name = name
        self.cache = ArrayDAC(cache_bytes, initial_keys=initial_keys)
        # committed/un-merged segments cached locally (paper Sec. 4):
        # keys here are readable with zero RTs at the writing KN.
        self.segcache: OrderedDict[int, tuple[int, int]] = OrderedDict()
        self.segcache_cap = segcache_cap
        self.stats = KNStats()

    def _segcache_put(self, key: int, ptr: int, length: int):
        self.segcache[key] = (ptr, length)
        self.segcache.move_to_end(key)
        while len(self.segcache) > self.segcache_cap:
            self.segcache.popitem(last=False)


def apply_window_plan(kn, cache, wp, out_values, value_bytes) -> None:
    """Apply a planned window: bulk cache mutation via apply_plan,
    then the kn-side effects (stats, miss-RT EMA in op order,
    segcache puts/pops, collected read values)."""
    cache.apply_plan(wp)
    st = kn.stats
    st.ops += wp.ops
    st.reads += wp.reads
    st.writes += wp.writes
    st.rts += wp.rts
    if wp.ema_rts:
        ema = cache._ema
        a = cache.avg_miss_rts
        for r in wp.ema_rts:
            a += ema * (r - a)
        cache.avg_miss_rts = a
    segd = kn.segcache
    cap = kn.segcache_cap
    if wp.seg_replay is not None:
        vb = value_bytes
        for k, p in wp.seg_replay:
            if p is None:
                segd.pop(k, None)
            else:
                segd[k] = (p, vb)
                segd.move_to_end(k)
                while len(segd) > cap:
                    segd.popitem(last=False)
    elif wp.seg_puts is not None:
        ks, ps = wp.seg_puts
        vb = value_bytes
        segd.update(zip(ks, ((p, vb) for p in ps)))
        # C-level move_to_end sweep keeps last-put order; trimming
        # afterwards equals per-put trimming (LRU invariant)
        any(map(segd.move_to_end, ks))
        while len(segd) > cap:
            segd.popitem(last=False)
    if out_values is not None and wp.out_vals:
        for p, v in wp.out_vals:
            out_values[p] = v


def warm_load(cache, value_keys, value_ptrs, shortcut_keys, shortcut_ptrs,
              length: int) -> None:
    """Warm an empty ArrayDAC in bulk: the state that
    ``fill_after_miss(k, p, length)`` for each value key in order, then
    ``fill_after_write(k, p, length, segment_cached=False)`` for each
    shortcut key in ascending order leave when everything fits -- the
    load-through-KN warm-up of the reference's ``load(warm=True)``
    (a shortcut for every key loaded), with the hottest keys as values.
    Values arrive with count 1 and ascending stamps, shortcuts with count
    0; both heap record lists are ascending, hence valid heaps."""
    value_keys = np.asarray(value_keys, np.int64)
    shortcut_keys = np.asarray(shortcut_keys, np.int64)
    nv, ns = value_keys.size, shortcut_keys.size
    gross = length + VALUE_OVERHEAD_BYTES
    if cache.used or cache.num_values or cache.num_shortcuts:
        raise ValueError("warm_load needs an empty cache")
    if nv * gross + ns * SHORTCUT_BYTES > cache.capacity:
        raise ValueError("the warm set does not fit the cache")
    if np.unique(np.concatenate([value_keys, shortcut_keys])).size != nv + ns:
        raise ValueError("warm keys repeat")
    if ns > 1 and not (np.diff(shortcut_keys) > 0).all():
        raise ValueError("shortcut keys must ascend")
    cache._ensure(int(max(value_keys.max(initial=0),
                          shortcut_keys.max(initial=0))))
    stamps = cache._clock + np.arange(nv, dtype=np.int64)
    for keys, ptrs, kind, cnt in (
            (value_keys, value_ptrs, cache.KIND_VALUE, 1),
            (shortcut_keys, shortcut_ptrs, cache.KIND_SHORTCUT, 0)):
        cache.kind[keys] = kind
        cache.ptr[keys] = ptrs
        cache.length[keys] = length
        cache.count[keys] = cnt
    cache.stamp[value_keys] = stamps
    cache._lru = list(zip(stamps.tolist(), value_keys.tolist()))
    cache._lfu = list(zip([0] * ns, shortcut_keys.tolist()))
    cache._clock += nv
    cache.used = nv * gross + ns * SHORTCUT_BYTES
    cache._nvals, cache._nshort, cache._zero_shortcuts = nv, ns, ns
    cache._cnt_hist[0] += ns
