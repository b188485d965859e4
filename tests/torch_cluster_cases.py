"""The state of a DINOMO cluster as plain Python values, for holding two
clusters equal: the reference's and the port's in the CPU parity tests,
a batched cluster and its per-op twin in chip_smoke.py's ``cluster``
phase. numpy only; it imports neither package, and reads the attributes
both clusters share."""

import dataclasses

import numpy as np


def cluster_snapshot(c) -> dict:
    """Per-KN statistics and segcache sizes, the pool's GC counters, the
    metadata-server op count and the write sequence (the reference's
    tests/test_writeplane.py:cluster_snapshot)."""
    out = {}
    for n, kn in sorted(c.kns.items()):
        cs = kn.cache.stats
        out[n] = (kn.stats.ops, kn.stats.rts, kn.stats.reads,
                  kn.stats.writes, kn.stats.write_stalls,
                  kn.stats.refused,
                  cs.value_hits, cs.shortcut_hits, cs.misses,
                  cs.promotions, cs.demotions, cs.evictions,
                  len(kn.segcache))
    out["gc"] = (c.pool.gc.segments_created,
                 c.pool.gc.segments_collected,
                 c.pool.gc.entries_merged)
    out["ms"] = c.ms_ops
    out["seq"] = c._seq
    return out


def cache_state(cache, heaps: bool = True) -> tuple:
    """Every decision-bearing field of a KN cache: a reference ``DAC``'s
    entries (values in LRU order) and heap, or an ``ArrayDAC``'s live
    per-key vectors, heaps, clock and counters; then the occupancy, the
    miss-RT average and the statistics. The static and Clover caches
    likewise (``static_state``, ``clover_state``). ``heaps=False`` leaves
    out the lazy heaps' records, which the compiled engine re-seeds at
    its scatter-back (same pops, other records) and the host engine does
    not."""
    if hasattr(cache, "value_cap"):
        return static_state(cache, heaps)
    if hasattr(cache, "cap_entries"):
        return clover_state(cache, heaps)
    common = (cache.capacity, cache.used, cache.avg_miss_rts,
              dataclasses.astuple(cache.stats))
    if hasattr(cache, "values"):
        return ("dac", common,
                [(k, e.ptr, e.length, e.count)
                 for k, e in cache.values.items()],
                sorted((k, e.ptr, e.length, e.count)
                       for k, e in cache.shortcuts.items()),
                list(cache._lfu))
    live = np.flatnonzero(cache.kind)
    return ("array", common, live.tolist(),
            np.asarray(cache.kind)[live].tolist(),
            np.asarray(cache.ptr)[live].tolist(),
            np.asarray(cache.length)[live].tolist(),
            np.asarray(cache.count)[live].tolist(),
            np.asarray(cache.stamp)[live].tolist(),
            (list(cache._lru), list(cache._lfu)) if heaps else None,
            cache._clock,
            cache._nvals, cache._nshort, cache._zero_shortcuts,
            list(cache._cnt_hist))


def static_state(cache, heaps: bool = True) -> tuple:
    """A static-split cache: a ``StaticCache``'s two sides in LRU order,
    or an ``ArrayStaticCache``'s live per-key vectors, heaps, clock and
    counts; then the side capacities, their occupancy and the
    statistics."""
    common = (cache.value_cap, cache.shortcut_cap, cache.value_used,
              cache.shortcut_used, dataclasses.astuple(cache.stats))
    if hasattr(cache, "values"):
        return ("static", common,
                [(k, e.ptr, e.length) for k, e in cache.values.items()],
                [(k, e.ptr, e.length) for k, e in cache.shortcuts.items()])
    live = np.flatnonzero(cache.kind)
    return ("array_static", common, live.tolist(),
            np.asarray(cache.kind)[live].tolist(),
            np.asarray(cache.ptr)[live].tolist(),
            np.asarray(cache.length)[live].tolist(),
            np.asarray(cache.stamp)[live].tolist(),
            (list(cache._vlru), list(cache._slru)) if heaps else None,
            cache._clock, cache._nvals, cache._nshort)


def clover_state(cache, heaps: bool = True) -> tuple:
    """A Clover cache: a ``CloverCache``'s entries (key, version) in LRU
    order, or an ``ArrayCloverCache``'s live keys with their versions
    and stamps, its heap, clock and count; then the capacity and the
    statistics."""
    common = (cache.cap_entries, dataclasses.astuple(cache.stats))
    if hasattr(cache, "entries"):
        return ("clover", common, list(cache.entries.items()))
    live = np.flatnonzero(cache.present)
    return ("array_clover", common, live.tolist(),
            np.asarray(cache.ver)[live].tolist(),
            np.asarray(cache.stamp)[live].tolist(),
            list(cache._lru) if heaps else None, cache._clock, cache._n)


def cache_contents(cache) -> tuple:
    """What a static or Clover cache holds, alike for the per-op oracle
    and the array-backed cache: each side's (or Clover's) entries in LRU
    order (an array cache's live keys by stamp), the occupancy and the
    statistics."""
    stats = dataclasses.astuple(cache.stats)
    if hasattr(cache, "entries"):
        return ("clover", stats, list(cache.entries.items()))
    if hasattr(cache, "present"):
        live = np.flatnonzero(cache.present)
        live = live[np.argsort(cache.stamp[live], kind="stable")]
        return ("clover", stats,
                list(zip(live.tolist(), cache.ver[live].tolist())))
    used = (cache.value_used, cache.shortcut_used)
    if hasattr(cache, "values"):
        return ("static", stats, used,
                [(k, e.ptr, e.length) for k, e in cache.values.items()],
                [(k, e.ptr, e.length) for k, e in cache.shortcuts.items()])
    sides = []
    for kind in (2, 1):
        ks = np.flatnonzero(cache.kind == kind)
        ks = ks[np.argsort(cache.stamp[ks], kind="stable")]
        sides.append(list(zip(ks.tolist(), cache.ptr[ks].tolist(),
                              cache.length[ks].tolist())))
    return ("static", stats, used, *sides)


def pool_index(pool) -> tuple:
    """The pool's host index row for row, and its indirection table."""
    ix = pool.index
    return (np.asarray(ix.keys).tolist(), np.asarray(ix.ptrs).tolist(),
            np.asarray(ix.nxt).tolist(), ix.overflow_head, ix.size,
            ix.version, dict(pool.indirect))


def cluster_state(c, heaps: bool = True) -> dict:
    """Everything two clusters on one op stream must agree on: the
    snapshot and aggregate statistics, each KN's soft state and cache
    (``heaps``: with its lazy heaps' records, see cache_state),
    ownership (ring, replication, fences, the route's random state), the
    reconfiguration log, the write counters and the pool (index, heap,
    logs, merge backlog, policy metadata)."""
    pool = c.pool
    return {
        "snapshot": cluster_snapshot(c),
        "aggregate": c.aggregate_stats(),
        "kns": {n: (kn.alive, kn.available, kn.fence_token,
                    kn._pending_flush, list(kn.segcache.items()),
                    cache_state(kn.cache, heaps))
                for n, kn in sorted(c.kns.items())},
        "ring": (list(c.ownership.ring._points),
                 list(c.ownership.ring._owners)),
        "replicated": dict(c.ownership.replicated),
        "fence": dict(c.ownership.fence),
        "ownership_version": c.ownership.version,
        "rng": c.rng.getstate(),
        "reconfig_log": c.reconfig_log,
        "versions": dict(c.versions),
        "ms_ops": c.ms_ops,
        "index": pool_index(pool),
        "heap": (list(pool.heap_val), list(pool.heap_len)),
        "logs": {n: [(s.entries, s.sealed, s.valid, s.merged_upto)
                     for s in segs]
                 for n, segs in sorted(pool.segments.items())},
        "backlog": [(s.kn, s.merged_upto, len(s.entries))
                    for s, _ in pool.merge_backlog],
        "pool_fence": dict(pool.fence),
        "policy_metadata": pool.policy_metadata,
    }


def mirror_equals_host(pool) -> None:
    """The pool's packed copy of its index (``index_dev``, brought level
    by ``sync_index``: the rows the host index noted) holds the host
    index row for row."""
    t = pool.sync_index()
    ix = pool.index
    lines = t.lines.cpu().numpy()
    np.testing.assert_array_equal(lines[:, :3], ix.keys)
    np.testing.assert_array_equal(lines[:, 3:6], ix.ptrs)
    np.testing.assert_array_equal(lines[:, 6], ix.nxt)
    assert int(t.overflow_head) == ix.overflow_head
    assert t.num_buckets == ix.num_buckets


def loaded_like(c, pool, keys) -> None:
    """Cluster ``c``, built (not loaded) with the arguments of the
    cluster whose loaded pool ``pool`` copies, as if it had loaded
    ``keys`` warm itself: a load leaves the pool alike for every variant
    (``bulk_load`` reads none, and the KNs, their fences and the ring
    follow from the arguments), so ``c`` takes the copy and warms its
    caches by its own variant's rule."""
    c.pool = pool
    c.device = pool.device
    for kn in c.kns.values():
        kn.pool = pool
    c._warm(list(keys))


def batch_result(res) -> tuple:
    """Every field of a BatchResult."""
    return (res.executed, res.writes, res.per_kn,
            np.asarray(res.executed_keys).tolist(), res.values)
