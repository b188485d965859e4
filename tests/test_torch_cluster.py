"""Port parity for the cluster's host engine, per-op side:
repro_torch.core.cluster.DinomoCluster (the four variants: dinomo,
dinomo-s, dinomo-n, clover) against the reference's DinomoCluster, as
twin clusters built with the same arguments and seed (the port's with
``device="cpu"``) and driven by the reference's own op streams:
tests/test_cluster.py's ``run_mixed``, its TestVariants cases, its
reconfiguration cases (add, remove, fail, participants only, data
movement) and its selective-replication cases, with both caches
(``reference_cache`` False and True). After every step the twins'
returns and whole states (tests/torch_cluster_cases.py:cluster_state:
statistics, caches, ownership, the route's random state, the
reconfiguration log, the pool's index row for row, heap and logs) are
equal. Also: every cache policy built, the static and Clover caches
against the reference's decision for decision, the ring's vectorized
owners, the M-node's decisions, the warm load (the DAC's in bulk
against the per-key loop, the baselines' key by key), and a cluster
that takes a copy of another's loaded pool against one loaded
itself. Exact comparisons throughout:
every value here is an integer or a host decision."""

import dataclasses
import pickle

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

torch = pytest.importorskip("torch")

from repro.core import cluster as jcl  # noqa: E402
from repro.core import dac as jdac  # noqa: E402
from repro.core import hashring as jh  # noqa: E402
from repro.core import mnode as jm  # noqa: E402
from repro.core import sanitize as js  # noqa: E402
from repro_torch.core import cluster as tcl  # noqa: E402
from repro_torch.core import dac as tdac  # noqa: E402
from repro_torch.core import hashring as th  # noqa: E402
from repro_torch.core import mnode as tm  # noqa: E402
from repro_torch.core import sanitize as ts  # noqa: E402
from torch_cluster_cases import (batch_result, cache_state,  # noqa: E402
                                 cluster_state, loaded_like)

VARIANTS = ("dinomo", "dinomo-s", "dinomo-n", "clover")
BASELINES = ("dinomo-s", "clover")
REFERENCE_CACHE = (False, True)


def plain(x):
    """A return value with the two packages' dataclasses as tuples."""
    if isinstance(x, (jcl.BatchResult, tcl.BatchResult)):
        return batch_result(x)
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return (type(x).__name__, plain(dataclasses.astuple(x)))
    if isinstance(x, (tuple, list)):
        return type(x)(plain(v) for v in x)
    if isinstance(x, set):
        return sorted(x)
    return x


class Twin:
    """The reference's cluster and the port's, built alike."""

    def __init__(self, variant="dinomo", **kw):
        self.ref = jcl.DinomoCluster(jcl.VARIANTS[variant], **kw)
        self.port = tcl.DinomoCluster(tcl.VARIANTS[variant], device="cpu",
                                      **kw)
        self.check()

    def both(self, fn):
        """``fn`` on each cluster; the returns equal. Returns the port's."""
        a, b = fn(self.ref), fn(self.port)
        assert plain(a) == plain(b)
        return b

    def check(self):
        a, b = cluster_state(self.ref), cluster_state(self.port)
        for k in a:
            assert a[k] == b[k], k


def mk(variant="dinomo", kns=4, keys=5000, reference_cache=False,
       warm=False, **kw):
    """test_cluster.py:mk's cluster, as a twin."""
    t = Twin(variant, num_kns=kns, cache_bytes=1 << 19, value_bytes=1024,
             num_buckets=1 << 13, segment_capacity=256,
             reference_cache=reference_cache, **kw)
    t.both(lambda c: c.load(((k, f"v{k}") for k in range(keys)),
                            warm=warm))
    t.check()
    return t


def run_mixed(c, n=1500, write_frac=0.5, keys=5000, seed=0):
    """test_cluster.py:run_mixed, returning every op's result."""
    rng = np.random.default_rng(seed)
    ks = rng.zipf(1.6, n) % keys
    out = []
    for i, k in enumerate(ks):
        k = int(k)
        if rng.random() < write_frac:
            out.append(c.write(k, f"w{i}"))
        else:
            out.append(c.read(k))
        if i % 256 == 0:
            out.append(c.advance_merge(1024))
    out.append(c.advance_merge(1 << 30))
    return out


@pytest.mark.parametrize("reference_cache", REFERENCE_CACHE)
@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("warm", (False, True))
def test_run_mixed(variant, reference_cache, warm):
    t = mk(variant, reference_cache=reference_cache, warm=warm)
    t.both(run_mixed)
    t.check()


@pytest.mark.parametrize("reference_cache", REFERENCE_CACHE)
class TestReconfiguration:
    def test_add_kn_no_lost_updates(self, reference_cache):
        t = mk(kns=2, keys=1000, reference_cache=reference_cache)
        t.both(lambda c: [c.write(i % 1000, f"w{i}") for i in range(500)])
        t.both(lambda c: c.add_kn())
        t.check()
        t.both(lambda c: c.advance_merge(1 << 30))
        got = t.both(lambda c: [c.read(i % 1000) for i in range(400, 500)])
        assert [r[0] for r in got] == [f"w{i}" for i in range(400, 500)]
        t.check()

    def test_participants_only(self, reference_cache):
        t = Twin(num_kns=8, cache_bytes=1 << 19, value_bytes=1024,
                 num_buckets=1 << 13, segment_capacity=256, vnodes=2,
                 reference_cache=reference_cache)
        t.both(lambda c: c.load((k, f"v{k}") for k in range(1000)))
        t.both(lambda c: c.add_kn())
        t.check()
        assert 0 < len(t.port.reconfig_log[-1]["participants"]) < 9

    @pytest.mark.parametrize("variant", VARIANTS)
    def test_data_movement(self, variant, reference_cache):
        """Zero movement for dinomo (ownership moves, not data) and the
        baselines, some for the shared-nothing dinomo-n."""
        t = mk(variant, keys=1000, reference_cache=reference_cache)
        t.both(lambda c: c.add_kn())
        t.check()
        moved = t.port.reconfig_log[-1]["moved_fraction"]
        assert (moved == 0.0) == (variant != "dinomo-n")

    @pytest.mark.parametrize("variant", BASELINES)
    def test_baseline_through_add_fail_remove(self, variant,
                                              reference_cache):
        """run_mixed's stream between a KN added, one failed and one
        removed, per op."""
        t = mk(variant, keys=2000, reference_cache=reference_cache,
               warm=True)
        t.both(lambda c: run_mixed(c, n=500, keys=2000))
        t.both(lambda c: c.add_kn())
        t.check()
        t.both(lambda c: run_mixed(c, n=500, keys=2000, seed=1))
        t.both(lambda c: [c.write(i, f"x{i}") for i in range(100)])
        t.both(lambda c: c.fail_kn("kn2"))
        t.check()
        t.both(lambda c: run_mixed(c, n=500, keys=2000, seed=2))
        t.both(lambda c: c.remove_kn("kn1"))
        t.check()
        got = t.both(lambda c: run_mixed(c, n=500, keys=2000, seed=3))
        assert got[-1] is not None
        t.check()

    def test_failure_recovers_pending_writes(self, reference_cache):
        t = mk(keys=1000, reference_cache=reference_cache)
        t.both(lambda c: [c.write(i, f"w{i}") for i in range(200)])
        victim = t.both(lambda c: c.route(0))
        t.both(lambda c: c.fail_kn(victim))
        t.check()
        assert "recovery" in t.port.reconfig_log[-1]
        t.both(lambda c: c.advance_merge(1 << 30))
        got = t.both(lambda c: [c.read(i) for i in range(200)])
        assert [r[0] for r in got] == [f"w{i}" for i in range(200)]
        t.check()

    def test_remove_then_serve(self, reference_cache):
        t = mk(keys=500, reference_cache=reference_cache, warm=True)
        victim = t.port.ownership.kns[0]
        t.both(lambda c: c.remove_kn(victim))
        t.check()
        got = t.both(lambda c: [c.read(k) for k in range(100)])
        assert [r[0] for r in got] == [f"v{k}" for k in range(100)]
        t.both(run_mixed)
        t.check()


@pytest.mark.parametrize("reference_cache", REFERENCE_CACHE)
class TestSelectiveReplication:
    def test_replicated_key_spreads_load(self, reference_cache):
        t = mk(keys=1000, reference_cache=reference_cache)
        t.both(lambda c: c.replicate_key(7, 4))
        owners = t.both(lambda c: [c.route(7) for _ in range(200)])
        assert len(set(owners)) == 4
        t.check()

    def test_replicated_writes_and_reads(self, reference_cache):
        t = mk(keys=1000, reference_cache=reference_cache, warm=True)
        t.both(lambda c: c.replicate_key(7, 4))

        def ops(c):
            return [c.write(7, f"w{i}") if i % 3 == 0 else c.read(7)
                    for i in range(60)]
        got = t.both(ops)
        assert all(r[-1] for r in got)
        t.check()

    def test_dereplicate_restores_value_caching(self, reference_cache):
        t = mk(keys=1000, reference_cache=reference_cache)
        t.both(lambda c: c.replicate_key(9, 4))
        t.both(lambda c: c.write(9, "hot"))
        t.both(lambda c: c.dereplicate_key(9))
        assert not t.port.ownership.is_replicated(9)
        assert t.both(lambda c: c.read(9))[0] == "hot"
        t.check()

    def test_replicated_read_costs_two_rts(self, reference_cache):
        t = mk(keys=1000, reference_cache=reference_cache)
        t.both(lambda c: c.replicate_key(3, 2))
        t.both(lambda c: c.read(3))
        assert t.both(lambda c: c.read(3))[1] == 2.0
        t.check()

    def test_dinomo_n_does_not_replicate(self, reference_cache):
        t = mk("dinomo-n", keys=1000, reference_cache=reference_cache)
        t.both(lambda c: c.replicate_key(3, 2))
        assert not t.port.ownership.replicated
        t.check()


def test_run_mixed_under_the_sanitizer():
    """REPRO_SANITIZE=1's ownership barrier on both packages: every cache
    write happens under its owner or the management plane."""
    for s in (js, ts):
        s.enable()
    try:
        t = mk(keys=2000, warm=True)
        t.both(lambda c: run_mixed(c, keys=2000))
        t.both(lambda c: c.add_kn())
        t.both(lambda c: c.replicate_key(5, 3))
        t.both(lambda c: run_mixed(c, n=600, keys=2000, seed=1))
        t.check()
        assert type(t.port.kns["kn1"].cache).__name__ == "GuardedArrayDAC"
    finally:
        for s in (js, ts):
            s.disable()


# ------------------------------------------------------------ TestVariants
@pytest.mark.parametrize("reference_cache", REFERENCE_CACHE)
def test_rts_ordering(reference_cache):
    """test_cluster.py's Table 6 result on twins, per op:
    dinomo < dinomo-s < clover in RTs an op."""
    rts = {}
    for v in ("dinomo", "dinomo-s", "clover"):
        t = mk(v, reference_cache=reference_cache)
        t.both(lambda c: run_mixed(c, n=2000))
        t.check()
        rts[v] = t.port.aggregate_stats()["rts_per_op"]
    assert rts["dinomo"] < rts["dinomo-s"] < rts["clover"]


@pytest.mark.parametrize("reference_cache", REFERENCE_CACHE)
def test_clover_version_chain_growth(reference_cache):
    """More KNs writing the same keys, longer chain walks: the twins
    agree on every step and the walks grow."""
    rts = {}
    for kns in (1, 8):
        t = mk("clover", kns=kns, keys=50, reference_cache=reference_cache)
        t.both(lambda c: run_mixed(c, n=1000, keys=50, seed=1))
        t.check()
        rts[kns] = t.port.aggregate_stats()["rts_per_op"]
    assert rts[8] > rts[1]


@pytest.mark.parametrize("variant", BASELINES)
def test_baseline_under_the_sanitizer(variant):
    """REPRO_SANITIZE=1 on both packages, per op: the baselines' cache
    writes happen under the serving KN or the management plane."""
    for s in (js, ts):
        s.enable()
    try:
        t = mk(variant, keys=2000, warm=True)
        t.both(lambda c: run_mixed(c, n=800, keys=2000))
        t.both(lambda c: c.add_kn())
        t.both(lambda c: run_mixed(c, n=400, keys=2000, seed=1))
        t.check()
        assert type(t.port.kns["kn1"].cache).__name__.startswith(
            "GuardedArray")
    finally:
        for s in (js, ts):
            s.disable()


# ------------------------------------------------------- the cache policies
POLICIES = ("dac", "shortcut", "value", "static:0.5", "clover")


@pytest.mark.parametrize("reference", (False, True))
@pytest.mark.parametrize("policy", POLICIES)
def test_make_cache_builds_every_policy(policy, reference):
    """Each policy's cache is the reference's class (its oracle with
    ``reference=True``), split alike; array caches take initial_keys."""
    a = jcl.make_cache(policy, 1 << 16, reference=reference)
    b = tcl.make_cache(policy, 1 << 16, reference=reference,
                       initial_keys=4096)
    assert type(a).__name__ == type(b).__name__
    for name in ("value_cap", "shortcut_cap", "cap_entries", "capacity"):
        assert getattr(a, name, None) == getattr(b, name, None)
    vec = getattr(b, "kind", getattr(b, "present", None))
    assert reference == (vec is None)
    if vec is not None:
        assert vec.shape == (4096,)


def test_make_cache_refuses_an_unknown_policy():
    with pytest.raises(ValueError, match="unknown cache policy"):
        tcl.make_cache("lru", 1 << 16)


def drive_static(a, b, seed, ops=1200):
    """test_writeplane.py:TestArrayStaticCacheEquivalence's op soup on
    two static caches; every return, the statistics and the occupancy
    equal after each op."""
    rng = np.random.default_rng(seed)
    for i in range(ops):
        r = rng.random()
        k = int(rng.zipf(1.3)) % 300
        ln = int(rng.choice([64, 100, 256]))
        if r < 0.55:
            ra, rb = a.lookup(k), b.lookup(k)
            assert plain(ra) == plain(rb)
            if ra is None:
                a.fill_after_miss(k, i, ln)
                b.fill_after_miss(k, i, ln)
        elif r < 0.8:
            a.fill_after_write(k, i, ln, segment_cached=True)
            b.fill_after_write(k, i, ln, segment_cached=True)
        elif r < 0.9:
            a.invalidate(k)
            b.invalidate(k)
        else:
            a.demote_to_shortcut(k)
            b.demote_to_shortcut(k)
        assert dataclasses.astuple(a.stats) == dataclasses.astuple(b.stats)
        assert (a.value_used, a.shortcut_used) == \
            (b.value_used, b.shortcut_used)


@pytest.mark.parametrize("frac", (0.0, 0.3, 0.7, 1.0))
@pytest.mark.parametrize("seed,cap_pow", ((0, 8), (1, 11), (2, 15)))
def test_static_caches_decide_as_the_reference(seed, cap_pow, frac):
    """The port's ArrayStaticCache against the reference's, and the
    port's StaticCache against the reference's oracle, every decision;
    then the array cache's whole state (vectors, heaps, clock) equals
    the reference array cache's, and its sides the oracle's."""
    cap = 1 << cap_pow
    ref_a, port_a = jdac.ArrayStaticCache(cap, frac), \
        tdac.ArrayStaticCache(cap, frac)
    ref_o, port_o = jdac.StaticCache(cap, frac), tdac.StaticCache(cap, frac)
    drive_static(ref_a, port_a, seed)
    drive_static(ref_o, port_o, seed)
    assert cache_state(ref_a) == cache_state(port_a)
    assert cache_state(ref_o) == cache_state(port_o)
    for k in range(300):
        assert (k in port_o.values) == (port_a.kind[k] == 2)
        assert (k in port_o.shortcuts) == (port_a.kind[k] == 1)


@pytest.mark.parametrize("seed,cap", ((0, 1 << 9), (1, 1 << 11),
                                      (2, 1 << 13), (3, 1 << 16)))
def test_clover_caches_decide_as_the_reference(seed, cap):
    """ArrayCloverCache and CloverCache, the port's against the
    reference's, on lookups, fills (with evictions) and clears: every
    return and statistic after each op, the whole state at the end, and
    the array cache's entries in LRU order equal the oracle's."""
    rng = np.random.default_rng(seed)
    caches = (jcl.ArrayCloverCache(cap), tcl.ArrayCloverCache(cap),
              jcl.CloverCache(cap), tcl.CloverCache(cap))
    for i in range(1500):
        k = int(rng.zipf(1.2)) % 400
        r = rng.random()
        if r < 0.6:
            got = [c.lookup(k) for c in caches]
            assert len({None if g is None else int(g) for g in got}) == 1
        elif r < 0.995:
            for c in caches:
                c.fill(k, i)
        else:
            for c in caches:
                c.clear()
        assert len({dataclasses.astuple(c.stats) for c in caches}) == 1
    assert cache_state(caches[0]) == cache_state(caches[1])
    assert cache_state(caches[2]) == cache_state(caches[3])
    live = np.flatnonzero(caches[1].present)
    live = live[np.argsort(caches[1].stamp[live])]
    assert list(zip(live.tolist(), caches[1].ver[live].tolist())) == \
        list(caches[3].entries.items())


def test_unknown_engine_raises_and_jit_runs_on_the_cpu():
    """engine="gpu" raises before anything runs; engine="jit" runs on a
    CPU cluster (kernel E's plain version) and leaves what the host
    engine leaves, the caches' lazy-heap records aside."""
    pair = [tcl.DinomoCluster(num_kns=2, num_buckets=64,
                              segment_capacity=16, device="cpu")
            for _ in range(2)]
    for c in pair:
        c.load((k, f"v{k}") for k in range(300))
    kinds, keys = np.zeros(8, np.uint8), np.arange(8)
    with pytest.raises(ValueError, match="unknown engine"):
        pair[0].execute_batch(kinds, keys, engine="gpu")
    assert pair[0].aggregate_stats()["ops"] == 0      # nothing ran
    kinds = (np.arange(400) % 3 == 0).astype(np.uint8)
    keys = (np.arange(400) * 7) % 300
    got = [batch_result(c.execute_batch(kinds, keys, engine=e,
                                        values=lambda i: f"w{i}",
                                        collect_values=True))
           for c, e in zip(pair, ("jit", "host"))]
    assert got[0] == got[1]
    assert cluster_state(pair[0], heaps=False) == \
        cluster_state(pair[1], heaps=False)
    assert pair[0]._jit.counts["dispatches"] > 0


# ------------------------------------------------- warm load and the ring
@pytest.mark.parametrize("order", ["ascending", "shuffled"])
def test_bulk_warm_load_equals_the_per_key_loop(order):
    """load(warm=True) in bulk (ascending keys: one warm_load an owner)
    leaves the state of the per-key fills; shuffled keys take the
    per-key loop itself. Both equal the reference."""
    keys = np.arange(3000)
    if order == "shuffled":
        keys = np.random.default_rng(0).permutation(keys)
    items = [(int(k), f"v{k}") for k in keys]
    kw = dict(num_kns=4, cache_bytes=1 << 16, value_bytes=1024,
              num_buckets=1 << 12, segment_capacity=64)
    bulk = tcl.DinomoCluster(device="cpu", **kw)
    bulk.load(items, warm=True)
    loop = tcl.DinomoCluster(device="cpu", **kw)
    loop.load(items)
    assert loop._warm_bulk(keys.tolist()) == (order == "ascending")
    loop2 = tcl.DinomoCluster(device="cpu", **kw)
    loop2.load(items)
    loop2._warm_per_key(keys.tolist())
    ref = jcl.DinomoCluster(**kw)
    ref.load(items, warm=True)
    want = cluster_state(ref)
    for c in (bulk, loop2):
        assert cluster_state(c) == want
        for nm in c.kns:
            assert c.kns[nm].cache.kind.shape == \
                ref.kns[nm].cache.kind.shape


@pytest.mark.parametrize("order", ["ascending", "shuffled"])
@pytest.mark.parametrize("policy", ["shortcut", "value", "clover"])
def test_warm_load_of_the_baselines_equals_the_reference(policy, order):
    """load(warm=True) of a static or Clover cache (key by key: the bulk
    warm-up takes only empty ArrayDACs) in either key order: the state of
    the reference's per-key load, the per-key vectors grown alike."""
    keys = np.arange(3000)
    if order == "shuffled":
        keys = np.random.default_rng(1).permutation(keys)
    items = [(int(k), f"v{k}") for k in keys]
    kw = dict(num_kns=4, cache_bytes=1 << 20, value_bytes=1024,
              num_buckets=1 << 12, segment_capacity=64)
    variant = {"clover": "clover"}.get(policy, "dinomo-s")
    tv = dataclasses.replace(tcl.VARIANTS[variant], cache_policy=policy)
    jv = dataclasses.replace(jcl.VARIANTS[variant], cache_policy=policy)
    port = tcl.DinomoCluster(tv, device="cpu", **kw)
    assert not port._warm_bulk(keys.tolist())
    port.load(items, warm=True)
    ref = jcl.DinomoCluster(jv, **kw)
    ref.load(items, warm=True)
    assert cluster_state(port) == cluster_state(ref)
    vec = "present" if policy == "clover" else "kind"
    for nm, kn in port.kns.items():
        assert getattr(kn.cache, vec).shape == \
            getattr(ref.kns[nm].cache, vec).shape


@pytest.mark.parametrize("variant", BASELINES)
def test_warm_load_of_the_baselines_evicts_like_the_reference(variant):
    """Caches too small for every key: the per-key warm-up's fills
    evict, as the reference's do."""
    kw = dict(num_kns=2, cache_bytes=1 << 12, value_bytes=1024,
              num_buckets=1 << 10, segment_capacity=64)
    items = [(k, f"v{k}") for k in range(600)]
    t = Twin(variant, **kw)
    t.both(lambda c: c.load(items, warm=True))
    t.check()
    assert sum(kn.cache.stats.evictions for kn in t.port.kns.values())


@pytest.mark.parametrize("variant", VARIANTS)
def test_a_copy_of_a_loaded_pool_loads_like_a_fresh_load(variant):
    """chip_smoke.py's baselines take a copy of the dinomo cluster's pool
    as loaded, pickled and unpickled (torch_cluster_cases.loaded_like),
    instead of loading again: the cluster so built has the state of one
    loaded warm itself, and stays equal to it through a batch and a
    join."""
    kw = dict(num_kns=4, cache_bytes=1 << 18, value_bytes=1024,
              num_buckets=1 << 12, segment_capacity=64,
              policy=tcl.PolicyConfig(grace_period_s=1e9, epoch_s=1e9))
    items = [(k, f"v{k}") for k in range(3000)]
    donor = tcl.DinomoCluster(tcl.DINOMO, device="cpu", **kw)
    donor.load(items, warm=True)
    fresh = tcl.DinomoCluster(tcl.VARIANTS[variant], device="cpu", **kw)
    fresh.load(items, warm=True)
    built = tcl.DinomoCluster(tcl.VARIANTS[variant], device="cpu", **kw)
    loaded_like(built, pickle.loads(pickle.dumps(donor.pool)), range(3000))
    assert built.pool is not donor.pool
    assert all(kn.pool is built.pool for kn in built.kns.values())
    assert cluster_state(built) == cluster_state(fresh)
    kinds = (np.arange(2000) % 3 == 0).astype(np.uint8)
    keys = (np.arange(2000) * 7) % 3100
    for c in (built, fresh):
        c.execute_batch(kinds, keys, values=lambda i: f"w{i}")
        c.add_kn()
    assert cluster_state(built) == cluster_state(fresh)


def test_bulk_warm_load_declines_a_cache_too_small():
    """Shortcuts that do not all fit take the per-key loop (its
    make-space evicts), and still equal the reference."""
    kw = dict(num_kns=2, cache_bytes=1 << 12, value_bytes=1024,
              num_buckets=1 << 10, segment_capacity=64)
    items = [(k, f"v{k}") for k in range(600)]
    port = tcl.DinomoCluster(device="cpu", **kw)
    port.load(items)
    assert not port._warm_bulk([k for k, _ in items])
    t = Twin(**kw)
    t.both(lambda c: c.load(items, warm=True))
    t.check()
    assert sum(kn.cache.stats.evictions for kn in t.port.kns.values())


@given(st.integers(0, 10**6), st.integers(2, 9))
@settings(max_examples=6, deadline=None)
def test_ring_owner_ids_match_the_reference(seed, n_members):
    """test_dataplane.py:247's vectorized owners, against the reference
    ring's, with owners(), share() and diff()."""
    names = [f"kn{i}" for i in range(n_members)]
    a, b = jh.HashRing(names, vnodes=32), th.HashRing(names, vnodes=32)
    keys = np.random.default_rng(seed).integers(0, 1 << 62, 500)
    ia, na = a.owner_ids(keys)
    ib, nb = b.owner_ids(keys)
    assert na == nb and np.array_equal(ia, ib)
    for i, k in enumerate(keys[:100]):
        assert nb[ib[i]] == b.owner(int(k))
        assert a.owners(int(k), 3) == b.owners(int(k), 3)
    a2, b2 = a.snapshot(), b.snapshot()
    a2.add("new"), b2.add("new")
    assert (a.share("kn0"), a.diff(a2)) == (b.share("kn0"), b.diff(b2))
    assert a2.generation == b2.generation


def test_policy_engine_decides_as_the_reference():
    """The M-node on test_cluster.py's policy cases, epoch by epoch."""
    cases = [
        dict(avg_latency=5e-3, occupancy={"kn1": 0.9, "kn2": 0.8}),
        dict(occupancy={"kn1": 0.02, "kn2": 0.5}),
        dict(avg_latency=5e-3, occupancy={"kn1": 0.15, "kn2": 0.12},
             key_freq={**{k: 1.0 for k in range(20)}, 7: 500.0}),
        dict(occupancy={"kn1": 0.5, "kn2": 0.5},
             key_freq={**{k: float(100 + k) for k in range(20)}, 3: 0.0},
             replication={3: 4}),
    ]
    for grace in (0.0, 90.0):
        engines = [mod.PolicyEngine(mod.PolicyConfig(grace_period_s=grace,
                                                     max_kns=8))
                   for mod in (jm, tm)]
        for i, case in enumerate(cases * 2):
            got = []
            for mod, eng in zip((jm, tm), engines):
                base = dict(now=100.0 + 10 * i, avg_latency=1e-4,
                            p99_latency=1e-3, key_freq={}, replication={})
                base.update(case)
                got.append(plain(eng.decide(mod.EpochStats(**base))))
            assert got[0] == got[1]
        assert engines[0].decision_log == engines[1].decision_log
