"""Port parity for the baselines' planners: the port's
``plan_static_window`` (dinomo-s and the static:<f> splits) and
``plan_clover_reads`` (Clover's read-only batches) against the
reference's, call by call, inside reference ``DinomoCluster`` runs. At
every call of a reference planner the pre-window cache is copied into
the port's array cache and the port planner is called with the same
arguments (the same ``kn``, ``wplan``, ``probe_map``, dirty sets and
``pool``: the pool is live, so the comparison happens at the call);
every plan slot must be equal, and so must both caches (and, for a
static window, the KN's segment cache and statistics) after each side
applies its own plan."""

import copy
import dataclasses
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.core.cluster as jcl  # noqa: E402
from repro.data.ycsb import Workload  # noqa: E402
from repro_torch.core import cluster as tcl  # noqa: E402
from repro_torch.core import dac as tdac  # noqa: E402
from repro_torch.core import transition as ttr  # noqa: E402
from torch_cluster_cases import cache_state  # noqa: E402

# name -> (cache policy, mix, delete share, warm load, cache bytes a KN)
STATIC_SCENARIOS = {
    "shortcut": ("shortcut", "write_heavy_update", 0.1, True, 1 << 16),
    "split": ("static:0.5", "write_heavy_update", 0.0, True, 1 << 19),
    "evicting": ("static:0.3", "read_mostly_update", 0.05, True, 1 << 16),
    "value_cold": ("value", "write_heavy_insert", 0.0, False, 1 << 20),
}
NUM_KEYS = 6000
BATCHES, BATCH = 10, 2000


def slot_diff(ref, got) -> list:
    """The plan slots whose values (or container types) differ."""
    bad = []
    for name in ref.__slots__:
        a, b = getattr(ref, name), getattr(got, name)
        if isinstance(a, np.ndarray):
            same = isinstance(b, np.ndarray) and a.dtype == b.dtype \
                and np.array_equal(a, b)
        else:
            same = type(a) is type(b) and a == b
        if not same:
            bad.append(name)
    return bad


def copy_static(cache) -> tdac.ArrayStaticCache:
    """The reference ArrayStaticCache's whole state in a port one."""
    out = tdac.ArrayStaticCache(1, 0.0)
    for name, v in vars(cache).items():
        if name == "stats":
            v = tdac.CacheStats(**dataclasses.asdict(v))
        setattr(out, name, copy.copy(v))
    out.value_cap, out.shortcut_cap = cache.value_cap, cache.shortcut_cap
    return out


def copy_clover(cache) -> tcl.ArrayCloverCache:
    out = tcl.ArrayCloverCache(32)
    for name, v in vars(cache).items():
        if name == "stats":
            v = tdac.CacheStats(**dataclasses.asdict(v))
        setattr(out, name, copy.copy(v))
    return out


def kn_side(kn, cache):
    """A stand-in KN with a copy of ``kn``'s soft state (what
    apply_window_plan reads and writes)."""
    return SimpleNamespace(name=kn.name, cache=cache,
                           segcache=copy.copy(kn.segcache),
                           segcache_cap=kn.segcache_cap,
                           stats=tcl.KNStats(**dataclasses.asdict(kn.stats)))


def check_static(cluster, cache, kn, args, ref_plan_fn):
    port_cache = copy_static(cache)
    port_kn = kn_side(kn, port_cache)
    got = ttr.plan_static_window(port_cache, port_kn, *args)
    want = ref_plan_fn(cache, kn, *args)
    rec = {"m": args[0].size, "none": want is None,
           "mismatch": [] if (want is None) == (got is None) else ["None"]}
    if want is None or got is None:
        return want, rec
    rec["mismatch"] += slot_diff(want, got)
    rec.update(vvic=len(got.vvic), svic=len(got.svic), misses=got.misses,
               replay=got.seg_replay is not None)
    ref_cache = copy.deepcopy(cache)
    ref_kn = kn_side(kn, ref_cache)
    jcl.DinomoCluster._apply_window_plan(cluster, ref_kn, ref_cache, want,
                                         None)
    tcl.apply_window_plan(port_kn, port_cache, got, None,
                          cluster.value_bytes)
    if cache_state(ref_cache) != cache_state(port_cache):
        rec["mismatch"].append("cache")
    if list(ref_kn.segcache.items()) != list(port_kn.segcache.items()):
        rec["mismatch"].append("segcache")
    if dataclasses.asdict(ref_kn.stats) != dataclasses.asdict(port_kn.stats):
        rec["mismatch"].append("kn.stats")
    return want, rec


def run_static(name):
    policy, mix, deletes, warm, cache_bytes = STATIC_SCENARIOS[name]
    variant = dataclasses.replace(jcl.DINOMO_S, cache_policy=policy)
    cluster = jcl.DinomoCluster(variant, num_kns=2, cache_bytes=cache_bytes,
                                segment_capacity=256)
    cluster.load(((k, f"v{k}") for k in range(NUM_KEYS)), warm=warm)
    records = []
    orig = jcl.plan_static_window

    def wrapped(cache, kn, *args, **kw):
        assert not kw
        want, rec = check_static(cluster, cache, kn, args, orig)
        records.append(rec)
        return want

    wl = Workload(num_keys=NUM_KEYS, zipf=0.99, mix=mix, seed=2)
    rng = np.random.default_rng(2)
    jcl.plan_static_window = wrapped
    try:
        for b in range(BATCHES):
            kinds, keys = wl.ops_arrays(BATCH)
            kinds = kinds.astype(np.uint8)
            if deletes:
                kinds[(kinds == 1) & (rng.random(kinds.size) < deletes)] = 2
            cluster.execute_batch(kinds, keys, values=lambda i: f"w{i}",
                                  collect_values=b % 3 == 0)
            cluster.advance_merge(4096)
    finally:
        jcl.plan_static_window = orig
    return records


@pytest.fixture(scope="module")
def static_runs():
    return {name: run_static(name) for name in STATIC_SCENARIOS}


@pytest.mark.parametrize("name", list(STATIC_SCENARIOS))
def test_every_static_plan_slot_and_apply_matches_the_reference(
        static_runs, name):
    recs = static_runs[name]
    assert recs
    bad = [(i, r["mismatch"]) for i, r in enumerate(recs) if r["mismatch"]]
    assert not bad, bad[:5]


def test_the_static_runs_cover_every_regime(static_runs):
    """Value-side and shortcut-side evictions, misses, the per-op
    segcache replay (deletes) and a declined window all occur."""
    recs = [r for rs in static_runs.values() for r in rs]
    planned = [r for r in recs if not r["none"]]
    assert any(r["vvic"] for r in planned)
    assert any(r["svic"] for r in planned)
    assert any(r["misses"] for r in planned)
    assert any(r["replay"] for r in planned)
    assert any(r["none"] for r in recs)


# ------------------------------------------------------------------ Clover
CLOVER_SCENARIOS = {
    # name -> (cache bytes a KN, zipf, write batches before the reads)
    "roomy": (1 << 19, 1.1, 0),
    "stale": (1 << 19, 0.99, 2),
    "evicting": (1 << 14, 0.8, 1),
}


def check_clover(cache, args, ref_plan_fn):
    port_cache = copy_clover(cache)
    got = ttr.plan_clover_reads(port_cache, *args)
    want = ref_plan_fn(cache, *args)
    rec = {"none": want is None,
           "mismatch": [] if (want is None) == (got is None) else ["None"]}
    if want is None or got is None:
        return want, rec
    rec["mismatch"] += slot_diff(want, got)
    rec["stale"] = bool((want.hit & (args[1] > cache.ver[args[0]])).any())
    ref_cache = copy.deepcopy(cache)
    ref_cache.apply_plan(want)
    port_cache.apply_plan(got)
    if cache_state(ref_cache) != cache_state(port_cache):
        rec["mismatch"].append("cache")
    return want, rec


def run_clover(name):
    cache_bytes, zipf, writes = CLOVER_SCENARIOS[name]
    cluster = jcl.DinomoCluster(jcl.CLOVER, num_kns=4,
                                cache_bytes=cache_bytes,
                                num_buckets=1 << 13, segment_capacity=256)
    cluster.load(((k, f"v{k}") for k in range(NUM_KEYS)), warm=True)
    records = []
    orig = jcl.plan_clover_reads

    def wrapped(cache, *args, **kw):
        assert not kw
        want, rec = check_clover(cache, args, orig)
        records.append(rec)
        return want

    writer = Workload(num_keys=NUM_KEYS, zipf=zipf,
                      mix="write_heavy_update", seed=3)
    reader = Workload(num_keys=NUM_KEYS, zipf=zipf, mix="read_only", seed=4)
    jcl.plan_clover_reads = wrapped
    try:
        for _ in range(4):
            for _ in range(writes):
                cluster.execute_batch(*writer.ops_arrays(BATCH),
                                      values=lambda i: f"w{i}")
            cluster.execute_batch(*reader.ops_arrays(BATCH),
                                  collect_values=True)
    finally:
        jcl.plan_clover_reads = orig
    return records


@pytest.fixture(scope="module")
def clover_runs():
    return {name: run_clover(name) for name in CLOVER_SCENARIOS}


@pytest.mark.parametrize("name", list(CLOVER_SCENARIOS))
def test_every_clover_plan_slot_and_apply_matches_the_reference(
        clover_runs, name):
    recs = clover_runs[name]
    assert recs
    bad = [(i, r["mismatch"]) for i, r in enumerate(recs) if r["mismatch"]]
    assert not bad, bad[:5]


def test_the_clover_runs_cover_every_regime(clover_runs):
    """Plans with stale cached versions, and plans declined because the
    slice could evict."""
    recs = [r for rs in clover_runs.values() for r in rs]
    assert any(r.get("stale") for r in recs)
    assert any(r["none"] for r in clover_runs["evicting"])
    assert all(not r["none"] for r in clover_runs["roomy"])
