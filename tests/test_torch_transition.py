"""Port parity for the KN's planned DAC window: the port's
``plan_dac_window`` against the reference's, window by window, inside
reference ``DinomoCluster`` runs (dinomo variant; write_heavy_update,
read_mostly_update, with deletes, and a cold roomy cache). At every call
of the reference planner the pre-window cache is copied into the port's
``ArrayDAC`` and the port planner is called with the same ``kn``,
``wplan``, ``probe_map``, ``dkeys``, ``dbuckets`` and ``pool``; every
``DacWindowPlan`` slot must be equal, and so must both caches and KN
states after the apply. The twin is pinned on the same windows: the JAX
``cache_transition`` (interpret mode; its numpy oracle where the victim
queue runs dry) and the port's plain version on the gathered inputs
against the planner, agreeing wherever no named cause applies."""

import copy
import dataclasses
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.core.cluster as jcl  # noqa: E402
from repro.core.cluster import VARIANTS, DinomoCluster  # noqa: E402
from repro.data.ycsb import Workload  # noqa: E402
from repro.kernels import cache_transition as jct  # noqa: E402
from repro_torch.core import cluster as tcl  # noqa: E402
from repro_torch.core import dac as tdac  # noqa: E402
from repro_torch.core import transition as ttr  # noqa: E402
from repro_torch.kernels import cache_transition as tct  # noqa: E402

# name -> (mix, delete share, warm load, cache bytes per KN)
SCENARIOS = {
    "write_heavy": ("write_heavy_update", 0.0, True, 1 << 19),
    "read_mostly": ("read_mostly_update", 0.0, True, 1 << 19),
    "deletes": ("write_heavy_update", 0.1, True, 1 << 19),
    "cold": ("write_heavy_update", 0.0, False, 1 << 23),
}
NUM_KEYS = 6000
BATCHES, BATCH = 12, 2000
VECTORS = ("kind", "ptr", "length", "count", "stamp")
SCALARS = ("used", "_clock", "_nvals", "_nshort", "_zero_shortcuts",
           "avg_miss_rts", "avg_shortcut_hit_rts", "capacity")


def to_port(cache) -> tdac.ArrayDAC:
    """The reference ArrayDAC's whole state in a port ArrayDAC."""
    out = tdac.ArrayDAC(cache.capacity, initial_keys=cache.kind.shape[0])
    for name in VECTORS:
        setattr(out, name, getattr(cache, name).copy())
    for name in SCALARS + ("_ema",):
        setattr(out, name, getattr(cache, name))
    out._lru, out._lfu = list(cache._lru), list(cache._lfu)
    out._cnt_hist = list(cache._cnt_hist)
    out.stats = tdac.CacheStats(**dataclasses.asdict(cache.stats))
    return out


def cache_diff(ref, got) -> list:
    bad = [n for n in VECTORS
           if not np.array_equal(getattr(ref, n), getattr(got, n))]
    bad += [n for n in SCALARS if getattr(ref, n) != getattr(got, n)]
    bad += [n for n in ("_lru", "_lfu", "_cnt_hist")
            if list(getattr(ref, n)) != list(getattr(got, n))]
    if dataclasses.asdict(ref.stats) != dataclasses.asdict(got.stats):
        bad.append("stats")
    return bad


def slot_diff(ref, got) -> list:
    bad = []
    for name in ref.__slots__:
        a, b = getattr(ref, name), getattr(got, name)
        same = np.array_equal(a, b) if isinstance(a, np.ndarray) else a == b
        if not same or type(a) is not type(b) and not (
                isinstance(a, np.ndarray) and isinstance(b, np.ndarray)):
            bad.append(name)
    return bad


def check_window(cluster, cache, kn, args, ref_plan_fn):
    """Plan one window both ways (and the twin), apply both, compare."""
    port_cache = to_port(cache)
    port_kn = tcl.KVSNode(kn.name, tcl.DINOMO, cache.capacity, kn.pool,
                          segcache_segments=kn.segcache_cap
                          // kn.pool.segment_capacity)
    port_kn.cache = port_cache
    port_kn.segcache = copy.copy(kn.segcache)
    port_kn.stats = tcl.KNStats(**dataclasses.asdict(kn.stats))
    rec = {"m": args[0].size}
    ps = ttr.prior_state(port_cache, port_kn, *args[:3], *args[4:9])
    rec["all_fits"] = ps is not None and ps.all_fits
    got = ttr.plan_dac_window(port_cache, port_kn, *args)
    want = ref_plan_fn(cache, kn, *args)
    rec["none"] = want is None
    rec["mismatch"] = [] if (want is None) == (got is None) else ["None"]
    if want is None or got is None:
        return want, rec
    rec["mismatch"] += slot_diff(want, got)
    rec.update(ops=got.ops, victims=len(got.victims),
               retry=got.include_refills)
    # the twin, on the inputs gathered before the apply
    win = tct.gather_window(port_cache, port_kn, *args[:3], *args[4:9],
                            got.include_refills)
    cap = port_cache.capacity
    port_out = tct.cache_transition_np(win.rows, win.victims, win.used0,
                                       win.z0, cap=cap)
    if port_out[2].max() <= cap:
        # the queue never ran dry, so entries past its end are never
        # read: pad it to a power of two (one compile per size)
        v = np.full(1 << max(4, win.victims.size.bit_length()), 1 << 20)
        v[:win.victims.size] = win.victims
        jax_out = [np.asarray(x) for x in jct.cache_transition(
            win.rows, v, win.used0, win.z0, cap=cap, interpret=True)]
    else:
        jax_out = jct.cache_transition_np(win.rows, win.victims, win.used0,
                                          win.z0, cap=cap)
    rec["twin_equal"] = all(np.array_equal(a, b)
                            for a, b in zip(jax_out, port_out))
    rec["verdict"] = tct.twin_verdict(win, got, args[0], *jax_out, cap)
    if rec["verdict"] == "read_miss":
        # the prefix before the first miss fill, planned as its own window
        j = tct.miss_free_prefix(win, got)
        pre = tuple(a[:j] for a in args[:3]) + args[3:]
        plan = ttr.plan_dac_window(port_cache, port_kn, *pre)
        if plan is not None:
            w2 = tct.gather_window(port_cache, port_kn, *pre[:3], *pre[4:9],
                                   plan.include_refills)
            out = tct.cache_transition_np(w2.rows, w2.victims, w2.used0,
                                          w2.z0, cap=cap)
            rec["prefix"] = tct.twin_verdict(w2, plan, pre[0], *out, cap)
    # apply on both sides: a copy of the reference state takes the
    # reference's apply, the port copy the port's
    ref_cache = copy.deepcopy(cache)
    ref_kn = SimpleNamespace(segcache=copy.copy(kn.segcache),
                             segcache_cap=kn.segcache_cap,
                             stats=jcl.KNStats(**dataclasses.asdict(
                                 kn.stats)))
    jcl.DinomoCluster._apply_window_plan(cluster, ref_kn, ref_cache, want,
                                         None)
    tcl.apply_window_plan(port_kn, port_cache, got, None,
                          cluster.value_bytes)
    rec["mismatch"] += cache_diff(ref_cache, port_cache)
    if list(ref_kn.segcache.items()) != list(port_kn.segcache.items()):
        rec["mismatch"].append("segcache")
    if dataclasses.asdict(ref_kn.stats) != dataclasses.asdict(port_kn.stats):
        rec["mismatch"].append("kn.stats")
    return want, rec


def run_scenario(name):
    mix, deletes, warm, cache_bytes = SCENARIOS[name]
    cluster = DinomoCluster(VARIANTS["dinomo"], num_kns=2,
                            cache_bytes=cache_bytes)
    cluster.load(((k, f"v{k}") for k in range(NUM_KEYS)), warm=warm)
    records = []
    orig = jcl.plan_dac_window

    def wrapped(cache, kn, *args, **kw):
        assert not kw
        want, rec = check_window(cluster, cache, kn, args, orig)
        records.append(rec)
        return want

    wl = Workload(num_keys=NUM_KEYS, zipf=0.99, mix=mix, seed=1)
    rng = np.random.default_rng(1)
    jcl.plan_dac_window = wrapped
    try:
        for _ in range(BATCHES):
            kinds, keys = wl.ops_arrays(BATCH)
            kinds = kinds.astype(np.uint8)
            if deletes:
                kinds[rng.random(kinds.size) < deletes] = 2
            cluster.execute_batch(kinds, keys, values=lambda i: f"w{i}")
    finally:
        jcl.plan_dac_window = orig
    return records


@pytest.fixture(scope="module")
def runs():
    return {name: run_scenario(name) for name in SCENARIOS}


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_every_plan_slot_and_apply_matches_the_reference(runs, name):
    recs = runs[name]
    assert recs
    bad = [(i, r["mismatch"]) for i, r in enumerate(recs) if r["mismatch"]]
    assert not bad, bad[:5]


def test_the_runs_cover_every_regime(runs):
    """all_fits, the make-space regime (victims consumed), truncation,
    the _include_refills retry and a None return all occur."""
    recs = [r for rs in runs.values() for r in rs]
    planned = [r for r in recs if not r["none"]]
    assert any(r["all_fits"] for r in planned)
    assert any(r["victims"] for r in planned)
    assert any(r["ops"] < r["m"] for r in planned)
    assert any(r["retry"] for r in planned)
    assert any(r["none"] for r in recs)
    assert all(r["all_fits"] for r in runs["cold"] if not r["none"])


def test_the_twin_agrees_wherever_no_named_cause_applies(runs):
    """The JAX kernel and the port's plain version give the same outputs
    on every gathered window, and the kernel agrees with the JAX planner
    on every planned window except where a read filled after a miss (not
    encoded), a consumed victim was touched first, or the queue ran
    dry. Without misses (the warm-loaded runs without deletes) every
    window agrees, and so does every planned prefix of a window with
    misses before its first miss fill."""
    verdicts = {}
    for name, rs in runs.items():
        for r in rs:
            if r["none"]:
                continue
            assert r["twin_equal"]
            verdicts.setdefault(name, []).append(r["verdict"])
    flat = [v for vs in verdicts.values() for v in vs]
    assert "other" not in flat
    assert set(verdicts["write_heavy"]) == {"agree"}
    assert set(verdicts["read_mostly"]) == {"agree"}
    assert "read_miss" in verdicts["deletes"]
    prefixes = [r["prefix"] for rs in runs.values() for r in rs
                if "prefix" in r]
    assert prefixes and set(prefixes) == {"agree"}
    assert flat.count("agree") > len(flat) // 2
