"""Port parity for the cluster's host engine, batched side: the port's
``DinomoCluster.execute_batch`` (routing, the staged write plane, the
per-KN windows planned by plan_dac_window or replayed, the probe
prefetch through ``DPMPool.index_lookup_batch`` -- kernel A's plain
version here) against the reference's, as twin clusters driven by the
reference's own batched op streams: test_dataplane.py's
TestBatchedClusterEquivalence and test_writeplane.py's
TestWritePlaneEquivalence for dinomo (both merge allowances, both
bucket densities, seal boundaries mid-batch, replicated keys in write
batches, blocked and refused KNs) and, for the baselines dinomo-s (the
static cache's planned and replayed windows) and clover (the batched
Clover plane: one index read a batch, the pending-index overlay, the
index landed at batch end; planned read-only batches), its streams and
TestPlannedEngine's; then the chip_smoke ``cluster`` phase's shape at a
small size for all four variants (YCSB batches with merges between them,
KNs added, failed and removed between batches). Each also with
``reference_cache=True`` on both sides (the fused per-op loop), and
under the ownership sanitizer. After every batch the BatchResults, the
collected values, the planned/replayed window counts and the whole
states (tests/torch_cluster_cases.py:cluster_state) are equal, and the
port's packed copy of the pool's index equals the host index row for
row. Exact comparisons throughout."""

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

torch = pytest.importorskip("torch")

from repro.core import cluster as jcl  # noqa: E402
from repro.core import sanitize as js  # noqa: E402
from repro.core import transition as jt  # noqa: E402
from repro.data import Workload  # noqa: E402
from repro_torch.core import cluster as tcl  # noqa: E402
from repro_torch.core import sanitize as ts  # noqa: E402
from repro_torch.core import transition as tt  # noqa: E402
from torch_cluster_cases import (batch_result, cluster_state,  # noqa: E402
                                 mirror_equals_host)

DATAPLANE_MIXES = ["read_only", "read_mostly_update", "read_mostly_insert",
                   "write_heavy_update"]
WRITEPLANE_MIXES = ["read_mostly_update", "write_heavy_update",
                    "write_heavy_insert"]
VARIANTS = ["dinomo", "dinomo-s", "dinomo-n", "clover"]
BASELINES = ["dinomo-s", "clover"]


class Twin:
    """The reference's cluster and the port's, built and loaded alike."""

    def __init__(self, variant="dinomo", num_keys=4000, warm=True,
                 merge_allowance=None, **kw):
        self.ref = jcl.DinomoCluster(jcl.VARIANTS[variant], **kw)
        self.port = tcl.DinomoCluster(tcl.VARIANTS[variant], device="cpu",
                                      **kw)
        for c in self.clusters:
            c.load(((k, f"v{k}") for k in range(num_keys)), warm=warm)
            c.pool.merge_allowance = merge_allowance
        self.check()

    @property
    def clusters(self):
        return self.ref, self.port

    def batch(self, kinds, keys, **kw):
        """One execute_batch on each (the planner's counters reset on
        both first); every result field and the counters equal."""
        out = []
        for c, stats in zip(self.clusters, (jt.PLAN_STATS, tt.PLAN_STATS)):
            for k in stats:
                stats[k] = 0
            out.append(c.execute_batch(kinds, keys,
                                       values=lambda i: f"w{i}", **kw))
        assert batch_result(out[0]) == batch_result(out[1])
        assert jt.PLAN_STATS == tt.PLAN_STATS
        self.check()
        mirror_equals_host(self.port.pool)
        return out[1]

    def both(self, fn):
        a, b = fn(self.ref), fn(self.port)
        assert a == b
        return b

    def check(self):
        a, b = cluster_state(self.ref), cluster_state(self.port)
        for k in a:
            assert a[k] == b[k], k


def dataplane_twin(seed, cache_bytes, reference_cache, num_keys=6000):
    """test_dataplane.py:build_pair's cluster."""
    return Twin(num_kns=4, cache_bytes=cache_bytes, value_bytes=1024,
                num_buckets=1 << 13, segment_capacity=256, seed=seed,
                reference_cache=reference_cache, num_keys=num_keys)


def writeplane_twin(seed, cache_bytes, reference_cache, num_keys=4000,
                    segment_capacity=64, num_buckets=1 << 12,
                    merge_allowance=None, variant="dinomo"):
    """test_writeplane.py:build_pair's cluster."""
    return Twin(variant, num_kns=4, cache_bytes=cache_bytes,
                value_bytes=1024,
                num_buckets=num_buckets, segment_capacity=segment_capacity,
                seed=seed, reference_cache=reference_cache,
                num_keys=num_keys, merge_allowance=merge_allowance)


def mixed_ops(seed, num_keys, n, mix, delete_frac=0.1):
    """test_writeplane.py:mixed_ops: deletes mixed into the writes."""
    w = Workload(num_keys=num_keys, zipf=1.2, mix=mix, seed=seed)
    kinds, keys = w.ops_arrays(n)
    rng = np.random.default_rng(seed + 7)
    kinds = kinds.copy()
    kinds[(kinds == 1) & (rng.random(n) < delete_frac)] = 2
    return kinds, keys


rc = pytest.mark.parametrize("reference_cache", [False, True])


# ------------------------------------------- test_dataplane.py's streams
@rc
@given(st.integers(0, 10**6), st.sampled_from(DATAPLANE_MIXES),
       st.floats(0.4, 2.1), st.integers(14, 21))
@settings(max_examples=3, deadline=None)
def test_batched_stats_identical(reference_cache, seed, mix, zipf,
                                 cache_pow):
    t = dataplane_twin(seed % 7, 1 << cache_pow, reference_cache)
    kinds, keys = Workload(num_keys=6000, zipf=zipf, mix=mix,
                           seed=seed).ops_arrays(3000)
    t.batch(kinds, keys)


@rc
@given(st.integers(0, 10**6))
@settings(max_examples=2, deadline=None)
def test_batch_read_values(reference_cache, seed):
    t = dataplane_twin(seed % 5, 1 << 19, reference_cache)
    keys = np.random.default_rng(seed).integers(0, 6000, 300)
    vals = t.both(lambda c: c.batch_read(keys)[0])
    assert vals == [f"v{k}" for k in keys.tolist()]
    t.check()


@rc
def test_dataplane_blocked_and_refused_kns(reference_cache):
    t = dataplane_twin(1, 1 << 19, reference_cache)
    victim = sorted(t.port.kns)[0]
    for c in t.clusters:
        c.kns[victim].available = False
    kinds, keys = Workload(num_keys=6000, zipf=0.99, mix="read_only",
                           seed=1).ops_arrays(2000)
    t.batch(kinds, keys)
    assert t.port.kns[victim].stats.refused > 0


# ------------------------------------------ test_writeplane.py's streams
@rc
@given(st.integers(0, 10**6), st.sampled_from(WRITEPLANE_MIXES),
       st.integers(15, 20), st.sampled_from([None, 24]),
       st.sampled_from([1 << 12, 1 << 7]))
@settings(max_examples=4, deadline=None)
def test_mixed_batches_identical(reference_cache, seed, mix, cache_pow,
                                 allowance, num_buckets):
    """Both merge allowances (tiny, none) and both bucket densities."""
    t = writeplane_twin(seed % 5, 1 << cache_pow, reference_cache,
                        num_buckets=num_buckets, merge_allowance=allowance)
    kinds, keys = mixed_ops(seed, 4000, 2000, mix)
    t.batch(kinds, keys, collect_values=True)
    probe = np.random.default_rng(seed).integers(0, 4200, 200)
    t.both(lambda c: c.batch_read(probe)[0])
    t.check()


@pytest.mark.parametrize("allowance,num_buckets",
                         [(None, 1 << 12), (24, 1 << 12), (None, 1 << 7),
                          (24, 1 << 7)])
@rc
def test_knob_grid(reference_cache, allowance, num_buckets):
    """Each cell of the merge-plane knob grid on one fixed stream."""
    t = writeplane_twin(2, 1 << 17, reference_cache,
                        num_buckets=num_buckets, merge_allowance=allowance)
    t.batch(*mixed_ops(5, 4000, 2000, "write_heavy_update"),
            collect_values=True)


@rc
@given(st.integers(0, 10**6))
@settings(max_examples=2, deadline=None)
def test_seal_boundaries_mid_batch(reference_cache, seed):
    """Segments of 24 entries: rotations and write stalls inside one
    batch, replayed at the per-op positions."""
    t = writeplane_twin(seed % 3, 1 << 19, reference_cache,
                        segment_capacity=24)
    t.batch(*mixed_ops(seed, 4000, 2500, "write_heavy_update",
                       delete_frac=0.05))
    assert t.port.pool.gc.segments_created > len(t.port.kns)
    assert sum(kn.stats.write_stalls for kn in t.port.kns.values()) > 0


@rc
def test_replicated_keys_in_write_batches(reference_cache):
    t = writeplane_twin(2, 1 << 19, reference_cache)
    hot = Workload(num_keys=4000, zipf=1.6, mix="write_heavy_update",
                   seed=2).hot_keys(4)
    for c in t.clusters:
        for k in hot:
            c.replicate_key(k, 3)
    t.check()
    kinds, keys = Workload(num_keys=4000, zipf=1.6,
                           mix="write_heavy_update",
                           seed=9).ops_arrays(2500)
    t.batch(kinds, keys, collect_values=True)
    assert np.isin(keys, np.array(hot)).any()
    assert t.port.pool.indirect


@rc
@given(st.integers(0, 10**6))
@settings(max_examples=2, deadline=None)
def test_writeplane_blocked_and_refused(reference_cache, seed):
    t = writeplane_twin(seed % 3, 1 << 19, reference_cache)
    victim, blocked = sorted(t.port.kns)[:2]
    for c in t.clusters:
        c.kns[victim].available = False
    t.batch(*mixed_ops(seed, 4000, 1500, "write_heavy_update"),
            blocked_kns=[blocked])
    assert t.port.kns[victim].stats.refused > 0


# ------------------------------------ the cluster phase's shape, small
def phase(t, batches=3, ops=1500, num_keys=4000):
    """chip_smoke.py's ``cluster`` phase at a small size: YCSB mixes at
    zipf 0.99 in batches, the merge allowance of one simulated second
    (as TimedSimulation's step), a KN added, one failed and one removed
    between batches."""
    budget = int(tcl.DEFAULT_MODEL.merge_capacity())
    step = 0
    for mix in ("write_heavy_update", "read_mostly_update"):
        w = Workload(num_keys=num_keys, zipf=0.99, mix=mix, seed=len(mix))
        for _ in range(batches):
            kinds, keys = w.ops_arrays(ops)
            for c in t.clusters:
                c.pool.merge_allowance = budget
            t.batch(kinds, keys, collect_values=True)
            t.both(lambda c: c.advance_merge(budget))
            for c in t.clusters:
                c.pool.merge_allowance = None
            step += 1
            if step == 2:
                t.both(lambda c: c.add_kn()[0])
            elif step == 4:
                t.both(lambda c: c.fail_kn("kn2").kind)
            elif step == 5:
                t.both(lambda c: c.remove_kn("kn1").kind)
            t.check()
    assert [r["event"] for r in t.port.reconfig_log] == \
        ["add", "fail", "remove"][:(step >= 2) + (step >= 4) + (step >= 5)]


@pytest.mark.parametrize("variant", VARIANTS)
@rc
def test_batches_through_reconfigurations(variant, reference_cache):
    t = Twin(variant, num_kns=4, cache_bytes=int(4000 * 1024 * 0.03),
             value_bytes=1024, num_buckets=1 << 12, segment_capacity=64,
             reference_cache=reference_cache)
    phase(t)
    written = np.unique(np.concatenate(
        [np.asarray(list(t.port.versions))]))
    t.both(lambda c: c.batch_read(written)[0])
    assert t.port.pool.verify_integrity() == []


def test_batches_under_the_sanitizer():
    """REPRO_SANITIZE=1: the window engine's cache writes happen under
    their owner, the warm load and reconfigurations under the management
    plane, on both packages alike."""
    for s in (js, ts):
        s.enable()
    try:
        t = Twin(num_kns=4, cache_bytes=1 << 17, value_bytes=1024,
                 num_buckets=1 << 12, segment_capacity=64)
        phase(t, batches=2)
        assert type(t.port.kns["kn3"].cache).__name__ == "GuardedArrayDAC"
    finally:
        for s in (js, ts):
            s.disable()


# ------------------------------------- the baselines: dinomo-s and clover
@rc
@given(st.integers(0, 10**6), st.sampled_from(BASELINES),
       st.sampled_from(WRITEPLANE_MIXES), st.integers(15, 20),
       st.sampled_from([None, 24]), st.sampled_from([1 << 12, 1 << 7]))
@settings(max_examples=4, deadline=None)
def test_baseline_mixed_batches_identical(reference_cache, seed, variant,
                                          mix, cache_pow, allowance,
                                          num_buckets):
    """TestWritePlaneEquivalence's knob grid for the baselines (Clover
    pins the uncontested density, as the reference's test does)."""
    if variant == "clover":
        num_buckets = 1 << 12
    t = writeplane_twin(seed % 5, 1 << cache_pow, reference_cache,
                        num_buckets=num_buckets, merge_allowance=allowance,
                        variant=variant)
    t.batch(*mixed_ops(seed, 4000, 2000, mix), collect_values=True)
    probe = np.random.default_rng(seed).integers(0, 4200, 200)
    t.both(lambda c: c.batch_read(probe)[0])
    t.check()


@pytest.mark.parametrize("variant", BASELINES)
@rc
def test_baseline_seal_boundaries_and_refusals(variant, reference_cache):
    """Segments of 24 (dinomo-s stalls and rotates mid-batch; Clover
    merges each write), then a refusing and a blocked KN."""
    t = writeplane_twin(1, 1 << 19, reference_cache, segment_capacity=24,
                        variant=variant)
    t.batch(*mixed_ops(3, 4000, 2500, "write_heavy_update",
                       delete_frac=0.05))
    if variant != "clover":
        assert t.port.pool.gc.segments_created > len(t.port.kns)
        assert sum(kn.stats.write_stalls for kn in t.port.kns.values()) > 0
    victim, blocked = sorted(t.port.kns)[:2]
    for c in t.clusters:
        c.kns[victim].available = False
    t.batch(*mixed_ops(4, 4000, 1500, "write_heavy_update"),
            blocked_kns=[blocked], collect_values=True)
    t.batch(np.zeros(1000, np.uint8),
            np.random.default_rng(2).integers(0, 4000, 1000),
            blocked_kns=[blocked])
    assert t.port.kns[victim].stats.refused > 0


@pytest.mark.parametrize("mix", DATAPLANE_MIXES + ["write_heavy_insert"])
@pytest.mark.parametrize("variant", BASELINES)
def test_baseline_planned_windows_identical(variant, mix):
    """TestPlannedEngine's bench-shaped batches: dinomo-s plans most of a
    write-heavy batch through plan_static_window, and plans some of every
    mix."""
    t = writeplane_twin(2, 1 << 19, False, num_keys=6000,
                        segment_capacity=256, variant=variant)
    t.batch(*mixed_ops(7, 6000, 4000, mix, delete_frac=0.05))
    if variant == "dinomo-s":
        total = tt.PLAN_STATS["planned_ops"] + tt.PLAN_STATS["replayed_ops"]
        assert tt.PLAN_STATS["planned_ops"] > 0
        if mix.startswith("write_heavy"):
            assert tt.PLAN_STATS["planned_ops"] > total // 2


def test_clover_read_batch_planned(monkeypatch):
    """test_writeplane.py's read-only Clover batch: every KN's slice is
    planned (plan_clover_reads) and applied in bulk; the twins' stats,
    metadata-server load and values equal. A batch whose plans could
    evict (a cache of 8 KB a KN) falls back to the per-op loop."""
    plans = []
    real = tcl.plan_clover_reads

    def counted(*args):
        wp = real(*args)
        plans.append(wp is not None)
        return wp

    monkeypatch.setattr(tcl, "plan_clover_reads", counted)
    for cache_bytes, planned in ((1 << 19, True), (1 << 13, False)):
        plans.clear()
        t = Twin("clover", num_kns=4, cache_bytes=cache_bytes,
                 value_bytes=1024, num_buckets=1 << 12, segment_capacity=64,
                 seed=1, num_keys=3000)
        kinds, keys = Workload(num_keys=3000, zipf=1.1, mix="read_only",
                               seed=5).ops_arrays(2000)
        res = t.batch(kinds, keys, collect_values=True)
        assert plans and all(plans) == planned
        assert t.port.ms_ops > 0
        ref = t.ref.pool
        for i in range(0, 2000, 97):
            assert res.values[i] == ref.heap_val[
                ref.index_lookup(int(keys[i]))[0]]


@rc
def test_clover_index_copy_follows_every_batch(reference_cache):
    """Clover batches with deletes and inserts that grow bucket chains:
    after every batch the port's packed index copy (the next batch's
    probe, kernel A's plain version here) equals the host index row for
    row (Twin.batch), as does the reference's index."""
    t = writeplane_twin(4, 1 << 18, reference_cache, variant="clover")
    head0 = t.port.pool.index.overflow_head
    for seed in range(4):
        t.batch(*mixed_ops(seed, 4000, 1500, "write_heavy_insert",
                           delete_frac=0.2), collect_values=True)
        t.batch(*mixed_ops(seed + 10, 4000, 800, "read_mostly_update",
                           delete_frac=0.2))
    assert t.port.pool.index.overflow_head > head0
    assert t.port.pool.index_dev is not None or reference_cache


@pytest.mark.parametrize("variant", BASELINES)
def test_baseline_batches_under_the_sanitizer(variant):
    """REPRO_SANITIZE=1: the static windows' and the Clover plane's
    cache writes under the serving KN, the warm load and the
    reconfigurations under the management plane, alike on both."""
    for s in (js, ts):
        s.enable()
    try:
        t = Twin(variant, num_kns=4, cache_bytes=1 << 17, value_bytes=1024,
                 num_buckets=1 << 12, segment_capacity=64)
        phase(t, batches=2)
        assert type(t.port.kns["kn3"].cache).__name__.startswith(
            "GuardedArray")
    finally:
        for s in (js, ts):
            s.disable()


def test_the_planner_and_the_replay_both_run():
    """Coverage: the batched twin plans windows and replays others (a
    write-heavy batch on a warm cache, test_writeplane.py's planned
    engine case; a read-mostly one on a cache of 32 KB a KN), and the port's engine clock counts both stages."""
    tt.reset_engine_wall()
    t = writeplane_twin(3, 1 << 19, False, num_keys=6000,
                        segment_capacity=256)
    t.batch(*mixed_ops(3, 6000, 4000, "write_heavy_update", 0.05))
    assert tt.PLAN_STATS["planned_ops"] > 0
    t = writeplane_twin(3, 1 << 15, False, num_keys=6000,
                        segment_capacity=256)
    t.batch(*mixed_ops(4, 6000, 3000, "read_mostly_update", 0.05))
    assert tt.PLAN_STATS["replayed_ops"] > 0
    assert tt.ENGINE_WALL["host_plan"] > 0
    assert tt.ENGINE_WALL["host_replay"] > 0
