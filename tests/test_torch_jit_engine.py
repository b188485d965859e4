"""Port parity for the compiled batch engine, ``execute_batch(engine=
"jit")``: twin clusters, the reference's ``DinomoCluster`` and the port's
(``device="cpu"``, so each dispatch runs kernel E's plain version), both
with ``engine="jit"``, on the streams of the reference's jit tests --
tests/test_dataplane.py's TestJitEngineEquivalence (with its coverage
pin: windows dispatched and residuals replayed), tests/test_writeplane.py's
TestJitWritePlane (deletes, tiny merge allowances, contested indexes,
seal boundaries) and tests/test_mergeplane.py's TestJitClusterMergePlane.
After every batch the BatchResults, collected values, the planner's and
the merge plane's counters and the whole states
(tests/torch_cluster_cases.py:cluster_state, the caches' lazy heaps
included) are equal. The port's jit cluster is also held to the port's
host engine (the same state less the lazy heaps' records, which the jit
engine re-seeds at its scatter-back), and one stream runs under the
ownership sanitizer. Exact comparisons throughout."""

import contextlib

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
from repro_torch.core import jit_engine as jen  # noqa: E402
from repro_torch.core import sanitize as ts  # noqa: E402
from repro_torch.core import transition as tt  # noqa: E402
from torch_cluster_cases import batch_result, cluster_state  # noqa: E402

MIX_NAMES = ["read_only", "read_mostly_update", "read_mostly_insert",
             "write_heavy_update", "write_heavy_insert"]


class JitTwin:
    """The reference's cluster and the port's, built and loaded alike,
    both run with engine="jit"; with ``host`` a third, the port's, run
    with the host engine."""

    def __init__(self, num_keys, merge_allowance=None, host=False, **kw):
        self.ref = jcl.DinomoCluster(jcl.VARIANTS["dinomo"], **kw)
        self.port = tcl.DinomoCluster(tcl.VARIANTS["dinomo"], device="cpu",
                                      **kw)
        self.host = tcl.DinomoCluster(tcl.VARIANTS["dinomo"], device="cpu",
                                      **kw) if host else None
        for c in self.clusters:
            c.load(((k, f"v{k}") for k in range(num_keys)), warm=True)
            c.pool.merge_allowance = merge_allowance

    @property
    def clusters(self):
        return (self.ref, self.port) + ((self.host,) if self.host else ())

    def batch(self, kinds, keys, **kw):
        """One execute_batch on each; every result field, the planner's
        and the merge plane's counters (reset first) and the states
        equal. Returns the port's jit result."""
        out, plan, merge = [], [], []
        for c in self.clusters:
            for stats in (jt.PLAN_STATS, tt.PLAN_STATS,
                          jt.MERGE_PLAN_STATS, tt.MERGE_PLAN_STATS):
                for k in stats:
                    stats[k] = 0
            out.append(c.execute_batch(
                kinds, keys, values=lambda i: f"w{i}",
                engine="host" if c is self.host else "jit", **kw))
            mod = jt if c is self.ref else tt
            plan.append(dict(mod.PLAN_STATS))
            merge.append(dict(mod.MERGE_PLAN_STATS))
        assert batch_result(out[0]) == batch_result(out[1])
        assert plan[0] == plan[1] and merge[0] == merge[1]
        self.check()
        if self.host:
            assert batch_result(out[2]) == batch_result(out[1])
            assert merge[2] == merge[1]
        return out[1]

    def check(self):
        a, b = cluster_state(self.ref), cluster_state(self.port)
        for k in a:
            assert a[k] == b[k], k
        if self.host:
            assert cluster_state(self.host, heaps=False) == \
                cluster_state(self.port, heaps=False)


def dataplane_twin(seed, cache_bytes, host=False):
    """test_dataplane.py:build_jit_pair's cluster."""
    return JitTwin(6000, num_kns=4, cache_bytes=cache_bytes,
                   value_bytes=1024, num_buckets=1 << 13,
                   segment_capacity=256, seed=seed, host=host)


def writeplane_twin(seed, cache_bytes, num_keys=4000, segment_capacity=64,
                    num_buckets=1 << 12, merge_allowance=None):
    """test_writeplane.py:build_jit_pair's cluster."""
    return JitTwin(num_keys, num_kns=4, cache_bytes=cache_bytes,
                   value_bytes=1024, num_buckets=num_buckets,
                   segment_capacity=segment_capacity, seed=seed,
                   merge_allowance=merge_allowance)


def mixed_ops(seed, num_keys, n, mix, delete_frac=0.1):
    """test_writeplane.py:mixed_ops: deletes mixed into the writes."""
    w = Workload(num_keys=num_keys, zipf=1.2, mix=mix, seed=seed)
    kinds, keys = w.ops_arrays(n)
    rng = np.random.default_rng(seed + 7)
    kinds = kinds.copy()
    kinds[(kinds == 1) & (rng.random(n) < delete_frac)] = 2
    return kinds, keys


# ------------------------------------------- test_dataplane.py's streams
@given(st.integers(0, 10**6), st.sampled_from(MIX_NAMES),
       st.floats(0.4, 2.1), st.integers(14, 21))
@settings(max_examples=4, deadline=None)
def test_stats_identical(seed, mix, zipf, cache_pow):
    t = dataplane_twin(seed % 7, 1 << cache_pow)
    kinds, keys = Workload(num_keys=6000, zipf=zipf, mix=mix,
                           seed=seed).ops_arrays(4000)
    t.batch(kinds, keys)


def test_dispatch_and_replay_both_engage():
    """Coverage pin: a write-heavy trace on a tight cache dispatches
    device windows and hands truncation residuals to the host replay on
    the port as on the reference; the jit cluster equals the port's host
    engine."""
    t = dataplane_twin(3, 1 << 15, host=True)
    kinds, keys = Workload(num_keys=6000, zipf=1.2,
                           mix="write_heavy_update",
                           seed=3).ops_arrays(6000)
    tt.reset_engine_wall()
    t.batch(kinds, keys)
    assert tt.ENGINE_WALL["jit_dispatch"] > 0
    assert tt.ENGINE_WALL["host_replay"] > 0
    counts = t.port._jit.counts
    assert counts["dispatches"] > 0 and counts["host_replays"] > 0
    assert counts["cut_segcache"] > 0


def test_collected_values_identical():
    t = dataplane_twin(5, 1 << 18, host=True)
    kinds, keys = Workload(num_keys=6000, zipf=0.99,
                           mix="read_mostly_update",
                           seed=5).ops_arrays(3000)
    res = t.batch(kinds, keys, collect_values=True)
    assert res.values.count(None) == int((kinds != 0).sum())


def test_chained_batches_stay_identical():
    """Residency across batches: the state is uploaded once a batch and
    scattered back at its end; a later batch sees exactly the state the
    host engine would have."""
    t = dataplane_twin(7, 1 << 17, host=True)
    for s in range(3):
        kinds, keys = Workload(num_keys=6000, zipf=1.1,
                               mix="write_heavy_update",
                               seed=s).ops_arrays(2000)
        t.batch(kinds, keys)


# ------------------------------------------ test_writeplane.py's streams
@given(st.integers(0, 10**6), st.sampled_from(MIX_NAMES[1:]),
       st.integers(15, 20), st.sampled_from([None, 24]),
       st.sampled_from([1 << 12, 1 << 7]))
@settings(max_examples=4, deadline=None)
def test_mixed_batches_identical(seed, mix, cache_pow, allowance,
                                 num_buckets):
    """Deletes inside device windows, both merge allowances (tiny, none)
    and both bucket densities; then batched reads."""
    t = writeplane_twin(seed % 5, 1 << cache_pow, num_buckets=num_buckets,
                        merge_allowance=allowance)
    t.batch(*mixed_ops(seed, 4000, 3000, mix), collect_values=True)
    probe = np.random.default_rng(seed).integers(0, 4200, 200)
    assert t.ref.batch_read(probe)[0] == t.port.batch_read(probe)[0]
    t.check()


@given(st.integers(0, 10**6))
@settings(max_examples=2, deadline=None)
def test_seal_boundaries_mid_batch(seed):
    """Segments of 24: rotations and stall merges land mid-window and
    invalidate device-side prefetches (the dirty key and bucket seam)."""
    t = writeplane_twin(seed % 3, 1 << 19, segment_capacity=24)
    t.batch(*mixed_ops(seed, 4000, 2500, "write_heavy_update",
                       delete_frac=0.05))
    assert sum(kn.stats.write_stalls for kn in t.port.kns.values()) > 0


def test_stall_merges_with_collected_values():
    """test_writeplane.py:test_linearizable_jit_with_stall_merges's run:
    a jit-batched put/get/update stream with interleaved stall merges;
    every collected value equal."""
    t = JitTwin(2000, num_kns=4, cache_bytes=1 << 19, value_bytes=1024,
                num_buckets=1 << 12, segment_capacity=24, seed=3)
    kinds, keys = mixed_ops(11, 2000, 1500, "write_heavy_update",
                            delete_frac=0.0)
    t.batch(kinds, keys, collect_values=True)
    assert sum(kn.stats.write_stalls for kn in t.port.kns.values()) > 0


# ------------------------------------------ test_mergeplane.py's streams
@given(st.integers(0, 10**6))
@settings(max_examples=2, deadline=None)
def test_stall_merges_jit_identical(seed):
    """TestJitClusterMergePlane: stall merges dirty keys and buckets
    mid-batch, through the planned merge plane."""
    t = writeplane_twin(seed % 3, 1 << 19, segment_capacity=24)
    kinds, keys = Workload(num_keys=4000, zipf=1.2,
                           mix="write_heavy_update",
                           seed=seed % 101).ops_arrays(2000)
    t.batch(kinds, keys)
    assert tt.MERGE_PLAN_STATS["planned_entries"] > 0
    assert sum(kn.stats.write_stalls for kn in t.port.kns.values()) > 0


def test_contested_index_jit():
    """Chain growth mid-run (2^8 buckets): merge-plan truncation and
    scalar replay inside stall merges, under the jit engine."""
    t = writeplane_twin(1, 1 << 19, num_keys=600, segment_capacity=32,
                        num_buckets=1 << 8)
    kinds, keys = Workload(num_keys=600, zipf=1.0,
                           mix="write_heavy_insert",
                           seed=3).ops_arrays(1500)
    t.batch(kinds, keys)
    assert tt.MERGE_PLAN_STATS["planned_entries"] > 0
    assert tt.MERGE_PLAN_STATS["replayed_entries"] > 0


# ------------------------------- reconfigurations, replication, sanitizer
def test_jit_through_reconfigurations_and_replication():
    """chip_smoke.py's cluster phase, small: YCSB batches with merges
    between them, a KN added, one failed, replicated hot keys (their ops
    scatter the resident state back first)."""
    t = JitTwin(4000, num_kns=4, cache_bytes=int(4000 * 1024 * 0.03),
                value_bytes=1024, num_buckets=1 << 12, segment_capacity=64,
                host=True)
    budget = int(tcl.DEFAULT_MODEL.merge_capacity())
    hot = Workload(num_keys=4000, zipf=1.6, mix="write_heavy_update",
                   seed=2).hot_keys(3)
    for step, mix in enumerate(["write_heavy_update", "read_mostly_update"]
                               * 2):
        kinds, keys = Workload(num_keys=4000, zipf=0.99, mix=mix,
                               seed=step).ops_arrays(1500)
        for c in t.clusters:
            c.pool.merge_allowance = budget
        t.batch(kinds, keys, collect_values=True)
        for c in t.clusters:
            c.advance_merge(budget)
            c.pool.merge_allowance = None
            if step == 0:
                for k in hot:
                    c.replicate_key(k, 3)
            if step == 1:
                c.add_kn()
            if step == 2:
                c.fail_kn("kn2")
        t.check()
    assert t.port._jit.counts["dispatches"] > 0


def test_jit_under_the_sanitizer():
    """REPRO_SANITIZE=1: the jit engine's scatter-back writes each cache
    under its owner, on both packages alike."""
    for s in (js, ts):
        s.enable()
    try:
        t = writeplane_twin(2, 1 << 17)
        t.batch(*mixed_ops(5, 4000, 2000, "write_heavy_update"),
                collect_values=True)
        assert type(t.port.kns["kn3"].cache).__name__ == "GuardedArrayDAC"
        assert t.port._jit.counts["syncs"] > 0
    finally:
        for s in (js, ts):
            s.disable()


# ------------------------------- the residency kept across batches
@contextlib.contextmanager
def moved_slots_checked(cluster):
    """Check every upload and scatter-back of ``cluster``'s jit engine:
    the slots a delta upload sends are exactly those where the cache
    arrays differ from the engine's shadow (a full diff: no host write
    path escaped the record), and the slots a scatter-back moves cover
    every slot where the device copy differs from the shadow. Yields the
    numbers of checked uploads and syncs."""
    real_delta, real_sync = jen.JitEngine._delta, jen.JitEngine.sync_kn
    seen = {"uploads": 0, "syncs": 0}

    def delta(self, res):
        cache = res.cache
        host = np.stack([getattr(cache, f)[:res.nslots]
                         for f in jen._FIELDS]).astype(np.int64)
        want = np.flatnonzero((host != res.shadow).any(axis=0))
        sent = real_delta(self, res)
        np.testing.assert_array_equal(sent, want)
        seen["uploads"] += 1
        return sent

    def sync(self, name):
        res = self.resident.get(name)
        if res is not None and res.live:
            dev = np.stack([t.numpy()[:res.nslots]
                            for t in res.state[:5]]).astype(np.int64)
            changed = (dev != res.shadow).any(axis=0) | \
                (res.state[5].numpy()[:res.nslots] != 0)
            d = res.dirty.numpy()
            words = (res.pad + 31) // 32
            listed = set(d[1 + words:1 + words + res.dcount].tolist())
            assert int(d[0]) == res.dcount
            assert set(np.flatnonzero(changed).tolist()) <= listed
            seen["syncs"] += 1
        return real_sync(self, name)

    jen.JitEngine._delta, jen.JitEngine.sync_kn = delta, sync
    try:
        yield seen
    finally:
        jen.JitEngine._delta, jen.JitEngine.sync_kn = real_delta, real_sync


def test_record_and_dirty_list_cover_every_change():
    """Chained YCSB batches through replication, a join and a failure,
    with deletes and host replays: at every delta upload the cache's
    record equals a full diff against the shadow, at every scatter-back
    the device's list covers every changed slot; the residency outlives
    the batches (a full upload only at first use and after each
    reconfiguration's clear); every state equal to the reference's jit
    engine and to the port's host engine."""
    t = JitTwin(4000, num_kns=4, cache_bytes=int(4000 * 1024 * 0.03),
                value_bytes=1024, num_buckets=1 << 12, segment_capacity=64,
                host=True)
    hot = Workload(num_keys=4000, zipf=1.6, mix="write_heavy_update",
                   seed=4).hot_keys(3)
    with moved_slots_checked(t.port) as seen:
        for step in range(7):
            mix = MIX_NAMES[1 + step % 4]
            t.batch(*mixed_ops(step, 4000, 4000, mix, delete_frac=0.02),
                    collect_values=True)
            counts = t.port._jit.counts
            if step == 0:
                assert counts["full_uploads"] == 4
            if step == 1:
                for c in t.clusters:
                    for k in hot:
                        c.replicate_key(k, 3)
            if step == 3:
                for c in t.clusters:
                    c.add_kn()
            if step == 4:
                for c in t.clusters:
                    c.fail_kn("kn2")
                assert "kn2" not in t.port._jit.resident
            t.check()
    counts = t.port._jit.counts
    assert seen["uploads"] == counts["uploads"] - counts["full_uploads"] > 0
    assert seen["syncs"] == counts["syncs"] > 10
    assert counts["upload_deltas"] > 0 and counts["host_replays"] > 0
    # whole uploads: first use, then the caches the join and the failure
    # cleared
    assert counts["full_uploads"] > 4
    assert counts["launches"] < counts["dispatches"]


def test_chained_batches_move_only_changed_slots():
    """Without reconfigurations the four caches are uploaded whole once;
    every later upload and scatter-back moves a small share of the
    slots, and the states stay equal to both twins'."""
    t = dataplane_twin(11, 1 << 17, host=True)
    with moved_slots_checked(t.port):
        for s in range(4):
            kinds, keys = Workload(num_keys=6000, zipf=1.1,
                                   mix="write_heavy_update",
                                   seed=s).ops_arrays(2000)
            t.batch(kinds, keys)
    counts = t.port._jit.counts
    nslots = max(r.nslots for r in t.port._jit.resident.values())
    assert counts["full_uploads"] == 4
    assert counts["sync_slots"] < counts["syncs"] * nslots // 2


def test_deepcopy_drops_the_residency():
    """A copied cluster's engine holds no residency and its caches
    record nothing; both go on equal to each other (chip_smoke.py's
    cluster phase copies a loaded cluster)."""
    import copy
    a = tcl.DinomoCluster(tcl.VARIANTS["dinomo"], device="cpu", num_kns=4,
                          cache_bytes=1 << 17, value_bytes=1024,
                          num_buckets=1 << 12, segment_capacity=64)
    a.load(((k, f"v{k}") for k in range(3000)), warm=True)
    kinds, keys = Workload(num_keys=3000, zipf=1.1, mix="write_heavy_update",
                           seed=1).ops_arrays(1500)
    a.execute_batch(kinds, keys, values=lambda i: f"w{i}", engine="jit")
    assert a._jit.resident
    assert all(kn.cache._dirty is not None for kn in a.kns.values())
    b = copy.deepcopy(a)
    assert not b._jit.resident
    assert all(kn.cache._dirty is None for kn in b.kns.values())
    kinds, keys = Workload(num_keys=3000, zipf=1.1, mix="write_heavy_update",
                           seed=2).ops_arrays(1500)
    got = [batch_result(c.execute_batch(kinds, keys, values=lambda i: f"x{i}",
                                        engine="jit")) for c in (a, b)]
    assert got[0] == got[1]
    assert cluster_state(a) == cluster_state(b)
    assert b._jit.counts["full_uploads"] - a._jit.counts["full_uploads"] == 4
