"""Port parity for the cluster's host engine, per-op side:
repro_torch.core.cluster.DinomoCluster (the DAC variants, dinomo and
dinomo-n) against the reference's DinomoCluster, as twin clusters built
with the same arguments and seed (the port's with ``device="cpu"``) and
driven by the reference's own op streams: tests/test_cluster.py's
``run_mixed``, its reconfiguration cases (add, remove, fail, participants
only, data movement) and its selective-replication cases, with both
caches (``reference_cache`` False and True). After every step the twins'
returns and whole states (tests/torch_cluster_cases.py:cluster_state:
statistics, caches, ownership, the route's random state, the
reconfiguration log, the pool's index row for row, heap and logs) are
equal. Also: the refusals of what is not ported, the ring's vectorized
owners, the M-node's decisions, and the bulk warm load against the
per-key loop. Exact comparisons throughout: every value here is an
integer or a host decision."""

import dataclasses

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

torch = pytest.importorskip("torch")

from repro.core import cluster as jcl  # noqa: E402
from repro.core import hashring as jh  # noqa: E402
from repro.core import mnode as jm  # noqa: E402
from repro.core import sanitize as js  # noqa: E402
from repro_torch.core import cluster as tcl  # noqa: E402
from repro_torch.core import hashring as th  # noqa: E402
from repro_torch.core import mnode as tm  # noqa: E402
from repro_torch.core import sanitize as ts  # noqa: E402
from torch_cluster_cases import batch_result, cluster_state  # noqa: E402

VARIANTS = ("dinomo", "dinomo-n")
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
        """Zero movement for dinomo (ownership moves, not data), some for
        the shared-nothing dinomo-n."""
        t = mk(variant, keys=1000, reference_cache=reference_cache)
        t.both(lambda c: c.add_kn())
        t.check()
        moved = t.port.reconfig_log[-1]["moved_fraction"]
        assert (moved == 0.0) == (variant == "dinomo")

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


# ------------------------------------------------------------- refusals
@pytest.mark.parametrize("variant", ["dinomo-s", "clover"])
def test_non_dac_variants_raise_naming_item_2b(variant):
    with pytest.raises(NotImplementedError, match="Queue 2 item 2b"):
        tcl.DinomoCluster(tcl.VARIANTS[variant], num_kns=1,
                          num_buckets=8, device="cpu")


@pytest.mark.parametrize("policy", ["shortcut", "value", "static:0.5",
                                    "clover"])
def test_make_cache_raises_naming_item_2b(policy):
    with pytest.raises(NotImplementedError, match="Queue 2 item 2b"):
        tcl.make_cache(policy, 1 << 16)
    with pytest.raises(ValueError, match="unknown cache policy"):
        tcl.make_cache("lru", 1 << 16)


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


def test_static_replay_raises_naming_item_2b():
    c = tcl.DinomoCluster(num_kns=1, num_buckets=64, segment_capacity=16,
                          device="cpu")
    kn = c.kns["kn1"]
    with pytest.raises(NotImplementedError, match="Queue 2 item 2b"):
        c._replay_span(kn, kn.cache, False, np.arange(2),
                       np.arange(2), np.zeros(2, np.uint8), None, {},
                       set(), set(), None)


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
