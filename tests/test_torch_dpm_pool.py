"""Port parity for the DPM pool: repro_torch.core.dpm_pool.DPMPool (with
its NumpyCLHT, PySegment, FaultPlane and sanitizer) against the
reference's DPMPool, as twin pools driven by the reference's own op
streams: the merge interleavings of tests/test_mergeplane.py, the fence
cases of tests/test_fencing.py, and the armed and forced crashes of
tests/test_faultplane.py with recover_kn. After every step the twins'
returned values and whole states (index arrays, heap, segments, merge
backlog, GC counters, request table, indirection, fences) are equal, and
so are their verify_integrity() reports; after every round the port's
batched index read, which runs on its packed copy of the index through
kernel A's plain version here, equals the reference's host walk.
Exact comparisons throughout."""

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

torch = pytest.importorskip("torch")

from repro.core import Op, check_history  # noqa: E402
from repro.core import clht as jc  # noqa: E402
from repro.core import dpm_pool as jd  # noqa: E402
from repro.core import faults as jf  # noqa: E402
from repro.core import log as jl  # noqa: E402
from repro.core import sanitize as js  # noqa: E402
from repro.core import transition as jt  # noqa: E402
from repro_torch.core import clht as tc  # noqa: E402
from repro_torch.core import dpm_pool as td  # noqa: E402
from repro_torch.core import faults as tf  # noqa: E402
from repro_torch.core import log as tl  # noqa: E402
from repro_torch.core import sanitize as ts  # noqa: E402
from repro_torch.core import transition as tt  # noqa: E402

IMPLS = {"ref": (jd, jf), "port": (td, tf)}


def make(impl: str, **kw):
    mod, _ = IMPLS[impl]
    if impl == "port":
        kw["device"] = "cpu"
    return mod.DPMPool(**kw)


# ------------------------------------------------------------ comparing
def canon(x):
    """A returned value in comparable form: fenced no-ops as tuples,
    arrays as lists, segments by their entries."""
    if isinstance(x, (jd.FencedWrite, td.FencedWrite)):
        return ("fenced", x.kn, x.op, x.token, x.current)
    if isinstance(x, (jl.PySegment, tl.PySegment)):
        return ("seg", x.kn, list(x.entries))
    if isinstance(x, np.ndarray):
        return ("array", str(x.dtype), x.tolist())
    if isinstance(x, (list, tuple)):
        return type(x).__name__, [canon(v) for v in x]
    if isinstance(x, dict):
        return {k: canon(v) for k, v in x.items()}
    if isinstance(x, np.generic):
        return x.item()
    return x


def state(p, fenced=True):
    """Everything a pool holds, with segments named by their order of
    first appearance (heap, then the KNs' lists, then the backlog), so
    two pools compare equal iff they evolved alike (the record of fenced
    writes left out when ``fenced`` is False)."""
    ids: dict[int, int] = {}

    def sid(s):
        if s is None:
            return None
        return ids.setdefault(id(s), len(ids))

    heap_seg = [sid(s) for s in p.heap_seg]
    segs = {kn: [(sid(s), s.kn, list(s.entries), list(s.sealed),
                  list(s.reqs), list(s.gens), list(s.gen_marks), s.valid,
                  s.merged_upto, s.capacity) for s in lst]
            for kn, lst in p.segments.items()}
    backlog = [(sid(s), d) for s, d in p.merge_backlog]
    ix = p.index
    return (ix.keys.tolist(), ix.ptrs.tolist(), ix.nxt.tolist(),
            ix.overflow_head, ix.size, ix.version, ix.num_buckets,
            list(p.heap_val), list(p.heap_len), heap_seg, segs, backlog,
            (p.gc.segments_created, p.gc.segments_collected,
             p.gc.entries_merged),
            dict(p.req_index), dict(p.indirect), p._indirect_version,
            dict(p.fence),
            [canon(f) for f in p.fenced_writes] if fenced else None,
            p.merge_allowance, p.segment_capacity, p.unmerged_threshold,
            p.vectorized, p.meta_version)


class Twin:
    """A reference pool and a port pool driven in lockstep: every call
    returns the same value (or raises the same crash) on both, and
    leaves equal states."""

    def __init__(self, **kw):
        self.ref = make("ref", **kw)
        self.port = make("port", **kw)
        self.planes = None

    def attach_faults(self, seed=0):
        self.planes = (jf.FaultPlane(seed=seed), tf.FaultPlane(seed=seed))
        self.ref.faults, self.port.faults = self.planes

    def detach_faults(self):
        self.ref.faults = self.port.faults = None

    def call(self, name, *args, check=True, **kw):
        out = []
        for p in (self.ref, self.port):
            try:
                out.append(("ok", canon(getattr(p, name)(*args, **kw))))
            except (jf.KNCrash, tf.KNCrash) as e:
                out.append(("crash", e.kn, str(e.point)))
        assert out[0] == out[1], (name, out)
        if check:
            self.check()
        if out[0][0] == "crash":
            raise tf.KNCrash(out[0][1], out[0][2])
        return out[0][1]

    def each(self, fn):
        """Run ``fn(pool)`` on both (test-side setup that reaches into a
        pool, as the reference's tests do); returns both results."""
        return fn(self.ref), fn(self.port)

    def check(self):
        assert state(self.ref) == state(self.port)

    def check_reads(self, keys):
        """The port's batched read on the card copy == the reference's
        host walk == the port's host walk; and the card copy equals the
        host index row for row."""
        keys = np.asarray(keys, np.int64)
        want = self.ref.index_lookup_batch(keys)
        got = self.port.index_lookup_batch(keys)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype == np.int64
            np.testing.assert_array_equal(g, w)
        host = self.port.index.lookup_batch(keys)
        plain = ~np.isin(keys, list(self.port.indirect))
        for g, h in zip(got, host):
            np.testing.assert_array_equal(g[plain], h[plain])
        mirror_equals_host(self.port)


def mirror_equals_host(pool):
    """The pool's packed card copy holds the host index row for row."""
    t = pool.sync_index()
    ix = pool.index
    lines = t.lines.cpu().numpy()
    np.testing.assert_array_equal(lines[:, :3], ix.keys)
    np.testing.assert_array_equal(lines[:, 3:6], ix.ptrs)
    np.testing.assert_array_equal(lines[:, 6], ix.nxt)
    assert int(t.overflow_head) == ix.overflow_head
    assert t.num_buckets == ix.num_buckets


def read_keys(space):
    return np.concatenate([np.arange(space), [space + 7, -1, -3]])


# ------------------------------------------------------- structures alone
def test_modules_are_copies_of_the_reference():
    assert tuple(p.value for p in tf.CRASH_POINTS) == \
        tuple(p.value for p in jf.CRASH_POINTS)
    assert tf.LOG_MERGE_POINTS == jf.LOG_MERGE_POINTS
    assert tf.PARTITION_KINDS == jf.PARTITION_KINDS
    assert ts.MANAGEMENT == js.MANAGEMENT
    assert ts.enabled() == js.enabled()
    assert tt.MIN_MERGE_PLAN_OPS == jt.MIN_MERGE_PLAN_OPS
    assert (tc.SLOTS, tc.MAX_CHAIN) == (jc.SLOTS, jc.MAX_CHAIN)
    g = td.GCStats()
    assert (g.segments_created, g.segments_collected,
            g.entries_merged) == (0, 0, 0)
    f = td.FencedWrite("a", "log_write", 1, 2)
    assert not f and canon(f) == canon(jd.FencedWrite("a", "log_write", 1,
                                                      2))


def test_fault_plane_draws_like_the_reference():
    a = jf.FaultPlane(seed=5, drop_flush_rt_rate=0.3,
                      heartbeat_jitter_s=0.2)
    b = tf.FaultPlane(seed=5, drop_flush_rt_rate=0.3,
                      heartbeat_jitter_s=0.2)
    assert [a.drop_flush_rt() for _ in range(50)] == \
        [b.drop_flush_rt() for _ in range(50)]
    np.testing.assert_array_equal(a.drop_flush_mask(40),
                                  b.drop_flush_mask(40))
    assert a.heartbeat_delay() == b.heartbeat_delay()
    pa = a.schedule_partition("k", "kn-dpm", 10.0, 1.0, 2.0)
    pb = b.schedule_partition("k", "kn-dpm", 10.0, 1.0, 2.0)
    assert (pa.start_s, pa.end_s) == (pb.start_s, pb.end_s)
    assert a.partitioned_kns("kn-dpm", pa.start_s) == \
        b.partitioned_kns("kn-dpm", pb.start_s)
    a.fail_slow("k", 3.0, 1.0, 2.0)
    b.fail_slow("k", 3.0, 1.0, 2.0)
    assert a.slow_factor("k", 1.5) == b.slow_factor("k", 1.5) == 3.0
    assert a.heal_partitions(t=0.5) == b.heal_partitions(t=0.5)
    with pytest.raises(ValueError, match="unknown crash point"):
        b.arm_crash("log.not_a_point")
    with pytest.raises(ValueError):
        b.partition("k", "kn-bogus", 0.0)


def test_sanitizer_guards_like_the_reference():
    class Cache:
        def __init__(self):
            self.kind = np.zeros(4, np.int8)

    for mod in (js, ts):
        was = mod.enabled()
        mod.enable()
        try:
            c = mod.guard_cache(Cache(), "kn1")
            with mod.owned("kn1"):
                c.kind[0] = 1
            with mod.management():
                c.kind[1] = 1
            with pytest.raises(mod.OwnershipViolation):
                with mod.owned("kn2"):
                    c.kind[2] = 1
            c.kind = np.ones(8, np.int8)       # rebinding keeps the guard
            with pytest.raises(mod.OwnershipViolation):
                c.kind[0] = 0
            assert c.kind[[0, 1]].copy()._repro_owner is None
        finally:
            if not was:
                mod.disable()


@given(st.integers(0, 10**6), st.integers(2, 7), st.integers(1, 200))
@settings(max_examples=30, deadline=None)
def test_insert_batch_equals_the_scalar_sequence(seed, nb_pow, n):
    """TestPlannedInsertEquivalence.test_adversarial_tables on the port's
    NumpyCLHT: insert_batch == the scalar inserts, entry for entry, and
    both equal the reference's table."""
    rng = np.random.default_rng(seed)
    a, b = tc.NumpyCLHT(1 << nb_pow), tc.NumpyCLHT(1 << nb_pow)
    r = jc.NumpyCLHT(1 << nb_pow)
    for k in rng.integers(0, 150, int(rng.integers(0, 80))):
        for t in (a, b, r):
            t.insert(int(k), int(k) + 500)
    hot = rng.integers(0, 150, 37)
    keys = np.where(rng.random(n) < 0.5, hot[rng.integers(0, 37, n)],
                    rng.integers(0, 150, n)).astype(np.int64)
    ptrs = rng.integers(0, 10**6, n).astype(np.int64)
    olds, oks = [], []
    for k, p in zip(keys, ptrs):
        o, okk = a.insert(int(k), int(p))
        olds.append(-1 if o is None else o)
        oks.append(okk)
    ob, okb, grown = b.insert_batch(keys, ptrs)
    orf, okr, grown_r = r.insert_batch(keys, ptrs)
    assert olds == ob.tolist() == orf.tolist()
    assert oks == okb.tolist() == okr.tolist()
    assert grown == grown_r
    for t in (b, r):
        for f in ("keys", "ptrs", "nxt"):
            np.testing.assert_array_equal(getattr(a, f), getattr(t, f))
        assert (a.overflow_head, a.size, a.version) == \
            (t.overflow_head, t.size, t.version)


def test_planned_insert_path_engages():
    t = tc.NumpyCLHT(1 << 12)
    rng = np.random.default_rng(0)
    keys = rng.integers(0, 4000, 512).astype(np.int64)
    tt.reset_merge_plan_stats()
    t.insert_batch(keys, rng.integers(0, 10**6, 512))
    assert tt.MERGE_PLAN_STATS["planned_entries"] == 512
    assert tt.MERGE_PLAN_STATS["replayed_entries"] == 0


def test_noted_rows_cover_every_write():
    """Every row an insert, a chain growth (the tail's link), a delete or
    a plan writes is noted, and nothing before track_rows."""
    t = tc.NumpyCLHT(4, overflow_buckets=16)
    t.insert(1, 1)
    assert t.noted_rows().size == 0
    t.track_rows()
    ks = [k for k in range(4000) if t._bucket(k) == 2][:8]
    before = t.keys.copy(), t.ptrs.copy(), t.nxt.copy()
    for k in ks:
        t.insert(k, k + 1)              # fills bucket 2, then grows it
    t.delete(ks[1])
    plan = tt.plan_merge_window(t, np.arange(100, 140, dtype=np.int64),
                                np.arange(40, dtype=np.int64))
    if plan is not None:
        t.apply_merge_plan(plan)
    changed = np.flatnonzero((t.keys != before[0]).any(1)
                             | (t.ptrs != before[1]).any(1)
                             | (t.nxt != before[2]))
    noted = t.noted_rows()
    assert set(changed.tolist()) <= set(noted.tolist())
    assert np.array_equal(noted, t.noted_rows())   # kept until cleared
    t.clear_noted()
    assert t.noted_rows().size == 0


def test_noted_rows_stay_bounded_under_scalar_writes():
    """Scalar writes after track_rows note one flag a row: a hot key
    updated many times leaves one noted row and notes no larger than the
    table."""
    t = tc.NumpyCLHT(16, overflow_buckets=8)
    t.track_rows()
    for v in range(5000):
        t.insert(7, v)
    t.insert(9, 1)
    t.delete(9)
    assert t.noted_rows().tolist() == sorted({t._bucket(7), t._bucket(9)})
    assert t._noted.size == t.nxt.size


# --------------------------------- mergeplane: TestPlannedMergeEquivalence
def pool_pair(nb, cap, vectorized, n_load=60, indirect=(3, 11)):
    tw = Twin(num_buckets=nb, segment_capacity=cap, vectorized=vectorized)
    for kn in ("kn1", "kn2"):
        tw.call("register_kn", kn)
    tw.call("bulk_load", [(k, f"v{k}", 64) for k in range(n_load)])
    for k in indirect:
        tw.call("install_indirect", k)
    return tw


def drive_pools(tw, rng, n_ops, *, tombstone_frac, allowance, budget_frac,
                key_space=90):
    """tests/test_mergeplane.py:drive_pools on twins: random writes and
    tombstones, budgeted merges under random allowances; the states and
    the batched reads compared at every merge."""
    total = 0
    for i in range(n_ops):
        kn = "kn1" if rng.random() < 0.6 else "kn2"
        k = int(rng.integers(0, key_space))
        if rng.random() < tombstone_frac:
            tw.call("log_write", kn, -k - 1, None, 0, check=False)
        else:
            tw.call("log_write", kn, k, f"w{i}", 64, check=False)
        if rng.random() < budget_frac:
            if allowance is not None and rng.random() < 0.4:
                al = int(rng.integers(1, allowance))
                tw.ref.merge_allowance = tw.port.merge_allowance = al
            budget = int(rng.integers(1, 3 * tw.ref.segment_capacity))
            total += tw.call("merge_budget", budget)
            tw.ref.merge_allowance = tw.port.merge_allowance = None
            tw.check_reads(read_keys(key_space))
    return total


@pytest.mark.parametrize("vectorized", [True, False])
@given(seed=st.integers(0, 10**6), cap=st.integers(3, 40))
@settings(max_examples=12, deadline=None)
def test_merge_interleavings(vectorized, seed, cap):
    """TestPlannedMergeEquivalence.test_adversarial_interleavings: a
    tiny contested table, tombstone-dense writes, random budgets and
    mid-plan allowance exhaustion, tiny segments."""
    rng = np.random.default_rng(seed)
    tw = pool_pair(1 << 5, cap, vectorized)
    drive_pools(tw, rng, int(rng.integers(40, 200)), tombstone_frac=0.15,
                allowance=2 * cap, budget_frac=0.2)
    tw.call("merge_all", "kn1")
    tw.call("merge_all")
    tw.check_reads(read_keys(90))
    # replicated keys written without a CAS leave dead slots: the same
    # report on both
    tw.call("verify_integrity")


@given(st.integers(0, 10**6))
@settings(max_examples=8, deadline=None)
def test_overflow_exhaustion(seed):
    """TestPlannedMergeEquivalence.test_overflow_exhaustion: 4 primary
    buckets and a minimal overflow region; inserts fail alike."""
    rng = np.random.default_rng(seed)
    tw = Twin(num_buckets=4, segment_capacity=16)
    for kn in ("kn1", "kn2"):
        tw.call("register_kn", kn)
    drive_pools(tw, rng, 120, tombstone_frac=0.05, allowance=None,
                budget_frac=0.25, key_space=400)
    tw.call("merge_all")
    tw.check_reads(read_keys(400))


def test_coverage_on_benign_config():
    """TestPlannedMergeEquivalence.test_coverage_on_benign_config: the
    planned path covers >= 95 % of the merged entries, on both."""
    tw = Twin(num_buckets=1 << 17, segment_capacity=512)
    tw.call("register_kn", "kn1")
    rng = np.random.default_rng(0)
    keys = (rng.zipf(1.5, 12000) % 100000).astype(np.int64)
    stats = []
    for mod in (jt, tt):
        mod.reset_merge_plan_stats()
    for i, k in enumerate(keys.tolist()):
        tw.call("log_write", "kn1", k, f"w{i}", 64, check=False)
        if i % 997 == 0:
            tw.call("merge_budget", 512, check=False)
    tw.call("merge_all")
    for mod in (jt, tt):
        stats.append(dict(mod.MERGE_PLAN_STATS))
    assert stats[0] == stats[1]
    tot = stats[1]["planned_entries"] + stats[1]["replayed_entries"]
    assert tot >= 12000
    assert stats[1]["planned_entries"] / tot >= 0.95
    tw.check_reads(np.unique(keys))


@pytest.mark.parametrize("vectorized", [False, True])
def test_truncated_plan_never_double_charges(vectorized):
    tw = Twin(num_buckets=4, segment_capacity=32, vectorized=vectorized)
    tw.call("register_kn", "kn1")
    for i in range(300):
        tw.call("log_write", "kn1", i % 60, f"w{i}", 64, check=False)
    tw.ref.merge_allowance = tw.port.merge_allowance = 45
    g0 = tw.port.gc.entries_merged
    assert tw.call("merge_budget", 10**6) == 45
    assert tw.port.merge_allowance == 0
    assert tw.port.gc.entries_merged - g0 == 45
    assert tw.call("merge_budget", 10**6) == 0
    tw.check_reads(read_keys(60))


def test_allowance_exhaustion_mid_plan():
    tw = pool_pair(1 << 12, 256, True, n_load=0, indirect=())
    rng = np.random.default_rng(7)
    for i in range(256):
        tw.call("log_write", "kn1", int(rng.integers(0, 4000)), f"w{i}", 64,
                check=False)
    for mod in (jt, tt):
        mod.reset_merge_plan_stats()
    tw.ref.merge_allowance = tw.port.merge_allowance = 100
    assert tw.call("merge_budget", 10**6) == 100
    assert tt.MERGE_PLAN_STATS == jt.MERGE_PLAN_STATS
    assert tt.MERGE_PLAN_STATS["planned_entries"] == 100
    assert tt.MERGE_PLAN_STATS["replayed_entries"] == 0
    tw.check_reads(read_keys(4000))


# ------------------------------------- fencing (tests/test_fencing.py)
KN = "a"
ENTRY_POINTS = ("log_write", "log_write_batch", "fill_segments_batch",
                "merge_entries_batch", "apply_merge_plan", "cas_indirect",
                "recover_kn")


def fenced_twin(seed_keys=(1, 2, 3), gen=1):
    """tests/test_fencing.py:make_pool on twins."""
    tw = Twin(num_buckets=1 << 10, segment_capacity=8)
    tw.call("register_kn", KN)
    tw.call("publish_fences", {KN: gen})
    tok = tw.port.fence_token(KN)
    for i, k in enumerate(seed_keys):
        tw.call("log_write", KN, k, f"v{k}", 8, req_id=100 + i, token=tok)
    return tw


def stale_op(tw, name, stale, keys):
    """tests/test_fencing.py:stage_stale_op on twins: set-up now (on
    both), the stale mutation as the returned call."""
    if name == "log_write":
        return lambda: tw.call("log_write", KN, keys[0], "z", 8, req_id=999,
                               token=stale)
    if name == "log_write_batch":
        return lambda: tw.call("log_write_batch", KN, keys,
                               [f"z{k}" for k in keys], [8] * len(keys),
                               token=stale)
    if name == "fill_segments_batch":
        bases = tw.each(lambda p: p.alloc_values_batch(
            [f"z{k}" for k in keys], [8] * len(keys)))
        assert bases[0] == bases[1]
        ptrs = list(range(bases[0], bases[0] + len(keys)))
        return lambda: tw.call("fill_segments_batch", KN, keys, ptrs,
                               token=stale)
    if name == "merge_entries_batch":
        def run():
            out = tw.each(lambda p: canon(p.merge_entries_batch(
                list(p.active_segment(KN).entries), p.active_segment(KN),
                token=stale)))
            assert out[0] == out[1]
            tw.check()
            return out[1]
        return run
    if name == "apply_merge_plan":
        return lambda: tw.call("apply_merge_plan", None, token=stale, kn=KN)
    if name == "cas_indirect":
        return lambda: tw.call("cas_indirect", keys[0], None, 0, kn=KN,
                               token=stale)
    assert name == "recover_kn"
    return lambda: tw.call("recover_kn", KN, token=stale)


@given(name=st.sampled_from(ENTRY_POINTS),
       keys=st.lists(st.integers(0, 500), min_size=1, max_size=6),
       bumps=st.integers(1, 4))
@settings(max_examples=40, deadline=None)
def test_stale_write_is_a_pure_no_op(name, keys, bumps):
    """TestStaleWriteIsPureNoOp.test_state_bit_identical on twins."""
    keys = list(dict.fromkeys(keys))
    tw = fenced_twin(seed_keys=keys)
    stale = tw.port.fence_token(KN)
    tw.call("publish_fences", {KN: stale + bumps})
    op = stale_op(tw, name, stale, keys)
    before = state(tw.port, fenced=False)
    n0 = len(tw.port.fenced_writes)
    r = op()
    assert r[0] == "fenced" and r[2] == name and r[3] == stale
    assert state(tw.port, fenced=False) == before
    assert len(tw.port.fenced_writes) == n0 + 1
    assert tw.call("verify_integrity") == ("list", [])
    tw.check_reads(read_keys(501))


@given(name=st.sampled_from(ENTRY_POINTS),
       raw=st.lists(st.integers(0, 500), min_size=1, max_size=6))
@settings(max_examples=25, deadline=None)
def test_stale_write_leaves_nothing_for_recovery(name, raw):
    """TestStaleWriteIsPureNoOp.test_identical_across_crash_and_recovery:
    the fenced twin and an untouched twin stay equal after the same
    tear and recovery."""
    keys = list(dict.fromkeys(raw))
    hit, clean = fenced_twin(seed_keys=keys), fenced_twin(seed_keys=keys)
    stale = hit.port.fence_token(KN)
    for tw in (hit, clean):
        tw.call("publish_fences", {KN: stale + 1})
    ops = [stale_op(tw, name, stale, keys) for tw in (hit, clean)]
    assert ops[0]()[0] == "fenced"
    for tw in (hit, clean):
        def tear(p):
            act = p.active_segment(KN)
            if act.entries:
                act.sealed[-1] = False
        tw.each(tear)
        tw.call("recover_kn", KN)
        assert tw.call("verify_integrity") == ("list", [])

    def comparable(p):
        segs = {kn: [(list(s.entries), list(s.sealed), list(s.reqs),
                      list(s.gens), s.valid, s.merged_upto) for s in lst]
                for kn, lst in p.segments.items()}
        return (p.index.keys.tobytes(), p.index.ptrs.tobytes(),
                list(p.heap_val), list(p.heap_len), segs,
                dict(p.req_index), dict(p.indirect),
                (p.gc.segments_created, p.gc.segments_collected,
                 p.gc.entries_merged))

    assert comparable(hit.port) == comparable(clean.port)
    hit.check_reads(read_keys(501))


def test_valid_token_still_writes():
    tw = fenced_twin()
    tok = tw.port.fence_token(KN)
    ptr = tw.call("log_write", KN, 9, "z", 8, token=tok)[1][0]
    assert tw.port.heap_val[ptr] == "z"
    assert tw.port.active_segment(KN).gens[-1] == tok


def test_fence_bypass_trips_the_port_sanitizer():
    """A KN-context mutation of fenced state without a token trips the
    port's own sanitizer, as the reference's does."""
    was = ts.enabled()
    ts.enable()
    try:
        pool = make("port", num_buckets=1 << 10, segment_capacity=8)
        pool.register_kn(KN)
        pool.publish_fences({KN: 1})
        with ts.owned(KN):
            with pytest.raises(ts.OwnershipViolation, match="fence bypass"):
                pool.log_write(KN, 4, "z", 8)
        with ts.management():
            pool.log_write(KN, 4, "z", 8)
    finally:
        if not was:
            ts.disable()


# ------------------------------- faultplane (tests/test_faultplane.py)
KNS = ("a", "b")


def owner_of(key: int) -> str:
    return KNS[key % len(KNS)]


def sealed_count(pool, kn: str) -> int:
    return sum(sum(s.sealed) for s in pool.segments.get(kn, ()))


def make_ops(rng, rounds, batch, key_space, tombstones):
    out, ver = [], 0
    for _ in range(rounds):
        ops = []
        for _ in range(batch):
            k = int(rng.integers(0, key_space))
            if tombstones and rng.random() < 0.15:
                ops.append((owner_of(k), -(k + 1), None))
            else:
                ver += 1
                ops.append((owner_of(k), k, f"v{ver}"))
        out.append(ops)
    return out


def submit_round(tw, ops) -> None:
    """tests/test_faultplane.py:submit_round on twins; a crash raises
    tf.KNCrash after both crashed alike."""
    for kn in KNS:
        mine = [(k, v) for o, k, v in ops if o == kn]
        if mine:
            tw.call("log_write_batch", kn, [k for k, _ in mine],
                    [v for _, v in mine],
                    [0 if v is None else len(v) for _, v in mine])
    tw.call("merge_budget", len(ops) // 2 + 1)


def acked_replay(acked, nb, cap):
    """The oracle of the reference's test, a port pool on the per-entry
    plane that saw only the acknowledged ops."""
    ref = make("port", num_buckets=nb, segment_capacity=cap,
               vectorized=False)
    for kn in KNS:
        ref.register_kn(kn)
    for kn, k, v in acked:
        ref.log_write(kn, k, v, 0 if v is None else len(v))
    ref.merge_all()
    return ref


def observed(pool, key):
    ptr, _ = pool.index_lookup(key)
    return None if ptr is None else pool.read_value(ptr)[0]


def crash_recover_twin(point, after, seed, tombstones, rounds=6, batch=24,
                       key_space=80, cap=16) -> bool:
    """tests/test_faultplane.py:crash_recover_check on twins: the same
    armed crash fires alike on both; after recover_kn both are equal,
    clean, equal to the replay of the acknowledged ops and linearizable;
    the batched reads agree after every round and after recovery."""
    tw = Twin(num_buckets=1 << 10, segment_capacity=cap)
    for kn in KNS:
        tw.call("register_kn", kn)
    tw.attach_faults(seed)
    rng = np.random.default_rng(seed)
    plan = make_ops(rng, rounds, batch, key_space, tombstones)
    for fp in tw.planes:
        fp.arm_crash(point, kn="a", after=after)
    submitted, crashed = [], False
    for ops in plan:
        pre = sealed_count(tw.port, "a")
        try:
            submit_round(tw, ops)
            submitted.extend(ops)
        except tf.KNCrash as e:
            crashed = True
            assert e.kn == "a" and e.point == point
            if point.startswith("log."):
                newly = sealed_count(tw.port, "a") - pre
                submitted.extend([op for op in ops if op[0] == "a"][:newly])
            else:
                submitted.extend(ops)
            break
        tw.check_reads(read_keys(key_space))
    assert tw.planes[0].crash_log == tw.planes[1].crash_log
    if not crashed:
        for fp in tw.planes:
            fp.disarm()
        assert tw.call("verify_integrity") == ("list", [])
        return False
    rec = tw.call("recover_kn", "a")
    assert rec["kn"] == "a"
    assert tw.call("verify_integrity") == ("list", [])
    tw.detach_faults()
    tw.call("merge_all")
    tw.check_reads(read_keys(key_space))
    want = acked_replay(submitted, 1 << 10, cap)
    history, t = [], 0.0
    for kn, k, v in submitted:
        real = k if k >= 0 else -k - 1
        history.append(Op("write", real, v if k >= 0 else None, t, t + 0.5))
        t += 1.0
    for key in range(key_space):
        got = observed(tw.port, key)
        assert got == observed(want, key), (point, after, seed, key)
        history.append(Op("read", key, got, t, t + 0.5))
        t += 1.0
    verdicts = check_history(history, initial=None)
    assert all(verdicts.values())
    return True


class TestArmedCrashRecovery:
    @pytest.mark.parametrize("point,after", [
        (p, a) for p in tf.LOG_MERGE_POINTS for a in (0, 1, 3)
    ] + [("log.pre_seal", 17), ("merge.mid_apply", 17)])
    def test_recovered_equals_acked_replay(self, point, after):
        fired = any(crash_recover_twin(point, after, seed, tombstones=True)
                    for seed in range(4))
        assert fired, f"{point} after={after} never fired in 4 seeds"

    def test_unfired_arm_is_harmless(self):
        assert crash_recover_twin("log.rotation", after=10_000, seed=0,
                                  tombstones=False) is False

    @given(point=st.sampled_from(tf.LOG_MERGE_POINTS),
           after=st.integers(min_value=0, max_value=40),
           seed=st.integers(min_value=0, max_value=2 ** 16),
           tombstones=st.booleans())
    @settings(max_examples=15, deadline=None)
    def test_property_crash_consistency(self, point, after, seed,
                                        tombstones):
        crash_recover_twin(point, after, seed, tombstones)


def retry_twin(point, after, seed, writes=70, key_space=24, cap=8,
               merge_every=16) -> bool:
    """tests/test_faultplane.py:retry_exactly_once_check on twins: every
    write, merge, recovery and retry (write_once) returns alike and
    leaves equal states; each request applies exactly once."""
    tw = Twin(num_buckets=1 << 9, segment_capacity=cap)
    tw.call("register_kn", "a")
    tw.attach_faults(seed)
    for fp in tw.planes:
        fp.arm_crash(point, kn="a", after=after)
    keys = np.random.default_rng(seed).integers(0, key_space,
                                                writes).tolist()
    applied, order, crashed, interrupted = {}, [], False, None
    for rid, k in enumerate(keys):
        try:
            tw.call("log_write", "a", int(k), f"v{rid}", 4, req_id=rid)
            applied[rid] = 1
            order.append(rid)
            if (rid + 1) % merge_every == 0:
                tw.call("merge_budget", merge_every // 2)
        except tf.KNCrash as e:
            assert e.point == point
            crashed = True
            if point.startswith("log."):
                interrupted = rid
            break
    if not crashed:
        return False
    tw.call("recover_kn", "a")
    tw.detach_faults()
    assert tw.call("verify_integrity") == ("list", [])
    if interrupted is not None:
        applied[interrupted] = int(tw.call("req_applied", interrupted))
        if applied[interrupted]:
            order.append(interrupted)
    for rid, k in enumerate(keys):
        acked = applied.get(rid, 0) == 1 and rid != interrupted
        if acked and rid % 3 != 0:
            continue
        r = tw.call("write_once", "a", int(k), f"v{rid}", 4, req_id=rid)
        if r[1][1]:
            applied[rid] = applied.get(rid, 0) + 1
            order.append(rid)
        else:
            assert applied.get(rid, 0) == 1, rid
    assert all(n == 1 for n in applied.values())
    tw.call("merge_all")
    tw.check_reads(read_keys(key_space))
    want = {keys[rid]: f"v{rid}" for rid in order}
    for key, v in want.items():
        assert observed(tw.port, key) == v
    return True


class TestRetryIdempotency:
    @pytest.mark.parametrize("point", tf.LOG_MERGE_POINTS)
    def test_each_point_fires_and_holds(self, point):
        assert any(retry_twin(point, after, seed)
                   for after in (0, 1, 3) for seed in range(3))

    @given(point=st.sampled_from(tf.LOG_MERGE_POINTS),
           after=st.integers(min_value=0, max_value=60),
           seed=st.integers(min_value=0, max_value=2 ** 16))
    @settings(max_examples=15, deadline=None)
    def test_property_retry_exactly_once(self, point, after, seed):
        retry_twin(point, after, seed)


class TestArmedPostCas:
    """tests/test_faultplane.py:TestArmedPostCas on twins."""

    @staticmethod
    def _twin(seed=0):
        tw = Twin(num_buckets=1 << 8, segment_capacity=8)
        tw.call("register_kn", "a")
        tw.call("log_write", "a", 5, "v0", 2)
        tw.call("merge_all")
        tw.call("install_indirect", 5)
        tw.attach_faults(seed)
        return tw

    @staticmethod
    def _append(tw, val, length, sealed=True):
        def go(p):
            seg = p.segments["a"][-1]
            ptr = p.alloc_value(val, length, seg)
            seg.append(5, ptr, sealed=sealed)
            return ptr
        a, b = tw.each(go)
        assert a == b
        tw.check()
        return b

    @pytest.mark.parametrize("after", [0, 1, 3])
    def test_dangling_cas_detected_and_rewound(self, after):
        tw = self._twin()
        first = self._append(tw, "v_acked", 7)
        assert tw.call("cas_indirect", 5, tw.port.indirect[5], first, kn="a")
        acked, acked_val = first, "v_acked"
        for fp in tw.planes:
            fp.arm_crash("rep.post_cas", kn="a", after=after)
        for i in range(after):
            new = self._append(tw, f"v{i + 1}", 4)
            assert tw.call("cas_indirect", 5, tw.port.indirect[5], new,
                           kn="a")
            acked, acked_val = new, f"v{i + 1}"
        dangling = tw.each(lambda p: p.alloc_value(
            "v_dangling", 10, p.segments["a"][-1]))[1]
        with pytest.raises(tf.KNCrash) as ei:
            tw.call("cas_indirect", 5, tw.port.indirect[5], dangling, kn="a")
        assert ei.value.point == "rep.post_cas"
        assert tw.port.indirect[5] == dangling
        report = tw.call("verify_integrity")[1]
        assert any("unsealed target" in v for v in report)
        out = tw.call("recover_kn", "a")
        tw.detach_faults()
        assert tw.call("verify_integrity") == ("list", [])
        assert out["repaired_indirect"] >= 1
        assert tw.port.indirect[5] == acked
        assert observed(tw.port, 5) == acked_val
        tw.check_reads(read_keys(8))

    def test_sealed_target_cas_is_durable(self):
        tw = self._twin()
        for fp in tw.planes:
            fp.arm_crash("rep.post_cas", kn="a", after=0)
        new = self._append(tw, "v1", 2)
        with pytest.raises(tf.KNCrash):
            tw.call("cas_indirect", 5, tw.port.indirect[5], new, kn="a")
        tw.call("recover_kn", "a")
        tw.detach_faults()
        assert tw.call("verify_integrity") == ("list", [])
        assert tw.port.indirect[5] == new
        tw.call("merge_all")
        assert observed(tw.port, 5) == "v1"
        tw.check_reads(read_keys(8))

    def test_unarmed_cas_never_fires(self):
        tw = self._twin()
        for fp in tw.planes:
            fp.arm_crash("rep.post_cas", kn="a", after=0)
        new = self._append(tw, "v1", 2)
        assert tw.call("cas_indirect", 5, tw.port.indirect[5], new)
        for fp in tw.planes:
            fp.disarm()
        assert tw.call("verify_integrity") == ("list", [])


class TestForcedCrashes:
    """tests/test_faultplane.py:TestForcedCrashes on twins."""

    @staticmethod
    def _loaded(seed=0):
        tw = Twin(num_buckets=1 << 10, segment_capacity=16)
        for kn in KNS:
            tw.call("register_kn", kn)
        rng = np.random.default_rng(seed)
        for ops in make_ops(rng, 5, 24, 80, tombstones=True):
            submit_round(tw, ops)
        return tw

    @pytest.mark.parametrize("point", [p.value for p in tf.CRASH_POINTS])
    def test_force_then_recover(self, point):
        tw = self._loaded()
        if point == "rep.post_cas":
            tw.call("log_write", "a", 998, "v_first", 7)
            tw.call("merge_all")
            tw.call("install_indirect", 998)
            old = tw.port.indirect[998]

            def go(p):
                seg = p.segments["a"][-1]
                new = p.alloc_value("v_acked", 7, seg)
                seg.append(998, new, sealed=True)
                return new
            new = tw.each(go)[1]
            assert tw.call("cas_indirect", 998, old, new)
        else:
            keys = [2 * i for i in range(50)]
            tw.call("log_write_batch", "a", keys, [f"r{k}" for k in keys],
                    [2] * len(keys))
        recs = [fp.force_crash(p, "a", point) for fp, p in
                zip((jf.FaultPlane(seed=1), tf.FaultPlane(seed=1)),
                    (tw.ref, tw.port))]
        assert recs[0] == recs[1]
        assert recs[1]["forced"] and recs[1]["effect"] != "none"
        tw.check()
        out = tw.call("recover_kn", "a")
        assert tw.call("verify_integrity") == ("list", [])
        if point == "rep.post_cas":
            assert out["repaired_indirect"] >= 1
        tw.check_reads(read_keys(1000))

    def test_unknown_point_rejected(self):
        with pytest.raises(ValueError):
            tf.FaultPlane().force_crash(make("port"), "a", "log.bogus")


class TestTornTailSemantics:
    """PySegment.recover_torn == the tensor plane's recover_segment, and
    the port's PySegment == the reference's."""

    @given(n=st.integers(min_value=0, max_value=30),
           cut=st.integers(min_value=0, max_value=30),
           merged=st.integers(min_value=0, max_value=30),
           seed=st.integers(min_value=0, max_value=999))
    @settings(max_examples=40, deadline=None)
    def test_planes_agree(self, n, cut, merged, seed):
        cap = 32
        rng = np.random.default_rng(seed)
        keys = rng.integers(0, 50, n)
        merged, cut = min(merged, n), min(cut, n)
        segs = []
        for cls in (jl.PySegment, tl.PySegment):
            py = cls(cap, "a")
            for k, p in zip(keys.tolist(), range(n)):
                py.append(int(k), int(p), req=p)
            for i in range(cut, n):
                py.sealed[i] = False
            py.merged_upto = merged
            segs.append((py, py.sealed_entries(), py.recover_torn()))
        (a, sa, da), (b, sb, db) = segs
        assert sa == sb and da == db
        assert (a.entries, a.sealed, a.reqs, a.gens, a.valid,
                a.merged_upto) == (b.entries, b.sealed, b.reqs, b.gens,
                                   b.valid, b.merged_upto)
        seg = tl.segment_init(cap, device="cpu")
        tl.log_append(seg, torch.from_numpy(keys.astype(np.int32)),
                      torch.arange(n, dtype=torch.int32))
        seg.seal[cut:n] = tl.TORN
        seg.merged = merged
        tl.recover_segment(seg)
        assert len(b.entries) == seg.count
        assert b.merged_upto == seg.merged
        assert [k for k, _ in b.entries] == seg.keys[:seg.count].tolist()
        assert len(db) == n - cut


# ------------------------------------------------- the card copy's guard
def test_int32_guard_raises_and_does_not_fall_back():
    """A key or pointer outside int32 (other than the empty mark) raises
    at the upload to the card copy, and keeps raising (its row stays
    noted), rather than reading the host index instead."""
    pool = make("port", num_buckets=16, segment_capacity=8)
    pool.register_kn("a")
    for k in range(6):
        pool.log_write("a", k, f"v{k}", 4)
    pool.merge_all()
    pool.index_lookup_batch(np.arange(8))          # first, full upload
    pool.index.insert(2**31, 7)                    # a key past int32
    for _ in range(2):
        with pytest.raises(ValueError, match="int32"):
            pool.index_lookup_batch(np.arange(8))
    pool.index.delete(2**31)
    pool.index_lookup_batch(np.arange(8))
    mirror_equals_host(pool)
    pool.index.insert(3, 2**31)                    # a pointer past int32
    with pytest.raises(ValueError, match="int32"):
        pool.index_lookup_batch(np.arange(8))
    fresh = make("port", num_buckets=16, segment_capacity=8)
    fresh.index.insert(5, -2**31 - 1)              # at the first upload
    with pytest.raises(ValueError, match="int32"):
        fresh.index_lookup_batch(np.arange(4))
    assert fresh.index_dev is None
    fresh.index.insert(5, 9)
    with pytest.raises(ValueError, match="int32"):  # a read key past int32
        fresh.index_lookup_batch(np.array([5, 2**31]))
    ptrs, probes = fresh.index_lookup_batch(np.array([5, -2**31]))
    assert ptrs.tolist() == [9, -1]
