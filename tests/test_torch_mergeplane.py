"""Port parity for the planned merge plane: repro_torch.core.transition.
plan_merge_window against the reference's planner, slot for slot, on
twin NumpyCLHT tables (the reference's and the port's), including the
reference's plan contract cases (tests/test_mergeplane.py:TestPlanContract);
and repro_torch.kernels.log_merge.merge_segment_planned (the host plan
applied to the slice-1 table as bulk scatters, its chain-growth tail
through clht_insert) against the JAX merge_segment_planned and the
port's merge_segment_fast at the shapes of tests/test_kernels.py.
Exact comparisons (integers); the port runs its plain versions on the
CPU."""

import dataclasses

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import clht as jc  # noqa: E402
from repro.core import log as jl  # noqa: E402
from repro.core import transition as jt  # noqa: E402
from repro.kernels.log_merge import ops as jops  # noqa: E402
from repro_torch import state  # noqa: E402
from repro_torch.core import clht as tc  # noqa: E402
from repro_torch.core import log as tl  # noqa: E402
from repro_torch.core import transition as tt  # noqa: E402
from repro_torch.kernels import log_merge as tm  # noqa: E402

PLAN_FIELDS = ("ops", "old", "n_index", "n_new", "upd_rows", "upd_slots",
               "upd_ptrs", "new_rows", "new_slots", "new_keys", "new_ptrs",
               "inv_ptrs", "live_keys")


def twin_tables(nb, overflow=None, inserts=()):
    a, b = jc.NumpyCLHT(nb, overflow), tc.NumpyCLHT(nb, overflow)
    for k, p in inserts:
        assert a.insert(k, p) == b.insert(k, p)
    return a, b


def plans(a, b, keys, ptrs, **kw):
    """The reference's and the port's plan of the same window over twin
    tables, compared field for field; returns the port's."""
    pa = jt.plan_merge_window(a, keys, ptrs, **kw)
    pb = tt.plan_merge_window(b, keys, ptrs, **kw)
    assert (pa is None) == (pb is None)
    if pa is not None:
        assert isinstance(pb, tt.MergeWindowPlan)
        for f in PLAN_FIELDS:
            np.testing.assert_array_equal(getattr(pa, f), getattr(pb, f),
                                          err_msg=f)
    return pb


def test_constants_and_hash_match_the_reference():
    assert tt.MIN_MERGE_PLAN_OPS == jt.MIN_MERGE_PLAN_OPS
    assert tt.MERGE_MAX_CHAIN == jt.MERGE_MAX_CHAIN == tc.MAX_CHAIN
    assert tt.MERGE_PLAN_STATS.keys() == jt.MERGE_PLAN_STATS.keys()
    keys = np.random.default_rng(0).integers(-2**40, 2**40, 5000)
    for nb in (4, 1 << 10, 1 << 22):
        np.testing.assert_array_equal(tt._merge_bucket_batch(keys, nb),
                                      jt._merge_bucket_batch(keys, nb))
        t = tc.NumpyCLHT(nb)
        assert [t._bucket(int(k)) for k in keys[:50]] == \
            jt._merge_bucket_batch(keys[:50], nb).tolist()
        # and the torch hash of the card's table on int32 keys
        k32 = keys.astype(np.int32)
        np.testing.assert_array_equal(
            tc.bucket_of(torch.from_numpy(k32), nb).numpy(),
            tt._merge_bucket_batch(k32, nb))


class TestPlanContract:
    """tests/test_mergeplane.py:TestPlanContract on the port's planner,
    each plan also equal to the reference's slot for slot."""

    def test_tombstone_truncates(self):
        a, b = twin_tables(1 << 6)
        keys = np.arange(40, dtype=np.int64)
        keys[17] = -5                      # tombstone mid-window
        plan = plans(a, b, keys, keys + 100)
        assert plan is not None and plan.ops == 17

    def test_small_windows_replay(self):
        a, b = twin_tables(1 << 6)
        keys = np.arange(tt.MIN_MERGE_PLAN_OPS - 1, dtype=np.int64)
        assert plans(a, b, keys, keys) is None

    def test_max_ops_clamps_the_plan(self):
        a, b = twin_tables(1 << 6)
        keys = np.arange(64, dtype=np.int64)
        plan = plans(a, b, keys, keys + 1, max_ops=20)
        assert plan is not None and plan.ops == 20

    def test_indirect_entries_filtered(self):
        a, b = twin_tables(1 << 6)
        keys = np.arange(32, dtype=np.int64)
        ind = np.array([3, 7, 11], dtype=np.int64)
        plan = plans(a, b, keys, keys + 1, indirect_keys=ind)
        assert plan.ops == 32
        assert plan.n_index == 29
        assert plan.n_new == 29
        assert (plan.old == -1).all()
        assert not np.isin(ind, plan.new_keys).any()

    def test_overflowing_bucket_truncates(self):
        t = tc.NumpyCLHT(4, overflow_buckets=64)
        ks = [k for k in range(4000) if t._bucket(k) == 0][:40]
        a, b = twin_tables(4, 64, [(k, k + 1) for k in ks[:24]])
        upd = np.asarray(ks[:10], np.int64)
        fresh = np.asarray(ks[30:32], np.int64)
        keys = np.concatenate([upd, fresh, upd])
        ptrs = np.arange(keys.size, dtype=np.int64) + 500
        plan = plans(a, b, keys, ptrs)
        assert plan is not None
        assert plan.ops == 10

    def test_within_plan_supersession(self):
        a, b = twin_tables(1 << 6, inserts=[(5, 900)])
        keys = np.array([5, 1, 5, 2, 5, 3, 6, 6, 7, 8], np.int64)
        plan = plans(a, b, keys, np.arange(10, dtype=np.int64) + 100)
        assert plan.ops == 10
        got = plan.old.tolist()
        assert got[0] == 900 and got[2] == 100 and got[4] == 102
        assert got[6] == -1 and got[7] == 106
        assert sorted(plan.inv_ptrs.tolist()) == [100, 102, 106, 900]


@given(st.integers(0, 10**6), st.integers(2, 7), st.integers(1, 200),
       st.booleans())
@settings(max_examples=40, deadline=None)
def test_plans_equal_the_reference_slot_for_slot(seed, nb_pow, n, ind):
    """Contested tiny tables, chains, tombstones, duplicates, indirect
    keys and allowances: every plan of a window, and every re-plan after
    its truncation point, equals the reference's; both tables evolve
    alike under the plans and the scalar replays between them."""
    rng = np.random.default_rng(seed)
    pre = [(int(k), int(k) + 500)
           for k in rng.integers(0, 150, int(rng.integers(0, 80)))]
    a, b = twin_tables(1 << nb_pow, inserts=pre)
    keys = rng.integers(0, 150, n).astype(np.int64)
    keys[rng.random(n) < 0.05] = -7
    ptrs = rng.integers(0, 10**6, n).astype(np.int64)
    indirect = np.unique(rng.integers(0, 150, 5)) if ind else None
    i = 0
    while i < n:
        max_ops = int(rng.integers(1, 64)) if rng.random() < 0.3 else None
        plan = plans(a, b, keys[i:], ptrs[i:], indirect_keys=indirect,
                     max_ops=max_ops)
        if plan is None:
            k = int(keys[i])
            if k < 0:
                assert a.delete(-k - 1) == b.delete(-k - 1)
            else:
                assert a.insert(k, int(ptrs[i])) == b.insert(k, int(ptrs[i]))
            i += 1
            continue
        a.apply_merge_plan(jt.plan_merge_window(
            a, keys[i:], ptrs[i:], indirect_keys=indirect, max_ops=max_ops))
        b.apply_merge_plan(plan)
        i += plan.ops
    for f in ("keys", "ptrs", "nxt"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
    assert (a.overflow_head, a.size, a.version) == \
        (b.overflow_head, b.size, b.version)


# --------------------------------------------- merge_segment_planned
def jfields(x) -> dict:
    return {f.name: np.array(getattr(x, f.name))
            for f in dataclasses.fields(x)}


@pytest.mark.parametrize("nb,n,space", [(128, 200, 30), (32, 220, 3),
                                        (512, 400, 6)])
def test_merge_segment_planned_matches_jax_and_fast(nb, n, space):
    """The shapes of tests/test_kernels.py::
    test_merge_segment_planned_matches_fast: a pre-filled table, a
    segment of n entries over nb * space keys. The port's planned merge
    equals the JAX planned merge and the port's merge_segment_fast,
    table for table and entry for entry."""
    rng = np.random.default_rng(nb + n)
    keys = rng.integers(0, nb * space, n).astype(np.int32)
    pre = rng.integers(0, nb * space, nb).astype(np.int32)
    cap = max(n + 8, 16)
    jseg, _ = jl.log_append(jl.segment_init(cap), jnp.array(keys),
                            jnp.arange(n, dtype=jnp.int32) + 5000)
    j0 = jc.clht_init(nb)
    j0, *_ = jc.clht_insert(j0, jnp.array(pre), jnp.array(pre) + 9000)
    jtab, jold, jok = jops.merge_segment_planned(j0, jseg)

    def port_state():
        t, s, _ = state.from_jax_arrays(table=jfields(j0),
                                        seg=jfields(jseg), device="cpu")
        return t, s

    t_p, s_p = port_state()
    t_p, old_p, ok_p = tm.merge_segment_planned(t_p, s_p)
    t_f, s_f = port_state()
    t_f, old_f, ok_f = tm.merge_segment_fast(t_f, s_f)
    lo, hi = int(jseg.merged), int(jseg.count)
    assert old_p.dtype == torch.int32 and ok_p.dtype == torch.bool
    np.testing.assert_array_equal(t_p.keys.numpy(), np.asarray(jtab.keys))
    np.testing.assert_array_equal(t_p.ptrs.numpy(), np.asarray(jtab.ptrs))
    np.testing.assert_array_equal(t_p.nxt.numpy(), np.asarray(jtab.nxt))
    assert int(t_p.overflow_head) == int(jtab.overflow_head)
    np.testing.assert_array_equal(old_p.numpy(), np.asarray(jold)[lo:hi])
    np.testing.assert_array_equal(ok_p.numpy(), np.asarray(jok)[lo:hi])
    assert torch.equal(t_p.lines, t_f.lines)
    assert int(t_p.overflow_head) == int(t_f.overflow_head)
    assert torch.equal(old_p, old_f) and torch.equal(ok_p, ok_f)


def test_merge_segment_planned_skips_torn_and_merged_entries():
    """Only the sealed entries of the pending window merge: an already
    merged prefix and a torn entry report old -1 and ok False, as in
    merge_segment_fast."""
    rng = np.random.default_rng(3)
    keys = rng.integers(0, 200, 120).astype(np.int32)
    outs = []
    for fn in (tm.merge_segment_planned, tm.merge_segment_fast):
        seg = tl.segment_init(128, device="cpu")
        tl.log_append(seg, torch.from_numpy(keys),
                      torch.arange(120, dtype=torch.int32))
        seg.merged = 10
        seg.seal[40] = tl.TORN
        t = tc.clht_init(32, device="cpu")
        t, old, ok = fn(t, seg)
        outs.append((t.lines.clone(), old, ok))
        assert not bool(ok[30]) and int(old[30]) == -1
    for a, b in zip(*outs):
        assert torch.equal(a, b)
