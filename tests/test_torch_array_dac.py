"""Port parity for the KN cache: the port's ``ArrayDAC`` against the
reference's ``ArrayDAC`` and the port's per-op ``DAC`` on seeded random
op streams, as tests/test_dataplane.py::TestArrayDACEquivalence drives
them. Every vector, the lazy heaps, ``used``, the zero-shortcut count, the
count histogram and the stats must be equal."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import dac as jdac  # noqa: E402
from repro_torch.core import dac as tdac  # noqa: E402

VECTORS = ("kind", "ptr", "length", "count", "stamp")
SCALARS = ("used", "_clock", "_nvals", "_nshort", "_zero_shortcuts",
           "avg_miss_rts", "capacity")


def assert_same(ref, got):
    for name in VECTORS:
        np.testing.assert_array_equal(getattr(got, name), getattr(ref, name),
                                      err_msg=name)
    for name in SCALARS:
        assert getattr(got, name) == getattr(ref, name), name
    assert got._lru == ref._lru
    assert got._lfu == ref._lfu
    assert got._cnt_hist == ref._cnt_hist
    assert dataclasses.asdict(got.stats) == dataclasses.asdict(ref.stats)


def drive(seed, cap_pow, skew, ops=1500, keys=400):
    """The op soup of TestArrayDACEquivalence, applied to the reference
    ArrayDAC, the port's ArrayDAC and the port's DAC; checked after every
    op, and in full every 100 ops."""
    rng = np.random.default_rng(seed)
    cap = 1 << cap_pow
    ref, got, scalar = jdac.ArrayDAC(cap), tdac.ArrayDAC(cap), tdac.DAC(cap)
    for i in range(ops):
        r = rng.random()
        k = int(rng.zipf(skew)) % keys
        ln = int(rng.choice([64, 100, 256]))
        if r < 0.6:
            out = [c.lookup(k) for c in (ref, got, scalar)]
            assert out[0] == out[1] == out[2]
            if out[0] is None:
                for c in (ref, got, scalar):
                    c.note_miss_rts(2.0 + (i % 3))
                    c.fill_after_miss(k, i, ln)
        elif r < 0.85:
            sc = bool(rng.random() < 0.7)
            for c in (ref, got, scalar):
                c.fill_after_write(k, i, ln, segment_cached=sc)
        elif r < 0.9:
            for c in (ref, got, scalar):
                c.invalidate(k)
        elif r < 0.95:
            for c in (ref, got, scalar):
                c.demote_to_shortcut(k)
        else:
            for c in (ref, got, scalar):
                c.update_pointer(k, i, ln)
        assert got.used == ref.used == scalar.used
        assert got.num_values == ref.num_values == scalar.num_values
        assert got.num_shortcuts == ref.num_shortcuts == scalar.num_shortcuts
        assert dataclasses.asdict(got.stats) == dataclasses.asdict(
            scalar.stats)
        if i % 100 == 99:
            assert_same(ref, got)
    assert_same(ref, got)
    for k in range(keys):
        assert (k in got) == (k in scalar) == (k in ref)
        if k in scalar.values:
            assert got.kind[k] == tdac.ArrayDAC.KIND_VALUE
            assert scalar.values[k].count == got.count[k]
            assert scalar.values[k].ptr == got.ptr[k]
        elif k in scalar.shortcuts:
            assert got.kind[k] == tdac.ArrayDAC.KIND_SHORTCUT
            assert scalar.shortcuts[k].count == got.count[k]
    return ref, got, rng


@pytest.mark.parametrize("seed,cap_pow,skew", [
    (0, 6, 1.1), (1, 9, 1.5), (2, 12, 2.2), (3, 14, 1.3), (4, 16, 1.8),
    (5, 10, 1.2)])
def test_decision_for_decision(seed, cap_pow, skew):
    drive(seed, cap_pow, skew)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_batched_api(seed):
    """classify_batch, bulk_value_hits, counts_array, stamps_array and
    the Eq. 1 histogram sum agree with the reference on a driven cache."""
    ref, got, rng = drive(seed, 13, 1.4, ops=800)
    for c in (ref, got):
        c._ensure(399)
    qk = rng.integers(0, 400, 64).astype(np.int64)
    np.testing.assert_array_equal(got.classify_batch(qk),
                                  ref.classify_batch(qk))
    vals = np.flatnonzero(got.kind == tdac.ArrayDAC.KIND_VALUE)
    for n in (10, 40):                     # the short and the unique path
        run = rng.choice(vals, n).astype(np.int64)
        ref.bulk_value_hits(run)
        got.bulk_value_hits(run)
        assert_same(ref, got)
    np.testing.assert_array_equal(got.counts_array(), ref.counts_array())
    np.testing.assert_array_equal(got.stamps_array(), ref.stamps_array())
    for n in (1, 3, 17, 200):
        for exclude in (0, 1, 5):
            assert got._victim_sum_hist(n, exclude) == \
                ref._victim_sum_hist(n, exclude)
    # make-space and Eq. 1 on the driven state
    for k in range(400, 420):
        for c in (ref, got):
            c.fill_after_miss(k, k, 256)
        assert ref.lookup(k - 5) == got.lookup(k - 5)
    assert_same(ref, got)


def test_heap_compaction_keeps_the_live_order():
    """Refreshing every value's stamp bloats the lazy LRU heap past its
    compaction bound; both planes compact at the same op and pop the same
    victims."""
    ref, got = jdac.ArrayDAC(1 << 14), tdac.ArrayDAC(1 << 14)
    for c in (ref, got):
        for k in range(60):
            c.fill_after_miss(k, k, 100)
        for _ in range(8):
            for k in range(60):
                c.lookup(k)
        for k in range(100, 160):
            c.fill_after_miss(k, k, 256)
    assert_same(ref, got)
    assert got.stats.demotions > 0


@pytest.mark.parametrize("nv,ns", [(0, 40), (30, 0), (25, 300)])
def test_warm_load_equals_per_op_fills(nv, ns):
    """The port's bulk warm-up leaves the state the reference's per-op
    fills leave: values by fill_after_miss in order, then shortcuts by
    fill_after_write (no cached segment) in ascending key order."""
    from repro_torch.core.cluster import warm_load
    rng = np.random.default_rng(nv + ns)
    keys = rng.permutation(1000)[:nv + ns]
    vk, sk = keys[:nv], np.sort(keys[nv:])
    vp, sp = rng.integers(0, 10**6, nv), rng.integers(0, 10**6, ns)
    ref, got = jdac.ArrayDAC(1 << 15), tdac.ArrayDAC(1 << 15)
    for k, p in zip(vk.tolist(), vp.tolist()):
        ref.fill_after_miss(k, p, 256)
    for k, p in zip(sk.tolist(), sp.tolist()):
        ref.fill_after_write(k, p, 256, segment_cached=False)
    warm_load(got, vk, vp, sk, sp, 256)
    ref._ensure(999)
    got._ensure(999)
    assert_same(ref, got)
    with pytest.raises(ValueError):
        warm_load(got, vk, vp, sk, sp, 256)           # not empty any more
