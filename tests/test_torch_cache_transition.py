"""Port parity for kernel 4, the cache_transition space machine: the
port's wrapper on the CPU (its torch loop), ``cache_transition_ref`` and
``cache_transition_np`` against the JAX kernel (interpret mode, as
tests/test_kernels.py runs it), the JAX scan oracle and the JAX numpy
oracle, on test_kernels.py's cases, a floor-division edge and a victim
queue run dry. Integers: exact equality. Also the window encoding, and
the gather against the planner's own pass-B vectors."""

import copy

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels import cache_transition as jct  # noqa: E402
from repro_torch.core import cluster as tcl  # noqa: E402
from repro_torch.core import dac as tdac  # noqa: E402
from repro_torch.core import transition as ttr  # noqa: E402
from repro_torch.kernels import cache_transition as tct  # noqa: E402


def sweep_case(n, block, cap_base, seed):
    """tests/test_kernels.py::test_cache_transition_matches_oracles."""
    rng = np.random.default_rng(seed)
    cap = cap_base + int(rng.integers(0, 2048))
    opk = rng.choice([0, 0, 0, 1, 1, 2], n).astype(np.int64)
    kd = rng.choice([0, 1, 2], n).astype(np.int64)
    pc = rng.choice([0, 0, 1, 5], n).astype(np.int64)
    plen = rng.choice([64, 128, 256], n).astype(np.int64)
    vic = rng.choice([104, 168, 296], 200).astype(np.int64)
    used0 = int(rng.integers(0, cap))
    z0 = int(rng.integers(0, 50))
    return (opk, kd, pc, plen, 128), vic, used0, z0, cap, block


def pressure_case():
    """tests/test_kernels.py::test_cache_transition_victim_pressure."""
    n = 256
    window = (np.zeros(n, np.int64), np.ones(n, np.int64),
              np.ones(n, np.int64), np.full(n, 1024, np.int64), 1024)
    cap = 1 << 16
    return window, np.full(300, 1064, np.int64), cap - 100, 500, cap, 256


def floor_div_case():
    """Shortcut reads (promotes) whose Eq. 1 deficit free - need is
    negative and not a multiple of 32 (-100 .. -130), with the zero
    count at the truncated quotient (3): floor division refuses every
    one, truncation would take most."""
    n = 256
    plen = 192 + np.arange(n) % 31                  # need 200 .. 230
    window = (np.zeros(n, np.int64), np.ones(n, np.int64),
              np.ones(n, np.int64), plen.astype(np.int64), 128)
    cap = 1 << 16
    return window, np.full(64, 1064, np.int64), cap - 100, 3, cap, 256


def dry_case():
    """Fresh writes into a full cache with a three-entry victim queue:
    make-space runs the queue dry and occupancy passes cap."""
    n = 256
    window = (np.ones(n, np.int64), np.zeros(n, np.int64),
              np.zeros(n, np.int64), np.zeros(n, np.int64), 1024)
    cap = 1 << 15
    return window, np.full(3, 1064, np.int64), cap - 10, 0, cap, 256


CASES = {
    "sweep0": lambda: sweep_case(256, 256, 4096, 0),
    "sweep1": lambda: sweep_case(512, 128, 8192, 1),
    "sweep2": lambda: sweep_case(256, 64, 2048, 2),
    "pressure": pressure_case,
    "floor_div": floor_div_case,
    "dry": dry_case,
}


@pytest.mark.parametrize("name", list(CASES))
def test_port_matches_the_jax_kernel_and_oracles(name):
    (opk, kd, pc, plen, vb), vic, used0, z0, cap, block = CASES[name]()
    rows = jct.encode_window(opk, kd, pc, plen, value_bytes=vb, block=block)
    want = [np.asarray(x) for x in jct.cache_transition(
        rows, vic, used0, z0, cap=cap, block=block, interpret=True)]
    oracles = [jct.cache_transition_ref(rows, vic, used0, z0, cap=cap),
               jct.cache_transition_np(np.asarray(rows), vic, used0, z0,
                                       cap=cap)]
    rt, vt = torch.from_numpy(np.asarray(rows)), torch.from_numpy(vic)
    got = [tct.cache_transition(rt, vt.to(torch.int32), used0, z0, cap=cap,
                                block=block),
           tct.cache_transition_ref(rt, vt, used0, z0, cap=cap),
           tct.cache_transition_np(np.asarray(rows), vic, used0, z0,
                                   cap=cap)]
    for outs in oracles + got:
        for w, g in zip(want, outs):
            g = g.numpy() if isinstance(g, torch.Tensor) else np.asarray(g)
            np.testing.assert_array_equal(g, w)
            assert g.dtype == np.int32


def test_the_edges_are_hit():
    """The floor-division case refuses every promote and the dry case
    runs the queue out; the pressure case consumes victims."""
    for name, check in (
            ("floor_div", lambda d, t, u, cap: not d.any()),
            ("dry", lambda d, t, u, cap: t[-1] == 3 and u.max() > cap),
            ("pressure", lambda d, t, u, cap: d.all() and t[-1] > 0)):
        (opk, kd, pc, plen, vb), vic, used0, z0, cap, block = CASES[name]()
        rows = tct.encode_window(opk, kd, pc, plen, value_bytes=vb)
        assert check(*tct.cache_transition_np(rows, vic, used0, z0, cap=cap),
                     cap), name


def test_truncating_division_would_differ():
    """The floor-division case separates floor from truncation: with
    int() division the same rows promote."""
    (opk, kd, pc, plen, vb), _, used0, z0, cap, _ = floor_div_case()
    need = plen + 40 - 32
    free = cap - used0
    trunc = -int((free - need[0]) / 32)
    assert z0 >= trunc and z0 < -((free - need[0]) // 32)


@pytest.mark.parametrize("name", list(CASES))
def test_encode_window_matches_the_reference(name):
    (opk, kd, pc, plen, vb), _, _, _, _, block = CASES[name]()
    np.testing.assert_array_equal(
        tct.encode_window(opk, kd, pc, plen, value_bytes=vb, block=block),
        jct.encode_window(opk, kd, pc, plen, value_bytes=vb, block=block))


def test_plan_window_transitions_matches_the_reference():
    (opk, kd, pc, plen, vb), vic, used0, z0, cap, _ = sweep_case(300, 256,
                                                                 4096, 5)
    want = jct.plan_window_transitions(opk, kd, pc, plen, vic, used0, z0,
                                       cap=cap, value_bytes=vb,
                                       interpret=True)
    got = tct.plan_window_transitions(opk, kd, pc, plen, vic, used0, z0,
                                      cap=cap, value_bytes=vb, device="cpu")
    for w, g in zip(want, got):
        assert g.shape == (300,)
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_the_wrapper_refuses_what_int32_cannot_hold():
    (opk, kd, pc, plen, vb), vic, used0, z0, _, _ = sweep_case(256, 256,
                                                               4096, 0)
    rows = torch.from_numpy(tct.encode_window(opk, kd, pc, plen,
                                              value_bytes=vb))
    with pytest.raises(OverflowError):
        tct.cache_transition(rows, torch.from_numpy(vic.astype(np.int32)),
                             used0, z0, cap=2**31 - 64)
    with pytest.raises(AssertionError):
        tct.cache_transition(rows[:100], torch.from_numpy(vic), used0, z0,
                             cap=4096)


# ------------------------------------------------------------- the gather
class _Pool:
    """A DPM pool as the planner reads it: every key of the index at
    pointer key + 7, 100-byte values, one probe."""
    heap_len = {}

    def index_lookup(self, key):
        return key + 7, 1


def _warm_cache(seed, cap):
    rng = np.random.default_rng(seed)
    cache = tdac.ArrayDAC(cap, initial_keys=512)
    for i in range(1500):
        k = int(rng.zipf(1.3)) % 400
        if rng.random() < 0.6:
            if cache.lookup(k) is None:
                cache.fill_after_miss(k, k + 7, 100)
        else:
            cache.fill_after_write(k, i, 100, segment_cached=True)
    return cache, rng


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_gather_feeds_the_planners_own_pass_b_vectors(seed):
    """gather_window's rows are encode_window over prior_state's kind /
    count / length, its queue the cache's value entries by ascending
    stamp with their gross bytes, and its scalars the cache's."""
    cache, rng = _warm_cache(seed, 1 << 14)
    kn = tcl.KVSNode("kn1", 1 << 14, 64)
    kn.cache = cache
    pool = _Pool()
    pool.heap_len = {k + 7: 100 for k in range(400)}
    keys = rng.integers(0, 400, 300).astype(np.int64)
    opk = rng.choice([0, 0, 1, 2], 300).astype(np.uint8)
    pos = np.arange(300)
    for refills in (False, True):
        ps = ttr.prior_state(cache, kn, keys, opk, pos, {}, set(), set(),
                             pool, 100, refills)
        win = tct.gather_window(cache, kn, keys, opk, pos, {}, set(), set(),
                                pool, 100, refills)
        np.testing.assert_array_equal(
            win.rows, tct.encode_window(opk, ps.kd, ps.pc, ps.plen,
                                        value_bytes=100))
        np.testing.assert_array_equal(win.fill_miss, ps.fillm)
        vals = np.flatnonzero(cache.kind == 2)
        lru = vals[np.argsort(cache.stamp[vals])]
        nv = win.victim_keys.size
        assert 0 < nv <= lru.size
        np.testing.assert_array_equal(win.victim_keys, lru[:nv])
        np.testing.assert_array_equal(win.victims,
                                      cache.length[lru[:nv]] + 40)
        assert (win.used0, win.z0) == (cache.used, cache._zero_shortcuts)


def test_gather_queue_covers_the_worst_demand():
    """Sized to the window: every insert's make-space finds its victims
    in the queue (all value entries of a cache this small)."""
    cache = tdac.ArrayDAC(1 << 13, initial_keys=800)
    for k in range(58):           # full of 140-byte values
        cache.fill_after_miss(k, k + 7, 100)
    cache2 = copy.deepcopy(cache)
    kn = tcl.KVSNode("kn1", 1 << 13, 64)
    keys = np.arange(400, 464, dtype=np.int64)              # fresh writes
    win = tct.gather_window(cache, kn, keys, np.ones(64, np.uint8),
                            np.arange(64), {}, set(), set(), _Pool(), 100)
    assert win.victim_keys.size == int((cache.kind == 2).sum())
    _, nvic, used = tct.cache_transition_np(win.rows, win.victims,
                                            win.used0, win.z0,
                                            cap=cache.capacity)
    assert nvic[-1] > 0
    for k in keys.tolist():
        cache2.fill_after_write(k, 1, 100, segment_cached=True)
    assert used[63] == cache2.used


def test_twin_verdict_names_each_cause():
    """A disagreement is put under the first cause that explains it."""
    from types import SimpleNamespace
    (opk, kd, pc, plen, vb), vic, used0, z0, cap, _ = dry_case()
    rows = tct.encode_window(opk, kd, pc, plen, value_bytes=vb)
    keys = np.arange(100, 356, dtype=np.int64)
    dec, nvic, used = tct.cache_transition_np(rows, vic, used0, z0, cap=cap)

    def window(fill_miss=None, victim_keys=(1, 2, 3)):
        return tct.Window(rows, np.asarray(victim_keys, np.int64), vic,
                          used0, z0, np.zeros(256, bool)
                          if fill_miss is None else fill_miss)

    def plan(ops=256, used_final=None, victims=3):
        return SimpleNamespace(
            ops=ops, used_final=int(used[ops - 1]) if used_final is None
            else used_final, victims=[0] * victims, promotions=0,
            to_val=dec[:ops].astype(bool))

    ok = plan(ops=2, victims=int(nvic[1]))
    assert tct.twin_verdict(window(), ok, keys, dec, nvic, used,
                            cap) == "agree"
    off = plan(ops=2, victims=int(nvic[1]), used_final=-1)
    miss = np.zeros(256, bool)
    miss[1] = True
    assert tct.twin_verdict(window(miss), off, keys, dec, nvic, used,
                            cap) == "read_miss"
    touched = window(victim_keys=(100, 2, 3))     # key of op 0, consumed at 0
    assert tct.twin_verdict(touched, off, keys, dec, nvic, used,
                            cap) == "touched_victim"
    assert tct.twin_verdict(window(), plan(used_final=-1), keys, dec, nvic,
                            used, cap) == "queue_dry"
    assert tct.twin_verdict(window(), off, keys, dec, nvic, used,
                            cap) == "other"
