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
    pointer key + 7, 100-byte values, one probe; segments of 16 entries
    (a KN's segcache holds 4 of them)."""
    heap_len = {}
    segment_capacity = 16

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
    pool = _Pool()
    kn = tcl.KVSNode("kn1", tcl.DINOMO, 1 << 14, pool)
    kn.cache = cache
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
    kn = tcl.KVSNode("kn1", tcl.DINOMO, 1 << 13, _Pool())
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


# ------------------------------------------ kernel 4 on adversarial windows
import torch_cases as cases  # noqa: E402

SB = 32


def _decode(row):
    """A row as the kernel decodes it: (code, thr, d1, d0, zd)."""
    code, rm, vb, zhit, zfill = (int(x) for x in row[:5])
    code = code if 1 <= code <= 3 else 0
    thr = d1 = d0 = zd = 0
    if code == 1:
        thr, d1, zd = SB - vb, vb - SB, zhit
    elif code == 2:
        thr, d1, d0, zd = rm - vb, vb - rm, SB - rm, zfill
    elif code == 3:
        d1 = d0 = -rm
    return code, thr, d1, d0, zd


def _step(op, state, pre, q0, qn, more, nv):
    """One op at (uh, zz, k) with the queue's prefix sums staged from q0:
    (the change of state, dec, brk: the make-space runs past the staged
    prefix sums while more victims follow)."""
    code, thr, d1, d0, zd = op
    uh, zz, k = state
    zs = SB * zd
    z1 = zz - zs if code == 1 else zz
    w = uh - thr
    pred = w <= 0 or (code == 1 and w <= z1)
    u2 = uh + (d1 if pred else d0)
    kk = min(max(k, 0), qn)
    hi, brk = kk, False
    if u2 > 0 and q0 + kk < nv:
        target = pre[kk] + u2
        if pre[qn] < target and more:
            brk = True
        else:
            hi = next((i for i in range(kk + 1, qn + 1)
                       if pre[i] >= target), qn)
            u2 -= pre[hi] - pre[kk]
            if u2 + SB <= 0:
                u2 += SB
    zn = z1 + zs if code == 2 and not pred else z1
    return (u2 - uh, zn - zz, hi - k), pred and code in (1, 2), brk


def mirror_transition(rows, victims, used0, z0, cap, row_tile, queue_tile,
                      lanes=32):
    """numpy mirror of csrc/cache_transition.cu: rows decoded a tile at a
    time into (thr, d1, d0), u kept less the capacity, each op's test
    u - thr <= 0 (or, for a promote, u - thr <= 32 z), the queue's prefix
    sums staged ``queue_tile`` at a time from the cursor. Where they are
    nondecreasing, the warp's scan: rounds of ``lanes`` ops whose states
    are guessed as the round's state plus the changes of the ops before
    them at their guesses, again until no guess moves; a make-space past
    the staged sums stops the scan there (the queue is staged again at the
    cursor, or, from the cursor, the op is left to the wide scan). The
    wide scan: one op at a time, victims one by one past the staged sums
    or where one is negative."""
    n, nv = rows.shape[0], victims.size
    vic = victims.astype(np.int64)
    out = np.zeros((3, n), np.int64)
    uh, zz, vi = int(used0) - cap, SB * int(z0), 0      # u less cap
    wide = False
    base = start = 0
    while base < n:
        count = min(n - base, row_tile)
        ops = [_decode(r) for r in rows[base:base + count]]
        q0 = vi
        qn = min(nv - q0, queue_tile)
        pre = np.concatenate([[0], np.cumsum(vic[q0:q0 + qn])]).tolist()
        mono = not (vic[q0:q0 + qn] < 0).any()
        more = q0 + qn < nv
        j = start
        if mono and not wide:
            state = (uh, zz, 0)
            while j < count:
                m = min(lanes, count - j)
                guess = [state] * m
                while True:
                    res = [_step(ops[j + i], guess[i], pre, q0, qn, more, nv)
                           for i in range(m)]
                    new, acc = [], state
                    for i in range(m):
                        new.append(acc)
                        acc = tuple(a + b for a, b in zip(acc, res[i][0]))
                    if new == guess:
                        break
                    guess = new
                brk = [r[2] for r in res]
                c = brk.index(True) if any(brk) else m
                for i in range(c):
                    post = tuple(a + b for a, b in zip(guess[i], res[i][0]))
                    out[:, base + j + i] = (res[i][1], q0 + post[2],
                                            post[0] + cap)
                    state = post
                j += c
                if any(brk):
                    wide = state[2] == 0
                    break
            uh, zz, vi = state[0], state[1], q0 + state[2]
        else:
            wide = False
            while j < count:
                code, thr, d1, d0, zd = ops[j]
                zs = SB * zd
                z1 = zz - zs if code == 1 else zz
                w = uh - thr
                pred = w <= 0 or (code == 1 and w <= z1)
                x = uh + (d1 if pred else d0)
                if x > 0 and vi < nv:
                    k = vi - q0
                    if mono and (k > qn or (pre[qn] < pre[k] + x and more)):
                        if vi > q0:
                            break           # stage the queue from the cursor
                    elif mono:
                        hi = next((i for i in range(k + 1, qn + 1)
                                   if pre[i] >= pre[k] + x), qn)
                        x -= pre[hi] - pre[k]
                        vi = q0 + hi
                        if x + SB <= 0:
                            x += SB
                    while x > 0 and vi < nv:        # one by one
                        x -= int(vic[vi])
                        vi += 1
                        if x + SB <= 0:
                            x += SB
                uh = x
                zz = z1 + zs if code == 2 and not pred else z1
                out[:, base + j] = pred and code in (1, 2), vi, uh + cap
                j += 1
        if j == count:
            base, start = base + row_tile, 0
        else:
            start = j
    return tuple(o.astype(np.int32) for o in out)


@pytest.mark.parametrize("name", cases.TRANSITION_CASES)
def test_adversarial_windows_match_the_jax_kernel_and_oracles(name):
    """Victims <= 0, an empty queue, a queue that runs dry mid-window,
    make-spaces of tens of small victims, promotes at Eq. 1's floor: the
    port's wrapper on the CPU, its torch loop and its numpy oracle against
    the JAX oracles and the JAX kernel in interpret mode (the kernel and
    the scan oracle take no empty queue)."""
    rows, vic, used0, z0, cap = cases.transition_case(name)
    want = [np.asarray(x) for x in jct.cache_transition_np(rows, vic, used0,
                                                           z0, cap=cap)]
    oracles = []
    if vic.size:
        oracles += [jct.cache_transition_ref(rows, vic, used0, z0, cap=cap),
                    jct.cache_transition(rows, vic, used0, z0, cap=cap,
                                         interpret=True)]
    rt, vt = torch.from_numpy(rows), torch.from_numpy(vic)
    got = [tct.cache_transition(rt, vt, used0, z0, cap=cap),
           tct.cache_transition_ref(rt, vt, used0, z0, cap=cap),
           tct.cache_transition_np(rows, vic, used0, z0, cap=cap)]
    for outs in oracles + got:
        for w, g in zip(want, outs):
            g = g.numpy() if isinstance(g, torch.Tensor) else np.asarray(g)
            np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("tiles", [(1024, 2048), (64, 16), (1, 1)])
@pytest.mark.parametrize("name", [*cases.TRANSITION_CASES, "sweep0",
                                  "pressure", "floor_div", "dry"])
def test_the_kernels_searched_make_space_matches_plain(name, tiles):
    """The CUDA kernel's design, mirrored in numpy, equals the plain loop
    on every output: the searched make-space, the division-free Eq. 1,
    the restaging of the queue at the cursor (tiny tiles restage at
    almost every make-space)."""
    if name in cases.TRANSITION_CASES:
        rows, vic, used0, z0, cap = cases.transition_case(name)
    else:
        (opk, kd, pc, plen, vb), vic, used0, z0, cap, _ = CASES[name]()
        rows = tct.encode_window(opk, kd, pc, plen, value_bytes=vb)
    want = tct.cache_transition_np(rows, vic, used0, z0, cap=cap)
    got = mirror_transition(rows, vic, used0, z0, cap, *tiles)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g, w)


def test_the_edges_of_the_adversarial_windows_are_hit():
    """Each window reaches what it is named for."""
    def run(name):
        rows, vic, used0, z0, cap = cases.transition_case(name)
        return (rows, vic, cap,
                *tct.cache_transition_np(rows, vic, used0, z0, cap=cap))

    rows, vic, cap, dec, nvic, used = run("dry_mid")
    dry = np.flatnonzero(nvic == vic.size)
    assert 0 < dry[0] < rows.shape[0] // 2 and used.max() > cap
    rows, vic, cap, dec, nvic, used = run("many_small")
    assert nvic[-1] / rows.shape[0] > 20 and nvic[-1] > 2 * 2048
    rows, vic, cap, dec, nvic, used = run("victims_nonpositive")
    assert (vic[:nvic[-1]] < 0).any() and (vic[:nvic[-1]] == 0).any()
    rows, vic, cap, dec, nvic, used = run("empty_queue")
    assert used.max() > cap and not nvic.any()
    rows, vic, cap, dec, nvic, used = run("long_make_space")
    assert np.diff(np.r_[0, nvic]).max() > 2048        # past a staged tile
    rows, vic, cap, dec, nvic, used = run("wide_values")
    assert nvic[-1] > 0 and rows[:, 2].max() >= 1 << 28
    rows, vic, cap, dec, nvic, used = run("window_8192")
    assert nvic[-1] > 2048 and dec.any() and not dec.all()
    rows, vic, cap, dec, nvic, used = run("floor_mix")
    # promotes whose deficit is positive and not a multiple of 32, both
    # taken and refused at Eq. 1's zero-count test
    free = cap - np.concatenate([[cap - 100], used[:-1]])
    deficit = rows[:, 2] - SB - free
    odd = (deficit > 0) & (deficit % SB != 0)
    assert dec[odd].any() and not dec[odd].all()


def test_both_routes_refuse_what_int32_cannot_hold():
    """The host route (plan_window_transitions, and a caller passing the
    rows' largest value size) checks the int32 guard on the host; the
    device route reads it back. Both refuse the same capacity."""
    (opk, kd, pc, plen, vb), vic, used0, z0, _, _ = sweep_case(256, 256,
                                                               4096, 0)
    rows = tct.encode_window(opk, kd, pc, plen, value_bytes=vb)
    cap = 2**31 - 64
    with pytest.raises(OverflowError):
        tct.plan_window_transitions(opk, kd, pc, plen, vic, used0, z0,
                                    cap=cap, value_bytes=vb, device="cpu")
    with pytest.raises(OverflowError):
        tct.cache_transition(torch.from_numpy(rows), torch.from_numpy(vic),
                             used0, z0, cap=cap, top=int(rows[:, 2].max()))
    with pytest.raises(OverflowError):
        tct.cache_transition(torch.from_numpy(rows), torch.from_numpy(vic),
                             used0, z0, cap=cap)
    # the kernel keeps 32 x the zero count: the starting state is int32
    for bad in ((2**31, z0), (used0, -2**31 - 1)):
        with pytest.raises(OverflowError):
            tct.cache_transition(torch.from_numpy(rows),
                                 torch.from_numpy(vic), *bad, cap=4096)
