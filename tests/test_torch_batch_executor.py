"""Port parity for kernel E's function, the fused batch executor: the
port's ``fused_window`` on CPU tensors (its plain version) and its
``fused_window_ref`` against the reference's jitted ``fused_window`` and
its numpy oracle ``fused_window_ref``, on tests/test_kernels.py's chained
random windows, its truncation residual, one window for each cut reason
(tests/torch_cases.py:window_cut_case), the promote threshold table and
the state packing. Integers throughout: every comparison is exact."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels import batch_executor as jbe  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import batch_executor as tbe  # noqa: E402
import torch_cases as cases  # noqa: E402


def run_all(state, win, cap, wb, amr):
    """One window through the four: the reference's oracle and jitted
    program, the port's oracle and wrapper. Asserts they agree on n_exec,
    the cut, the whole event and out_ptr tapes and all eight state
    arrays; returns the oracle's (n_exec, state', events, out_ptr,
    cut)."""
    vmax = jbe.build_promote_table(amr)
    want = jbe.fused_window_ref(state, *win, cap, wb, vmax)
    jit = jbe.fused_window(tuple(np.array(a) for a in state), *win, cap,
                           wb, vmax)
    port_ref = tbe.fused_window_ref(tuple(a.copy() for a in state), *win,
                                    cap, wb, vmax)
    tstate = tuple(torch.from_numpy(a.copy()) for a in state)
    launches = _build.launches["fused_window"]
    port = tbe.fused_window(tstate, *(torch.from_numpy(a.copy())
                                      for a in win[:6]), win[6], cap, wb,
                            torch.from_numpy(vmax))
    assert _build.launches["fused_window"] == launches   # the plain path
    ne, cut = want[0], want[4]
    got = [(int(jit[0]), int(jit[4]), np.asarray(jit[2]),
            np.asarray(jit[3]), [np.asarray(a) for a in jit[1]]),
           (port_ref[0], port_ref[4], port_ref[2], port_ref[3],
            list(port_ref[1])),
           (int(port[0]), int(port[4]), port[2].numpy(), port[3].numpy(),
            [a.numpy() for a in port[1]])]
    for g_ne, g_cut, ev, op, st in got:
        assert (g_ne, g_cut) == (ne, cut)
        np.testing.assert_array_equal(ev[:ne], want[2][:ne])
        np.testing.assert_array_equal(op[:ne], want[3][:ne])
        for a, b in zip(want[1], st, strict=True):
            np.testing.assert_array_equal(a, b)
    # the port's two are equal on the whole tapes, and its wrapper updated
    # the state it was given in place and packed the registers
    for a, b in ((port_ref[2], got[2][2]), (port_ref[3], got[2][3])):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(want[1], tstate):
        np.testing.assert_array_equal(a, b.numpy())
    np.testing.assert_array_equal(port.packed[2:tbe.HEADER].numpy(),
                                  want[1][7])
    return want


@pytest.mark.parametrize("nslots,w,seed",
                         [(32, 64, s) for s in range(8)]
                         + [(1024, 512, s) for s in range(3)])
def test_chained_windows_match_the_reference(nslots, w, seed):
    """tests/test_kernels.py:_be_run_chain's windows (8 seeds at 32 slots,
    3 at 1024): heavy collisions, evictions, demotions and cuts, each
    window starting from the state the last one left."""
    state, wins, cap, wb, amr = cases.window_chain(seed, nslots, w, 3)
    for win in wins:
        state = run_all(state, win, cap, wb, amr)[1]


def test_chain_case_is_the_reference_tests_chain():
    """window_chain(seed, 32, 64, 3) draws what tests/test_kernels.py's
    chain draws, from the same generator."""
    rng = np.random.default_rng(4)
    cap, wb = int(rng.integers(40, 2000)), int(rng.integers(8, 200))
    amr = float(rng.choice([0.5, 1.0, 3.7, 10.0, 0.125]))
    ops = rng.integers(0, 2, 64).astype(np.int32)
    n = int(rng.integers(1, 65))
    keys = rng.integers(0, 32, 64).astype(np.int32)
    _, wins, cap2, wb2, amr2 = cases.window_chain(4, 32, 64, 3)
    assert (cap, wb, amr) == (cap2, wb2, amr2)
    assert wins[0][6] == n
    np.testing.assert_array_equal(wins[0][0], ops)
    np.testing.assert_array_equal(wins[0][1], keys)


def test_truncation_residual():
    """tests/test_kernels.py:test_batch_executor_truncation_residual: op
    10 reads a segcache-backed key, so the window stops there with the
    state of exactly the first ten ops."""
    nslots, w = 16, 64
    z = np.zeros(nslots, np.int32)
    state = jbe.init_state(z, z.copy(), z.copy(), z.copy(), z.copy(),
                           np.zeros(jbe.CNT_HIST_MAX + 1, np.int32),
                           0, 0, 0, 0, 0)
    seg0 = np.zeros(w, np.int32)
    seg0[10] = 1
    win = (np.zeros(w, np.int32), np.arange(w, dtype=np.int32) % nslots,
           np.zeros(w, np.int32), np.full(w, 500, np.int32),
           np.full(w, 100, np.int32), seg0, w)
    want = run_all(state, win, 1 << 20, 64, 1.0)
    assert (want[0], want[4]) == (10, jbe.CUT_SEGCACHE)


@pytest.mark.parametrize("name", cases.WINDOW_CUTS)
def test_each_cut_reason(name):
    """Each cut reason at the op where the machine must stop, and an
    Eq. 1 promotion (7 evictions) and refusal decided on the table."""
    state, win, cap, wb, amr = cases.window_cut_case(name)
    want = run_all(state, win, cap, wb, amr)
    cut = {"segcache": jbe.CUT_SEGCACHE, "prefetch": jbe.CUT_PREFETCH,
           "spill": jbe.CUT_SPILL, "ema": jbe.CUT_EMA,
           "table": jbe.CUT_TABLE}.get(name, jbe.CUT_NONE)
    assert want[4] == cut
    assert want[0] == (5 if cut else win[6])
    if name == "promote":
        assert want[2][5] == jbe.EV_PROMOTE
        assert want[1][7][jbe.R_EVICTIONS] == 7
    if name == "no_promote":
        assert want[2][5] == jbe.EV_SHORTCUT_HIT


@pytest.mark.parametrize("ashr", [1.0, 0.5, 3.0])
def test_promote_table_matches_the_reference(ashr):
    """build_promote_table over a grid of miss-RT averages, amr <= 0
    (every row saturated) included, and other table lengths."""
    for amr in (-1.0, 0.0, 1e-9, 0.05, 0.125, 0.3, 1.0, 1.0 / 3.0, 2.0,
                3.7, 10.0, 37.5, 1e6):
        for n in (tbe.TABLE_N, 7):
            np.testing.assert_array_equal(
                tbe.build_promote_table(amr, ashr, n),
                jbe.build_promote_table(amr, ashr, n))


def test_init_state_and_constants_match_the_reference():
    g = np.random.default_rng(0)
    arrs = [g.integers(0, 1000, 64) for _ in range(5)]
    hist = g.integers(0, 9, jbe.CNT_HIST_MAX + 1)
    args = (*arrs, hist, 1000, 77, 3, 4, 5)
    for a, b in zip(jbe.init_state(*args), tbe.init_state(*args),
                    strict=True):
        assert a.dtype == b.dtype == np.int32
        np.testing.assert_array_equal(a, b)
    for name in jbe.__all__:
        if name.isupper():
            assert getattr(tbe, name) == getattr(jbe, name), name


def test_wrapper_refuses_bad_inputs():
    state = tuple(torch.from_numpy(a) for a in cases.window_state(64))
    win = [torch.zeros(8, dtype=torch.int32) for _ in range(6)]
    vmax = torch.from_numpy(tbe.build_promote_table(1.0))
    with pytest.raises(ValueError, match="power of two"):
        tbe.fused_window(tuple(torch.zeros(48, dtype=torch.int32)
                               for _ in range(6)) + state[6:], *win, 8,
                         4096, 64, vmax)
    with pytest.raises(ValueError, match="outside"):
        tbe.fused_window(state, *win, 9, 4096, 64, vmax)
    with pytest.raises(ValueError, match="window arrays"):
        tbe.fused_window(state, *win[:5], torch.zeros(7, dtype=torch.int32),
                         4, 4096, 64, vmax)
    with pytest.raises(ValueError, match="int32"):
        tbe.fused_window(state, *win, 8, 2**31, 64, vmax)
    assert tbe.build_trees(state) is None       # the plain version scans


def four_kn_jobs(seed):
    """Four KNs' windows (32, 1,024, 1,024 slots full of victims, 64
    slots): numpy jobs (state, window, n, cap, write_bytes, vmax)."""
    cases_ = [cases.window_chain(seed, 32, 64, 1),
              cases.window_chain(seed + 1, 1024, 512, 1),
              cases.window_victims_case(seed, 1 << 10, 256, 1),
              cases.window_chain(seed + 2, 64, 64, 1)]
    return [(tuple(a.copy() for a in state), wins[0][:6], wins[0][6], cap,
             wb, tbe.build_promote_table(amr))
            for state, wins, cap, wb, amr in cases_]


@pytest.mark.parametrize("seed", range(4))
def test_fused_windows_is_fused_window_per_kn(seed):
    """fused_windows_ref over four KNs' windows equals fused_window_ref
    on each; the port's fused_windows on CPU tensors (one call, four
    jobs, each with a dirty record) equals both, each job's record
    holding exactly the slots that changed, once each, and its packed
    tail their count."""
    jobs = four_kn_jobs(seed)
    wants = [tbe.fused_window_ref(tuple(a.copy() for a in st), *win, n,
                                  cap, wb, vmax)
             for st, win, n, cap, wb, vmax in jobs]
    got = tbe.fused_windows_ref([(tuple(a.copy() for a in st), *rest)
                                 for st, *rest in jobs])
    tjobs = [tbe.WindowJob(tuple(torch.from_numpy(a.copy()) for a in st),
                           tuple(torch.from_numpy(a) for a in win), n, cap,
                           wb, torch.from_numpy(vmax), None,
                           tbe.new_dirty(st[0].size, "cpu"))
             for st, win, n, cap, wb, vmax in jobs]
    launches = _build.launches["fused_window"]
    outs = tbe.fused_windows(tjobs)
    assert _build.launches["fused_window"] == launches   # the plain path
    for job, out, g, want, (st, *_) in zip(tjobs, outs, got, wants, jobs,
                                           strict=True):
        ne = want[0]
        for a in (g, (int(out[0]), [t.numpy() for t in out[1]],
                      out[2].numpy(), out[3].numpy(), int(out[4]))):
            assert (a[0], a[4]) == (ne, want[4])
            np.testing.assert_array_equal(a[2], want[2])
            np.testing.assert_array_equal(a[3], want[3])
            for x, y in zip(a[1], want[1], strict=True):
                np.testing.assert_array_equal(x, y)
        slots = tbe.dirty_slots_ref(st, want[1])
        d = job.dirty.numpy()
        words = (st[0].size + 31) // 32
        assert int(out.packed[-1]) == int(d[0]) == slots.size
        np.testing.assert_array_equal(
            np.sort(d[1 + words:1 + words + slots.size]), slots)
        bits = d[1:1 + words].view(np.uint32)
        assert sum(bin(int(b)).count("1") for b in bits) == slots.size


@pytest.mark.parametrize("seed", range(3))
def test_moved_slot_plain_versions(seed):
    """The moved-slot functions on CPU tensors: gather_dirty after a
    window returns the changed slots' fields, the histogram and the
    registers, empties the record and clears the slots' wrote flags;
    scatter_slots of that buffer into the state as it was before the
    window gives the state after it (wrote aside); guard_maxima is the
    masked maxima over the first nslots, -2^31 where none is live."""
    st, win, n, cap, wb, vmax = four_kn_jobs(seed)[2]
    before = tuple(torch.from_numpy(a.copy()) for a in st)
    after = tuple(torch.from_numpy(a.copy()) for a in st)
    dirty = tbe.new_dirty(st[0].size, "cpu")
    out = tbe.fused_windows([tbe.WindowJob(
        after, tuple(torch.from_numpy(a) for a in win), n, cap, wb,
        torch.from_numpy(vmax), None, dirty)])[0]
    m = int(out.packed[-1])
    assert m > 0
    wrote = after[5].numpy().copy()
    rec = tbe.gather_dirty(after, dirty, m)
    assert rec.shape == (tbe.META + (1 + tbe.FIELDS) * m,)
    words = (st[0].size + 31) // 32
    assert int(dirty[0]) == 0 and not dirty[1:1 + words].any()
    keys = rec[tbe.META:tbe.META + m].numpy()
    assert not after[5].numpy()[keys].any() and wrote.any()
    tbe.scatter_slots(before, None, rec)
    for j in (0, 1, 2, 3, 4, 6, 7):
        np.testing.assert_array_equal(before[j].numpy(), after[j].numpy())
    g = np.random.default_rng(seed)
    kind = g.integers(0, 3, 1000).astype(np.int32)
    vals = [g.integers(-9, 2**31 - 1, 1000).astype(np.int32)
            for _ in range(3)]
    for nslots in (0, 1, 500, 1000):
        live = kind[:nslots] != 0
        want = [int(v[:nslots][live].max()) if live.any() else -2**31
                for v in vals]
        state = tuple(torch.from_numpy(a) for a in (
            kind, vals[0], kind, vals[2], vals[1], kind))
        state = state + (torch.zeros(65, dtype=torch.int32),
                         torch.zeros(8, dtype=torch.int32))
        state = tuple(torch.cat([t, t[:24]]) if t.shape == (1000,) else t
                      for t in state)
        assert tbe.guard_maxima(state, nslots).tolist() == want
