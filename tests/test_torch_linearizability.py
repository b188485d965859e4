"""Port parity for the linearizability checker
(repro_torch.core.linearizability against repro.core.linearizability):
``check_history`` and ``check_key_history`` give the reference's verdicts
on seeded random histories (a few keys, overlapping intervals, stale
reads, indeterminate ``"maybe"`` ops with no response, ``"fenced"``
no-ops; the exhaustive search and the depth-first one), and on the
histories of tests/test_cluster.py's TestLinearizability and
test_replicated_writes_linearizable, built by twin clusters (the
reference's and the port's, ``device="cpu"``) whose histories are equal
too. Exact comparisons."""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import linearizability as jl  # noqa: E402
from repro_torch.core import linearizability as tl  # noqa: E402
from torch_plane_cases import Twin, plain  # noqa: E402

VALUES = ("A", "B", "C", None)


def random_history(seed: int, keys: int = 3, ops: int = 7):
    """One history as field tuples: per key up to ``ops`` ops with
    overlapping intervals; reads return a recent, a stale or an unseen
    value; some writes are indeterminate (no response) or fenced."""
    rng = np.random.default_rng(seed)
    out = []
    for k in range(keys):
        t = 0.0
        for i in range(int(rng.integers(1, ops + 1))):
            inv = t + float(rng.random())
            dur = float(rng.random()) * 2.5
            status = "ok"
            if rng.random() < 0.45:
                val = f"w{k}.{i}"
                r = float(rng.random())
                if r < 0.15:
                    status = "maybe"
                elif r < 0.3:
                    status = "fenced"
                out.append(("write", k, val, inv,
                            math.inf if status == "maybe" else inv + dur,
                            f"c{i % 3}", status))
            else:
                prev = [o[2] for o in out if o[1] == k and o[0] == "write"]
                pick = float(rng.random())
                if prev and pick < 0.6:
                    val = prev[-1]
                elif prev and pick < 0.85:
                    val = prev[int(rng.integers(0, len(prev)))]
                else:
                    val = VALUES[int(rng.integers(0, len(VALUES)))]
                out.append(("read", k, val, inv, inv + dur, f"c{i % 3}",
                            "ok"))
            t = inv + float(rng.random()) * 0.8
    return out


def initials():
    """The reference's forms of ``initial``: none, a scalar, a dict and
    a callable."""
    return (None, "A", {0: "A", 2: "B"}, lambda k: "B" if k == 1 else None)


@pytest.mark.parametrize("seed", range(24))
def test_check_history_matches_the_reference(seed):
    h = random_history(seed)
    hj = [jl.Op(*f) for f in h]
    ht = [tl.Op(*f) for f in h]
    assert [plain(o) for o in hj] == [plain(o) for o in ht]
    for init in initials():
        assert jl.check_history(hj, initial=init) == \
            tl.check_history(ht, initial=init)


def test_random_histories_take_both_verdicts():
    """The seeded histories are no trivial pass: each verdict occurs, on
    the exhaustive search and on the depth-first one."""
    seen = set()
    for seed in range(24):
        h = random_history(seed)
        for k in range(3):
            ops = [tl.Op(*f) for f in h if f[1] == k]
            if not ops:
                continue
            live = [o for o in ops if o.status != "fenced"]
            exhaustive = all(o.status == "ok" for o in live) and \
                len(live) <= 8
            seen.add((exhaustive, tl.check_key_history(ops)))
    assert {(True, True), (True, False), (False, True),
            (False, False)} <= seen


@pytest.mark.parametrize("max_exhaustive", (0, 3, 8))
@pytest.mark.parametrize("seed", range(6))
def test_check_key_history_matches_the_reference(seed, max_exhaustive):
    h = random_history(100 + seed, keys=1, ops=8)
    for init in ("A", None):
        assert jl.check_key_history([jl.Op(*f) for f in h], init,
                                    max_exhaustive) == \
            tl.check_key_history([tl.Op(*f) for f in h], init,
                                 max_exhaustive)


def mk_twin(kns: int, keys: int) -> Twin:
    """test_cluster.py:mk's dinomo cluster, as twins."""
    t = Twin("dinomo", num_kns=kns, cache_bytes=1 << 19, value_bytes=1024,
             num_buckets=1 << 13, segment_capacity=256)
    t.load(keys)
    return t


def test_replicated_writes_history():
    """test_cluster.py:test_replicated_writes_linearizable on twins."""
    t = mk_twin(4, 1000)
    hists = []
    for c, mod in zip(t.clusters, (jl, tl)):
        c.replicate_key(7, 4)
        hist = []
        tt = 0.0
        for i in range(60):
            if i % 3 == 0:
                c.write(7, f"w{i}")
                hist.append(mod.Op("write", 7, f"w{i}", tt, tt + 0.5))
            else:
                v, _, ok = c.read(7)
                assert ok
                hist.append(mod.Op("read", 7, v, tt, tt + 0.5))
            tt += 1
        hists.append(hist)
    assert plain(hists[0]) == plain(hists[1])
    assert jl.check_history(hists[0], initial="v7") == \
        tl.check_history(hists[1], initial="v7") == {7: True}
    t.check()


@pytest.mark.parametrize("seed", (0, 7, 123_457))
def test_random_cluster_history(seed):
    """test_cluster.py:TestLinearizability.test_random_history on twins
    (the reference draws its seeds from hypothesis; these are fixed)."""
    t = mk_twin(3, 50)
    hists = []
    for c, mod in zip(t.clusters, (jl, tl)):
        rng = np.random.default_rng(seed)
        hist = []
        tt = 0.0
        for i in range(80):
            k = int(rng.integers(0, 10))
            if rng.random() < 0.4:
                c.write(k, f"w{i}")
                hist.append(mod.Op("write", k, f"w{i}", tt, tt + 0.5))
            else:
                v, _, ok = c.read(k)
                assert ok
                hist.append(mod.Op("read", k, v, tt, tt + 0.5))
            tt += 1
            if i % 17 == 0:
                c.advance_merge(256)
        hists.append(hist)
    assert plain(hists[0]) == plain(hists[1])
    want = jl.check_history(hists[0], initial=lambda k: f"v{k}")
    assert tl.check_history(hists[1], initial=lambda k: f"v{k}") == want
    assert all(want.values())
    t.check()


@pytest.mark.parametrize("history, initial, verdict", [
    # test_cluster.py:test_checker_rejects_bad
    ([("write", 1, "A", 0, 1), ("write", 1, "B", 2, 3),
      ("read", 1, "A", 4, 5)], None, False),
    # test_cluster.py:test_checker_accepts_concurrent
    ([("write", 1, "A", 0, 10), ("read", 1, "A", 2, 3),
      ("read", 1, None, 1, 2)], None, True),
])
def test_checker_cases(history, initial, verdict):
    got = [mod.check_history([mod.Op(*f) for f in history],
                             initial=initial)[1] for mod in (jl, tl)]
    assert got == [verdict, verdict]
