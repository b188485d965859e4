"""core/spans.py and the spans inside the DPM pool's batched calls
(``kvs_lookup``, ``log_append_merge``), on the CPU: off it records
nothing, on it keeps each span with its parent, folds self and wait
time, counts the keys the chain walk takes, and enters the profiler's
trace only while the profiler runs."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import clht as tc  # noqa: E402
from repro_torch.core import log as tl  # noqa: E402
from repro_torch.core import spans  # noqa: E402
from repro_torch.kernels import clht_probe as tp  # noqa: E402
from repro_torch.kernels import log_merge as tm  # noqa: E402

WIDTH = 4
READ, WRITE = "dinomo.kvs_lookup", "dinomo.log_append_merge"


@pytest.fixture(autouse=True)
def facility():
    """Each test starts with the facility off and empty, and leaves it so."""
    spans.disable()
    spans.reset()
    yield spans
    spans.disable()
    spans.reset()


def pool(nb=64, n=600, seed=0):
    """A small pool with heavy chains: ``n`` keys over ``nb`` buckets
    (as ``test_torch_clht_probe.py`` builds one), written in two batches
    so that the second one's merge finds full buckets. Returns (table,
    seg, heap, keys)."""
    g = np.random.default_rng(seed)
    keys = torch.from_numpy(g.choice(10 * n, n, replace=False)
                            .astype(np.int32))
    table = tc.clht_init(nb, device="cpu")
    seg = tl.segment_init(4 * n, device="cpu")
    heap = tl.heap_init(4 * n, WIDTH, device="cpu")
    for half in (keys[:n // 2], keys[n // 2:]):
        table, seg, heap = write(table, seg, heap, half)[:3]
    return table, seg, heap, keys


def write(table, seg, heap, keys):
    vals = keys[:, None].repeat(1, WIDTH) + torch.arange(WIDTH,
                                                         dtype=torch.int32)
    return tm.log_append_merge(table, seg, heap, keys, vals)


def read_batch(p):
    table, _, heap, keys = p
    probe = torch.cat([keys, torch.tensor([10**7, 10**7 + 1],
                                          dtype=torch.int32)])
    return tp.kvs_lookup(table, heap, probe)


def write_batch(p):
    table, seg, heap, keys = p
    return write(table, seg, heap, (keys[::3] + 1).contiguous())


BATCHES = {"read": read_batch, "write": write_batch}


@pytest.mark.parametrize("kind", sorted(BATCHES))
def test_off_records_nothing(kind):
    p = pool()
    BATCHES[kind](p)
    assert spans.records() == []
    assert spans.summary() == {"spans": {}, "counters": {}}
    null = spans.span(READ)
    assert spans.span("dinomo.other", wait=True) is null
    with null:
        spans.count("dinomo.kvs_lookup.keys", 5)
    assert spans.summary()["counters"] == {}


def test_on_keeps_parents_and_folds_self_and_wait(monkeypatch):
    #   root [0, 100): a [10, 30) holding wait w [15, 25);
    #   wait w2 [40, 60); b [70, 90)
    clock = iter([0, 10, 15, 25, 30, 40, 60, 70, 90, 100])
    monkeypatch.setattr(spans, "_clock", lambda: next(clock))
    spans.enable()
    with spans.span("root"):
        with spans.span("a"):
            with spans.span("w", wait=True):
                pass
        with spans.span("w2", wait=True):
            pass
        with spans.span("b"):
            pass
    assert spans.records() == [("root", -1, 0, 100, False),
                               ("a", 0, 10, 30, False),
                               ("w", 1, 15, 25, True),
                               ("w2", 0, 40, 60, True),
                               ("b", 0, 70, 90, False)]
    got = spans.summary()["spans"]
    ns = 1e-9
    assert got["root"] == pytest.approx({
        "calls": 1, "total_s": 100 * ns, "self_s": 40 * ns,
        "wait_s": 30 * ns, "waits": 2})
    assert got["a"] == pytest.approx({
        "calls": 1, "total_s": 20 * ns, "self_s": 10 * ns, "wait_s": 10 * ns,
        "waits": 1})
    assert got["w"]["wait_s"] == got["w"]["total_s"] == pytest.approx(10 * ns)
    assert got["b"]["waits"] == 0 and got["b"]["wait_s"] == 0


# the parent of each span a call records, by name
PARENTS = {
    "read": {READ: None, READ + ".probe": READ, READ + ".walk_test": READ,
             READ + ".chain_walk": READ},
    "write": {WRITE: None, WRITE + ".append": WRITE, WRITE + ".merge": WRITE,
              "dinomo.log_merge.group_starts": WRITE + ".merge",
              "dinomo.log_merge.group_end": WRITE + ".merge",
              WRITE + ".slow_test": WRITE, WRITE + ".slow_path": WRITE},
}
# host syncs a call makes: the wait spans under its root
SYNCS = {"read": 1, "write": 3}


@pytest.mark.parametrize("kind", sorted(BATCHES))
def test_a_call_records_its_stages_under_its_root(kind):
    p = pool()
    spans.enable()
    BATCHES[kind](p)
    recs = spans.records()
    names = [r[0] for r in recs]
    assert sorted(names) == sorted(PARENTS[kind])
    for name, parent, t0, t1, wait in recs:
        want = PARENTS[kind][name]
        assert (recs[parent][0] if parent >= 0 else None) == want, name
        assert t1 >= t0
        assert wait == name.endswith(("walk_test", "slow_test",
                                      "group_starts", "group_end"))
    root = spans.summary()["spans"][recs[0][0]]
    assert root["calls"] == 1 and root["waits"] == SYNCS[kind]
    assert 0 <= root["self_s"] <= root["total_s"]
    assert root["wait_s"] == pytest.approx(sum(
        (t1 - t0) / 1e9 for _, _, t0, t1, w in recs if w))


@pytest.mark.parametrize("nb,n,seed", [(64, 600, 0), (16, 200, 1),
                                       (256, 600, 2)])
def test_walked_keys_are_the_keys_that_missed_a_chained_bucket(nb, n, seed):
    table, seg, heap, keys = pool(nb, n, seed)
    probe = torch.cat([keys, keys[::2] + 10 * n])
    lines = table.lines.numpy()
    bids = tc.bucket_of(probe, nb).numpy()
    plain = sum(1 for k, b in zip(probe.tolist(), bids.tolist())
                if k not in lines[b, :tc.SLOTS].tolist()
                and lines[b, tc.LINK] >= 0)
    spans.enable()
    tp.kvs_lookup(table, heap, probe)
    assert spans.summary()["counters"] == {
        "dinomo.kvs_lookup.keys": probe.numel(),
        "dinomo.kvs_lookup.walked_keys": plain}
    assert 0 < plain < probe.numel()


def test_every_pinned_name_appears_after_one_read_and_one_write():
    p = pool()
    spans.enable()
    read_batch(p)
    write_batch(p)
    got = spans.summary()
    assert sorted(got["spans"]) == sorted(spans.NAMES)
    assert sorted(got["counters"]) == sorted(spans.COUNTERS)
    assert all(n.startswith("dinomo.") for n in spans.NAMES + spans.COUNTERS)


@pytest.mark.parametrize("kind", sorted(BATCHES))
def test_results_are_the_same_on_and_off(kind):
    outs = []
    for on in (False, True):
        (spans.enable if on else spans.disable)()
        outs.append(BATCHES[kind](pool()))
    for a, b in zip(*outs):
        if isinstance(a, torch.Tensor):
            assert torch.equal(a, b)


@pytest.mark.parametrize("on", [False, True])
def test_ranges_enter_the_profiler_only_while_on(on):
    from torch.profiler import ProfilerActivity, profile
    p = pool()
    (spans.enable if on else spans.disable)()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        read_batch(p)
        write_batch(p)
    names = {e.name for e in prof.events() if e.name.startswith("dinomo.")}
    assert names == (set(spans.NAMES) if on else set())
    # outside the profiler the spans are kept all the same
    assert len(spans.records()) == (len(spans.NAMES) if on else 0)


def test_count_refuses_a_tensor_and_reset_an_open_span():
    spans.enable()
    with pytest.raises(TypeError, match="host int"):
        spans.count("dinomo.kvs_lookup.keys", torch.tensor(3))
    with spans.span(READ):
        with pytest.raises(RuntimeError, match="open span"):
            spans.reset()
    spans.reset()
    assert spans.records() == [] and spans.enabled()
