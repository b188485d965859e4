"""The port's CUDA kernels against their plain torch versions, on the
card (marked ``cuda``; they skip without one). Every comparison is exact.

On the card, where JAX is absent, run them without the repository's
conftest (which loads the JAX package):

    PYTHONPATH=src python -m pytest --noconftest -q tests/test_torch_cuda.py
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import clht as tc  # noqa: E402
from repro_torch.core import log as tl  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import clht_probe as tp  # noqa: E402
from repro_torch.kernels import log_merge as tm  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def filled(dev, nb, nkeys, space, seed, overflow=None, width=8):
    g = np.random.default_rng(seed)
    keys = torch.from_numpy(g.choice(space, nkeys, replace=False)
                            .astype(np.int32)).to(dev)
    table = tc.clht_init(nb, overflow, device=dev)
    heap = tl.heap_init(nkeys, width, device=dev)
    vals = torch.from_numpy(g.integers(0, 2**31 - 1, (nkeys, width))
                            .astype(np.int32)).to(dev)
    heap, ptrs = tl.heap_append(heap, vals)
    tc.clht_insert(table, keys, ptrs)
    return table, heap, keys, g


@pytest.mark.parametrize("nb,nkeys,width", [(64, 300, 8), (1024, 4000, 256),
                                            (256, 900, 6)])
def test_probe_and_fused_lookup_match_plain(dev, nb, nkeys, width):
    table, heap, keys, g = filled(dev, nb, nkeys, 10 * nkeys, nb,
                                  width=width)
    probe = torch.cat([keys[::2], torch.tensor([-1, -3, 10**8], device=dev,
                                               dtype=torch.int32)])
    bids = tc.bucket_of(probe, nb)
    n0 = _build.launches["clht_probe"]
    for got, ref in zip(tp.clht_probe(table.lines, bids, probe),
                        tp.clht_probe_ref(table.lines, bids, probe)):
        assert torch.equal(got, ref)
    assert _build.launches["clht_probe"] == n0 + 1
    for got, ref in zip(
            tp.kvs_lookup_fused(table.lines, heap.data, bids, probe),
            tp.kvs_lookup_fused_ref(table.lines, heap.data, bids, probe)):
        assert torch.equal(got, ref)
    real = probe[probe >= 0]
    for got, ref in zip(tp.kvs_lookup(table, heap, real),
                        tp.kvs_lookup_ref(table, heap, real)):
        assert torch.equal(got, ref)


@pytest.mark.parametrize("nb,entries,space", [(64, 500, 2), (16, 2000, 6)])
def test_log_merge_matches_plain(dev, nb, entries, space):
    table, _, _, g = filled(dev, nb, nb, nb * space, 3)
    keys = torch.from_numpy(g.integers(0, nb * space, entries)
                            .astype(np.int32)).to(dev)
    keys[::13] = -3
    ptrs = torch.arange(entries, dtype=torch.int32, device=dev)
    bids = tc.bucket_of(keys.clamp(min=0), nb)
    lines_k, lines_r = table.lines.clone(), table.lines.clone()
    _, old_k, ok_k = tm.log_merge(lines_k, bids, keys, ptrs)
    bs, order, starts = tm.sort_by_bucket(bids)
    old_s, ok_s = tm.log_merge_sorted_ref(lines_r, starts, bs,
                                          keys[order], ptrs[order])
    assert torch.equal(lines_k, lines_r)
    assert torch.equal(old_k[order], old_s)
    assert torch.equal(ok_k[order], ok_s)


@pytest.mark.parametrize("nb,overflow,n", [(64, None, 600), (32, 8, 800)])
def test_clht_insert_matches_plain(dev, nb, overflow, n):
    g = np.random.default_rng(n)
    keys = torch.from_numpy(g.integers(0, 3 * n, n).astype(np.int32)).to(dev)
    ptrs = torch.arange(n, dtype=torch.int32, device=dev)
    mask = torch.from_numpy(g.random(n) < 0.9).to(dev)
    a = tc.clht_init(nb, overflow, device=dev)
    b = tc.clht_init(nb, overflow, device=dev)
    got = tc.clht_insert(a, keys, ptrs, mask)
    ref = tc.clht_insert_plain(b, keys, ptrs, mask)
    assert torch.equal(a.lines, b.lines)
    assert int(a.overflow_head) == int(b.overflow_head)
    for x, y in zip(got[1:], ref[1:]):
        assert torch.equal(x, y)


def test_write_path_and_read_back(dev):
    table = tc.clht_init(128, device=dev)
    seg = tl.segment_init(2000, device=dev)
    heap = tl.heap_init(2000, 16, device=dev)
    g = np.random.default_rng(1)
    last = {}
    for _ in range(4):
        keys = torch.from_numpy(g.integers(0, 700, 400).astype(np.int32))
        vals = torch.from_numpy(g.integers(0, 99, (400, 16)).astype(np.int32))
        table, seg, heap, ptrs, _, ok = tm.log_append_merge(
            table, seg, heap, keys.to(dev), vals.to(dev))
        for k, p, o, v in zip(keys.tolist(), ptrs.tolist(), ok.tolist(),
                              vals):
            if o:
                last[k] = (p, v)
    probe = torch.tensor(sorted(last), dtype=torch.int32, device=dev)
    vals, ptrs, found = tp.kvs_lookup(table, heap, probe)
    assert bool(found.all())
    assert ptrs.tolist() == [last[k][0] for k in sorted(last)]
    assert torch.equal(vals.cpu(), torch.stack([last[k][1]
                                                for k in sorted(last)]))


def test_wrappers_refuse_bad_inputs(dev):
    table = tc.clht_init(8, device=dev)
    keys = torch.arange(4, dtype=torch.int32, device=dev)
    with pytest.raises(TypeError):
        tp.clht_probe(table.lines, tc.bucket_of(keys, 8), keys.long())
    with pytest.raises(ValueError):
        tp.clht_probe(table.lines, tc.bucket_of(keys, 8)[::1], keys[::2])
    with pytest.raises(ValueError):
        tp.clht_probe(table.lines[:, :4], tc.bucket_of(keys, 8), keys)
