"""Port parity: the torch log segment and value heap
(repro_torch.core.log) against the JAX reference (repro.core.log) on the
same numpy-seeded inputs. Exact comparisons (integers)."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import clht as jc  # noqa: E402
from repro.core import log as jl  # noqa: E402
from repro_torch import state  # noqa: E402
from repro_torch.core import clht as tc  # noqa: E402
from repro_torch.core import log as tl  # noqa: E402


def jfields(x) -> dict:
    return {f.name: np.array(getattr(x, f.name))
            for f in dataclasses.fields(x)}


def assert_same(jx, tx):
    ref, got = jfields(jx), state.to_numpy(tx)
    assert ref.keys() == got.keys()
    for name in ref:
        np.testing.assert_array_equal(got[name], ref[name], err_msg=name)


@pytest.mark.parametrize("cap,width,batches", [
    (16, 4, [3, 5, 8]),       # fills exactly
    (6, 2, [4, 4]),           # overflows: the reference clamps the write
])
def test_heap_append(cap, width, batches):
    rng = np.random.default_rng(cap)
    jh = jl.heap_init(cap, width)
    th = tl.heap_init(cap, width, device="cpu")
    for n in batches:
        vals = rng.integers(-50, 50, (n, width)).astype(np.int32)
        jh, jp = jl.heap_append(jh, jnp.asarray(vals))
        th, tp = tl.heap_append(th, torch.from_numpy(vals))
        np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
        assert_same(jh, th)
    if cap == 6:
        # the defect both planes share: committed rows 2-3 were
        # overwritten, ptrs ran past the end and head > capacity
        assert th.head == 8 > cap
        np.testing.assert_array_equal(tp.numpy(), [4, 5, 6, 7])
        np.testing.assert_array_equal(th.data[2:].numpy(), vals)
    ptrs = torch.tensor([0, 3, cap + 5, -1], dtype=torch.int32)
    np.testing.assert_array_equal(
        tl.heap_read(th, ptrs).numpy(),
        np.asarray(jl.heap_read(jh, jnp.asarray(ptrs.numpy()))))


def test_log_append_fit_and_no_fit():
    rng = np.random.default_rng(1)
    js = jl.segment_init(10)
    ts = tl.segment_init(10, device="cpu")
    for n in (4, 5, 3, 1):          # the third does not fit, the fourth does
        keys = rng.integers(0, 99, n).astype(np.int32)
        ptrs = rng.integers(0, 99, n).astype(np.int32)
        js, jok = jl.log_append(js, jnp.asarray(keys), jnp.asarray(ptrs))
        ts, tok = tl.log_append(ts, torch.from_numpy(keys),
                                torch.from_numpy(ptrs))
        assert tok == bool(jok)
        assert_same(js, ts)
    assert ts.count == 10


@pytest.mark.parametrize("torn,merged", [([], 0), ([5], 2), ([2, 7], 4),
                                         ([0], 0), ([6], 9)])
def test_recover_segment_with_torn_seals(torn, merged):
    rng = np.random.default_rng(len(torn) + merged)
    js = jl.segment_init(16)
    keys = rng.integers(0, 99, 10).astype(np.int32)
    js, _ = jl.log_append(js, jnp.asarray(keys), jnp.asarray(keys + 1))
    seal = np.array(js.seal)
    seal[torn] = jl.TORN
    js = jl.LogSegment(keys=js.keys, ptrs=js.ptrs, seal=jnp.asarray(seal),
                       count=js.count, merged=jnp.int32(merged))
    _, ts, _ = state.from_jax_arrays(seg=jfields(js), device="cpu")
    assert_same(jl.recover_segment(js), tl.recover_segment(ts))


def test_merge_segment():
    rng = np.random.default_rng(3)
    jt, tt = jc.clht_init(16), tc.clht_init(16, device="cpu")
    js, ts = jl.segment_init(64), tl.segment_init(64, device="cpu")
    for n in (20, 25):
        keys = rng.integers(0, 60, n).astype(np.int32)
        ptrs = rng.integers(0, 10**5, n).astype(np.int32)
        js, _ = jl.log_append(js, jnp.asarray(keys), jnp.asarray(ptrs))
        ts, _ = tl.log_append(ts, torch.from_numpy(keys),
                              torch.from_numpy(ptrs))
        jt, js, jold, jinv = jl.merge_segment(jt, js)
        tt, ts, told, tinv = tl.merge_segment(tt, ts)
        np.testing.assert_array_equal(told.numpy(), np.asarray(jold))
        assert int(tinv) == int(jinv)
        assert_same(js, ts)
        assert_same(jt, tt)
