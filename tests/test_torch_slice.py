"""The port's DPM slice end to end on the CPU against the JAX reference:
a seeded load through log_append_merge, then YCSB read_only and
write_heavy_update batches (reads through kvs_lookup, writes through
log_append_merge, in log order), comparing every output and the final
table, segment and heap. Exact comparisons (integers)."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import clht as jc  # noqa: E402
from repro.core import hashring as jhr  # noqa: E402
from repro.core import log as jl  # noqa: E402
from repro.data import ycsb as jy  # noqa: E402
from repro.kernels import clht_probe as jp  # noqa: E402
from repro.kernels import log_merge as jm  # noqa: E402
from repro_torch import state  # noqa: E402
from repro_torch.core import clht as tc  # noqa: E402
from repro_torch.core import hashring as thr  # noqa: E402
from repro_torch.core import log as tl  # noqa: E402
from repro_torch.data import ycsb as ty  # noqa: E402
from repro_torch.kernels import clht_probe as tp  # noqa: E402
from repro_torch.kernels import log_merge as tm  # noqa: E402

NB, NKEYS, WIDTH = 1 << 8, 1000, 8
LOAD_BATCH, OP_BATCH, OP_BATCHES = 250, 160, 2


def jfields(x) -> dict:
    return {f.name: np.array(getattr(x, f.name))
            for f in dataclasses.fields(x)}


def rows(keys, version):
    """Value rows as a fixed integer hash of (key, version, lane)."""
    k = np.asarray(keys, np.int64)[:, None]
    lane = np.arange(WIDTH, dtype=np.int64)[None, :]
    h = (k * 0x9E3779B1 + np.int64(version) * 0x85EBCA77 + lane * 0xC2B2AE3D)
    return ((h ^ (h >> 15)) & 0x7FFFFFFF).astype(np.int32)


class Planes:
    """The reference plane and the port's plane, fed the same batches."""

    def __init__(self, cap):
        self.j = [jc.clht_init(NB), jl.segment_init(cap),
                  jl.heap_init(cap, WIDTH)]
        self.t = [tc.clht_init(NB, device="cpu"),
                  tl.segment_init(cap, device="cpu"),
                  tl.heap_init(cap, WIDTH, device="cpu")]

    def write(self, keys, vals):
        keys = keys.astype(np.int32)
        *self.j, pj, oj, kj = jm.log_append_merge(
            *self.j, jnp.asarray(keys), jnp.asarray(vals))
        *_, pt, ot, kt = tm.log_append_merge(
            *self.t, torch.from_numpy(keys), torch.from_numpy(vals))
        for a, b in ((pt, pj), (ot, oj), (kt, kj)):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        return kt.numpy()

    def read(self, keys):
        keys = keys.astype(np.int32)
        vj, pj, fj = jp.kvs_lookup(self.j[0], self.j[2], jnp.asarray(keys))
        vt, pt, ft = tp.kvs_lookup(self.t[0], self.t[2],
                                   torch.from_numpy(keys))
        for a, b in ((vt, vj), (pt, pj), (ft, fj)):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        return vt.numpy(), ft.numpy()

    def assert_same_state(self):
        for jx, tx in zip(self.j, self.t):
            ref, got = jfields(jx), state.to_numpy(tx)
            for name in ref:
                np.testing.assert_array_equal(got[name], ref[name],
                                              err_msg=name)


def test_slice_load_read_only_write_heavy_update():
    rng = np.random.default_rng(11)
    cap = NKEYS + OP_BATCHES * OP_BATCH + 8
    planes = Planes(cap)
    version = np.zeros(NKEYS, np.int64)
    order = rng.permutation(NKEYS)
    for lo in range(0, NKEYS, LOAD_BATCH):
        keys = order[lo:lo + LOAD_BATCH]
        planes.write(keys, rows(keys, 0))
    planes.assert_same_state()

    ro = ty.Workload(NKEYS, mix="read_only", seed=1)
    for _ in range(OP_BATCHES):
        _, keys = ro.ops_arrays(OP_BATCH)
        vals, found = planes.read(keys)
        ok = found.copy()
        np.testing.assert_array_equal(vals[ok], rows(keys, 0)[ok])

    wh = ty.Workload(NKEYS, mix="write_heavy_update", seed=2)
    for b in range(OP_BATCHES):
        kinds, keys = wh.ops_arrays(OP_BATCH)
        rk = keys[kinds == 0]
        vals, found = planes.read(rk)
        for i in np.flatnonzero(found):
            np.testing.assert_array_equal(vals[i], rows(rk[i:i + 1],
                                                        version[rk[i]])[0])
        wk = keys[kinds == 1]
        v = 1 + b
        ok = planes.write(wk, rows(wk, v))
        version[wk[ok]] = v
    planes.assert_same_state()


@pytest.mark.parametrize("seed,mix", [(0, "write_heavy_update"),
                                      (3, "read_only"),
                                      (5, "write_heavy_insert")])
def test_workload_streams_match_reference(seed, mix):
    a = ty.Workload(5000, mix=mix, seed=seed)
    b = jy.Workload(5000, mix=mix, seed=seed)
    for n in (100, 1000):
        ka, xa = a.ops_arrays(n)
        kb, xb = b.ops_arrays(n)
        np.testing.assert_array_equal(ka, kb)
        np.testing.assert_array_equal(xa, xb)
    assert a.hot_keys() == b.hot_keys()
    assert ty.MIXES == jy.MIXES


def test_mix64_matches_reference():
    x = np.random.default_rng(9).integers(0, 2**62, 1000, dtype=np.int64)
    np.testing.assert_array_equal(thr.mix64_batch(x), jhr.mix64_batch(x))
    assert [thr.mix64(int(v)) for v in x[:50]] == \
        [jhr.mix64(int(v)) for v in x[:50]]
