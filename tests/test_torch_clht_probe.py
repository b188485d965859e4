"""Port parity for the read path: repro_torch.kernels.clht_probe (plain
torch versions on the CPU) against repro.kernels.clht_probe (Pallas in
interpret mode), mirroring the reference's kernel sweeps. Exact
comparisons (integers)."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core.clht import bucket_of, clht_init, clht_insert, clht_lookup  # noqa: E402,E501
from repro.core.log import heap_append, heap_init  # noqa: E402
from repro.kernels import clht_probe as jk  # noqa: E402
from repro_torch import state  # noqa: E402
from repro_torch.core import clht as tc  # noqa: E402
from repro_torch.kernels import clht_probe as tk  # noqa: E402

RNG = np.random.default_rng(42)


def jfields(x) -> dict:
    return {f.name: np.array(getattr(x, f.name))
            for f in dataclasses.fields(x)}


def port(table=None, heap=None):
    t, _, h = state.from_jax_arrays(
        table=None if table is None else jfields(table),
        heap=None if heap is None else jfields(heap), device="cpu")
    return t, h


def assert_eq(got, ref):
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


@pytest.mark.parametrize("nb,nkeys", [(64, 100), (128, 400), (256, 50)])
def test_clht_probe_sweep(nb, nkeys):
    keys = RNG.choice(10_000, nkeys, replace=False).astype(np.int32)
    t = clht_init(nb)
    t, *_ = clht_insert(t, jnp.array(keys),
                        jnp.arange(nkeys, dtype=jnp.int32))
    probe = np.concatenate([keys[:nkeys // 2], RNG.integers(10_001, 20_000, 25),
                            [-1, -3]]).astype(np.int32)
    bids = bucket_of(jnp.asarray(probe), nb)
    p_j, f_j = jk.clht_probe(jk.pack_table(t.keys, t.ptrs, t.nxt), bids,
                             jnp.asarray(probe))
    tt, _ = port(t)
    lines = tk.pack_table(tt.keys, tt.ptrs, tt.nxt)
    assert torch.equal(lines, tt.lines)
    tb = tc.bucket_of(torch.from_numpy(probe), nb)
    assert_eq(tb, bids)
    p_t, f_t = tk.clht_probe(lines, tb, torch.from_numpy(probe))
    assert p_t.dtype == f_t.dtype == torch.int32
    assert_eq(p_t, p_j)
    assert_eq(f_t, f_j)
    p_r, f_r = tk.clht_probe_ref(lines, tb, torch.from_numpy(probe))
    assert_eq(p_r, p_j)
    assert_eq(f_r, f_j)


@pytest.mark.parametrize("nb,nkeys,width,block", [
    (64, 100, 8, 128), (256, 500, 4, 64), (64, 600, 4, 128)])
def test_kvs_lookup_fused_matches_ref(nb, nkeys, width, block):
    """Fused probe+gather == chain walk + separate heap gather, including
    keys that overflow into chained buckets and misses."""
    keys = RNG.choice(10_000, nkeys, replace=False).astype(np.int32)
    t = clht_init(nb)
    heap = heap_init(nkeys + 8, width)
    vals = jnp.arange(nkeys * width, dtype=jnp.int32).reshape(nkeys, width)
    heap, ptrs = heap_append(heap, vals)
    t, _, ok, _ = clht_insert(t, jnp.array(keys), ptrs)
    probe = np.concatenate([keys[:nkeys // 2], RNG.integers(10_001, 20_000,
                                                            37)]).astype(np.int32)
    v_j, p_j, f_j = jk.kvs_lookup(t, heap, jnp.asarray(probe), block=block)
    tt, th = port(t, heap)
    v_t, p_t, f_t = tk.kvs_lookup(tt, th, torch.from_numpy(probe))
    assert f_t.dtype == torch.bool
    assert_eq(v_t, v_j)
    assert_eq(p_t, p_j)
    assert_eq(f_t, f_j)
    v_r, p_r, f_r = tk.kvs_lookup_ref(tt, th, torch.from_numpy(probe))
    assert_eq(v_r, v_j)
    assert_eq(p_r, p_j)
    assert_eq(f_r, f_j)
    # kernel B's function alone: primary bucket only, as the Pallas kernel
    jb = bucket_of(jnp.asarray(probe), nb)
    pad = (-len(probe)) % block
    jkeys = jnp.asarray(np.concatenate([probe, -np.ones(pad, np.int32)]))
    fv, fp, ff = jk.kvs_lookup_fused(
        jk.pack_table(t.keys, t.ptrs, t.nxt), heap.data,
        bucket_of(jkeys, nb), jkeys, block=block)
    gv, gp, gf = tk.kvs_lookup_fused(tt.lines, th.data,
                                     tc.bucket_of(torch.from_numpy(probe), nb),
                                     torch.from_numpy(probe))
    n = len(probe)
    assert_eq(gv, fv[:n])
    assert_eq(gp, fp[:n])
    assert_eq(gf, ff[:n])
    assert_eq(tc.bucket_of(torch.from_numpy(probe), nb), jb)


def test_full_lookup_matches_chain_walk():
    keys = RNG.choice(5000, 600, replace=False).astype(np.int32)
    t = clht_init(64)   # heavy chains
    t, _, ok, _ = clht_insert(t, jnp.array(keys),
                              jnp.arange(600, dtype=jnp.int32))
    probe = keys[np.asarray(ok)[:600]][:200]
    p_j, f_j = jk.lookup(t, jnp.asarray(probe))
    p_c, f_c, _ = clht_lookup(t, jnp.asarray(probe))
    tt, _ = port(t)
    p_t, f_t = tk.lookup(tt, torch.from_numpy(probe))
    assert f_t.dtype == torch.bool
    assert_eq(p_t, p_j)
    assert_eq(f_t, f_j)
    assert_eq(p_t, p_c)
    assert_eq(f_t, f_c)
