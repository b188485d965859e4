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


# ------------------------------------------- kernel A's design, in numpy
def mirror_probe(lines, bids, keys, warps):
    """csrc/clht_probe.cu's kernel A step by step over whole warps: per
    pass, each warp loads a group of 32 (key, bucket id), the lane pair
    (2p, 2p+1) reads the lines of keys p and p + 16 as two 16-byte halves
    (bucket ids and keys by shuffle), the even lane compares with slots
    1-2's pointers shuffled from the odd lane, and the results go back to
    the owning lanes. Returns (ptrs, found) int32."""
    lines = np.asarray(lines, np.int64)
    n, total = keys.size, lines.shape[0]
    ptrs = np.zeros(n, np.int64)
    found = np.zeros(n, np.int64)
    lane = np.arange(32)
    for base in range(0, n, warps * 32):
        for warp in range(warps):
            idx = base + warp * 32 + lane
            live = idx < n
            key = np.where(live, keys[np.minimum(idx, n - 1)], -1)
            bid = np.where(live, bids[np.minimum(idx, n - 1)], 0)
            mine = np.full(32, -1, np.int64)
            hit_mine = np.zeros(32, np.int64)
            for r in range(2):
                src = (lane >> 1) + 16 * r
                row = np.clip(bid[src], 0, total - 1)
                h = lines[row[:, None], 4 * (lane & 1)[:, None]
                          + np.arange(4)]            # (32 lanes, 4)
                k = key[src]
                p1, p2 = h[lane ^ 1, 0], h[lane ^ 1, 1]
                hits = (k[:, None] >= 0) & (h[:, :3] == k[:, None])
                total_p = (np.where(hits[:, 0], h[:, 3], 0)
                           + np.where(hits[:, 1], p1, 0)
                           + np.where(hits[:, 2], p2, 0))
                total_p = (total_p + 2**31) % 2**32 - 2**31
                hit = hits.any(1).astype(np.int64)
                frm = 2 * (lane & 15)
                take = (lane >> 4) == r
                mine = np.where(take, np.where(hit[frm] == 1,
                                               total_p[frm], -1), mine)
                hit_mine = np.where(take, hit[frm], hit_mine)
            ptrs[idx[live]] = mine[live]
            found[idx[live]] = hit_mine[live]
    return ptrs.astype(np.int32), found.astype(np.int32)


@pytest.mark.parametrize("n,warps", [
    (1, 1), (31, 1), (33, 3), (97, 2), (1000, 5), (4097, 3)])
def test_kernel_a_mirror_matches_plain(n, warps):
    """The numpy mirror of kernel A's warp design equals clht_probe_ref on
    lines no insert makes (a key two or three times in a line, keys equal
    to the link or the pad, pointers at int32's ends) and on bucket ids
    out of range, at batch sizes that leave passes and warps partly
    empty."""
    g = np.random.default_rng(n)
    tb = 64
    lines = g.integers(0, 6, (tb, 8)).astype(np.int32)
    lines[:, 3:6] = g.choice([0, 1, 2**31 - 1, -2**31, -1, 12345], (tb, 3))
    lines[g.random(tb) < 0.1, :3] = -1
    lines[:, 6] = g.choice([-1, 3, 5], tb)
    lines[:, 7] = g.choice([-1, 4], tb)
    keys = g.integers(-3, 7, n).astype(np.int32)
    bids = g.integers(-2, tb + 2, n).astype(np.int32)
    want = tk.clht_probe_ref(torch.from_numpy(lines), torch.from_numpy(bids),
                             torch.from_numpy(keys))
    got = mirror_probe(lines, bids, keys, warps)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b.numpy())
