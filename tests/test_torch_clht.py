"""Port parity: the torch CLHT (repro_torch.core.clht) against the JAX
reference (repro.core.clht) on the same numpy-seeded inputs. Integers
throughout: every comparison is exact (tolerance 0)."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import clht as jc  # noqa: E402
from repro_torch import state  # noqa: E402
from repro_torch.core import clht as tc  # noqa: E402


def jfields(x) -> dict:
    return {f.name: np.array(getattr(x, f.name))
            for f in dataclasses.fields(x)}


def assert_same_table(jt, tt):
    ref, got = jfields(jt), state.to_numpy(tt)
    for name in ("keys", "ptrs", "nxt", "overflow_head", "num_buckets"):
        np.testing.assert_array_equal(got[name], ref[name], err_msg=name)


EDGE_KEYS = np.array([0, 1, -1, -3, 2**31 - 1, -2**31, 12345, 0x7FEB352D],
                     np.int32)


@pytest.mark.parametrize("nb", [1, 8, 256, 1 << 20])
def test_mix32_and_bucket_of_edge_keys(nb):
    rng = np.random.default_rng(nb)
    keys = np.concatenate([EDGE_KEYS, rng.integers(-2**31, 2**31 - 1, 500,
                                                   dtype=np.int64)
                           .astype(np.int32)])
    got = tc._mix32(torch.from_numpy(keys)).numpy()
    ref = np.asarray(jc._mix32(jnp.asarray(keys))).astype(np.int64)
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(
        tc.bucket_of(torch.from_numpy(keys), nb).numpy(),
        np.asarray(jc.bucket_of(jnp.asarray(keys), nb)))


@pytest.mark.parametrize("nb,overflow,nkeys,space,seed", [
    (64, None, 150, 1000, 0),       # chains
    (16, 4, 120, 300, 1),           # overflow region exhausted: ok=False
    (8, None, 60, 40, 2),           # heavy duplicates (updates)
])
def test_insert_lookup_delete_parity(nb, overflow, nkeys, space, seed):
    rng = np.random.default_rng(seed)
    keys = rng.integers(0, space, nkeys).astype(np.int32)
    ptrs = rng.integers(0, 10**6, nkeys).astype(np.int32)
    mask = rng.random(nkeys) < 0.9
    jt = jc.clht_init(nb, overflow)
    tt = tc.clht_init(nb, overflow, device="cpu")
    assert_same_table(jt, tt)

    jt, jold, jok, jnew = jc.clht_insert(jt, jnp.asarray(keys),
                                         jnp.asarray(ptrs), jnp.asarray(mask))
    tt, told, tok, tnew = tc.clht_insert(tt, torch.from_numpy(keys),
                                         torch.from_numpy(ptrs),
                                         torch.from_numpy(mask))
    assert_same_table(jt, tt)
    np.testing.assert_array_equal(told.numpy(), np.asarray(jold))
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jok))
    assert int(tnew) == int(jnew)
    if overflow == 4:
        assert not np.asarray(jok)[mask].all()   # exhaustion was reached

    probe = np.concatenate([keys, rng.integers(space, 2 * space, 40)
                            .astype(np.int32)])
    jp, jf, jpr = jc.clht_lookup(jt, jnp.asarray(probe))
    tp, tf, tpr = tc.clht_lookup(tt, torch.from_numpy(probe))
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(tf.numpy(), np.asarray(jf))
    np.testing.assert_array_equal(tpr.numpy(), np.asarray(jpr))

    dels = rng.choice(probe, 50).astype(np.int32)
    jt, jdo, jdf = jc.clht_delete(jt, jnp.asarray(dels))
    tt, tdo, tdf = tc.clht_delete(tt, torch.from_numpy(dels))
    assert_same_table(jt, tt)
    np.testing.assert_array_equal(tdo.numpy(), np.asarray(jdo))
    np.testing.assert_array_equal(tdf.numpy(), np.asarray(jdf))

    # inserting after deletes reuses the freed slots in the same order
    more = rng.integers(0, space, 40).astype(np.int32)
    jt, jold, jok, jnew = jc.clht_insert(jt, jnp.asarray(more),
                                         jnp.asarray(more + 7))
    tt, told, tok, tnew = tc.clht_insert(tt, torch.from_numpy(more),
                                         torch.from_numpy(more + 7))
    assert_same_table(jt, tt)
    np.testing.assert_array_equal(told.numpy(), np.asarray(jold))
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jok))
    assert int(tnew) == int(jnew)


def chain_keys(nb, bucket, count):
    """``count`` distinct non-negative keys whose primary bucket is
    ``bucket``."""
    cand = np.arange(400 * count * nb, dtype=np.int32)
    sel = cand[tc.bucket_of(torch.from_numpy(cand), nb).numpy() == bucket]
    assert sel.size >= count
    return sel[:count]


def adversarial_batch(name):
    """(nb, overflow, keys inserted first, keys, ptrs) where a parallel
    insert's shortcuts are tested hardest."""
    rng = np.random.default_rng(len(name))
    pre = None
    if name == "long_chains":       # chains far past MAX_CHAIN lines
        nb, overflow = 4, 2048
        keys = rng.integers(0, 900, 1800)
    elif name == "hot_key_in_overflow":
        # three keys fill bucket 5's line, the hot key sits in an overflow
        # line and repeats among fresh keys of its own chain
        nb, overflow = 64, 512
        own = chain_keys(nb, 5, 154)
        pre, hot = own[:4], own[3]
        keys = np.concatenate([np.full(1500, hot), own[4:],
                               rng.integers(0, 10**6, 150)])
        keys = keys[rng.permutation(keys.size)]
    else:                           # exhaustion mid-batch, duplicates after
        nb, overflow = 16, 6
        keys = rng.integers(0, 400, 1200)
    keys = keys.astype(np.int32)
    ptrs = rng.integers(0, 2**31 - 1, keys.size).astype(np.int32)
    return nb, overflow, pre, keys, ptrs


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("name", ["long_chains", "hot_key_in_overflow",
                                  "exhaustion"])
def test_insert_parity_adversarial(name, masked):
    """The inputs the card tests hold kernel D to, JAX against the port:
    chains longer than MAX_CHAIN (keys linked out of the walk's reach), a
    hot key repeated in an overflow line among fresh keys of its chain,
    the overflow region running out mid-batch with duplicates after."""
    nb, overflow, pre, keys, ptrs = adversarial_batch(name)
    mask = np.random.default_rng(7).random(keys.size) < 0.8 if masked \
        else None
    jt = jc.clht_init(nb, overflow)
    tt = tc.clht_init(nb, overflow, device="cpu")
    if pre is not None:
        jt, *_ = jc.clht_insert(jt, jnp.asarray(pre), jnp.asarray(pre + 9))
        tc.clht_insert(tt, torch.from_numpy(pre), torch.from_numpy(pre + 9))
    jt, jold, jok, jnew = jc.clht_insert(
        jt, jnp.asarray(keys), jnp.asarray(ptrs),
        None if mask is None else jnp.asarray(mask))
    tt, told, tok, tnew = tc.clht_insert(
        tt, torch.from_numpy(keys), torch.from_numpy(ptrs),
        None if mask is None else torch.from_numpy(mask))
    assert_same_table(jt, tt)
    np.testing.assert_array_equal(told.numpy(), np.asarray(jold))
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jok))
    assert int(tnew) == int(jnew)
    okv = np.asarray(jok) if mask is None else np.asarray(jok)[mask]
    if name == "exhaustion":
        assert int(tt.overflow_head) == tt.total_buckets
        assert okv.any() and not okv.all()
    else:
        assert okv.all()
    if name == "long_chains":       # some key was linked past the walk
        assert int(tnew) > np.unique(keys if mask is None
                                     else keys[mask]).size


def test_state_round_trip():
    rng = np.random.default_rng(5)
    keys = rng.integers(0, 500, 200).astype(np.int32)
    jt, *_ = jc.clht_insert(jc.clht_init(32), jnp.asarray(keys),
                            jnp.asarray(keys * 3))
    tt, _, _ = state.from_jax_arrays(table=jfields(jt), device="cpu")
    assert_same_table(jt, tt)
    # the port's state is a copy: updating it leaves the arrays alone
    src = jfields(jt)
    tc.clht_insert(tt, torch.tensor([10**6], dtype=torch.int32),
                   torch.tensor([1], dtype=torch.int32))
    np.testing.assert_array_equal(src["keys"], np.asarray(jt.keys))
