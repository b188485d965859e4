"""The port's attention kernels' plain versions against the JAX package's
Pallas kernels (interpret mode) on the same inputs: flash_attention (and
the model-layout ``attention``) at the sweep shapes of test_kernels.py,
causal only where Sq == Sk, paged_decode_attention at its sweep shapes,
and the ownership split/merge invariance.

Tolerances: in f32 both sides compute the same f32 softmax in another
order of sums, so 3e-5 (flash) and 2e-5 (paged decode), as
test_kernels.py holds each kernel to its oracle. In bf16 the inputs are
the same bf16 values and both compute in f32, but the flash output is
rounded to bf16 (one unit in the last place is 2^-8 relative), so
2.5e-2 / 3e-2, the tolerances of test_kernels.py for bf16.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import decode_attention as jd  # noqa: E402
from repro.kernels import flash_attention as jf  # noqa: E402
from repro_torch.kernels import decode_attention as td  # noqa: E402
from repro_torch.kernels import flash_attention as tf  # noqa: E402

FLASH_SHAPES = [
    (1, 4, 4, 64, 64, 32, True, "float32"),
    (2, 8, 2, 128, 128, 64, True, "bfloat16"),
    (1, 4, 1, 32, 128, 32, False, "float32"),
    (1, 2, 2, 256, 256, 16, True, "float32"),
    # head dim 128 (llama3.2-3b and four more configs), GQA group 3
    (1, 6, 2, 64, 64, 128, True, "bfloat16"),
    (2, 3, 1, 96, 96, 128, True, "float32"),
    (1, 6, 2, 32, 96, 128, False, "bfloat16"),
    (1, 3, 1, 64, 32, 128, False, "float32"),
]
DECODE_SHAPES = [
    (2, 8, 2, 32, 16, 12, 4, "float32"),
    (1, 4, 4, 64, 8, 20, 6, "float32"),
    (2, 4, 2, 16, 16, 8, 2, "bfloat16"),
    (2, 6, 2, 128, 8, 12, 4, "float32"),
]


def both(a: np.ndarray, dtype: str):
    """The same values as a JAX array and a torch tensor of ``dtype``."""
    j = jnp.asarray(a, getattr(jnp, dtype))
    t = torch.from_numpy(np.array(j, np.float32)).to(getattr(torch, dtype))
    return j, t


def f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


@pytest.mark.parametrize("b,h,kh,sq,sk,d,causal,dtype", FLASH_SHAPES)
def test_flash_attention_matches_reference(b, h, kh, sq, sk, d, causal,
                                           dtype):
    rng = np.random.default_rng(sq + d)
    qj, qt = both(rng.standard_normal((b, h, sq, d)), dtype)
    kj, kt = both(rng.standard_normal((b, kh, sk, d)), dtype)
    vj, vt = both(rng.standard_normal((b, kh, sk, d)), dtype)
    want = f32(jf.flash_attention(qj, kj, vj, causal=causal, bq=32, bk=32))
    tol = 2.5e-2 if dtype == "bfloat16" else 3e-5
    ref = tf.mha_ref(qt, kt, vt, causal=causal)
    got = tf.flash_attention(qt, kt, vt, causal=causal)
    assert got.dtype == qt.dtype and got.shape == qt.shape
    np.testing.assert_allclose(f32(ref), want, atol=tol, rtol=tol)
    np.testing.assert_allclose(f32(got), want, atol=tol, rtol=tol)
    # the model-layout op: (B, S, H, D) in and out
    got = tf.attention(qt.transpose(1, 2), kt.transpose(1, 2),
                       vt.transpose(1, 2), causal=causal)
    np.testing.assert_allclose(f32(got.transpose(1, 2)), want, atol=tol,
                               rtol=tol)


def test_flash_attention_refuses_causal_with_unequal_lengths():
    q = torch.zeros((1, 2, 8, 16))
    k = torch.zeros((1, 2, 16, 16))
    with pytest.raises(ValueError, match="Sq == Sk"):
        tf.flash_attention(q, k, k, causal=True)
    assert tf.flash_attention(q, k, k, causal=False).shape == q.shape


def decode_inputs(rng, b, h, kh, d, ps, npages, p, dtype):
    q = both(rng.standard_normal((b, h, d)), dtype)
    kp = both(rng.standard_normal((npages, ps, kh, d)), dtype)
    vp = both(rng.standard_normal((npages, ps, kh, d)), dtype)
    pt = np.full((b, p), -1, np.int32)
    pos = np.zeros((b, p), np.int32)
    lens = np.zeros((b,), np.int32)
    for bi in range(b):
        used = rng.integers(1, p + 1)
        pt[bi, :used] = rng.choice(npages, used, replace=False)
        pos[bi, :used] = np.arange(used) * ps
        lens[bi] = (used - 1) * ps + rng.integers(1, ps + 1)
    return q, kp, vp, pt, pos, lens


@pytest.mark.parametrize("b,h,kh,d,ps,npages,p,dtype", DECODE_SHAPES)
def test_paged_decode_matches_reference(b, h, kh, d, ps, npages, p, dtype):
    rng = np.random.default_rng(npages + d)
    q, kp, vp, pt, pos, lens = decode_inputs(rng, b, h, kh, d, ps, npages,
                                             p, dtype)
    want = jd.paged_decode_attention(q[0], kp[0], vp[0], jnp.asarray(pt),
                                     jnp.asarray(pos), jnp.asarray(lens))
    tables = [torch.from_numpy(x) for x in (pt, pos, lens)]
    tol = 3e-2 if dtype == "bfloat16" else 2e-5
    for got in (td.paged_decode_ref(q[1], kp[1], vp[1], *tables),
                td.paged_decode_attention(q[1], kp[1], vp[1], *tables)):
        for g, w in zip(got, want):
            assert g.dtype == torch.float32
            np.testing.assert_allclose(f32(g), f32(w), atol=tol, rtol=tol)
    np.testing.assert_allclose(
        f32(td.paged_decode(q[1], kp[1], vp[1], *tables)),
        f32(jd.paged_decode(q[0], kp[0], vp[0], jnp.asarray(pt),
                            jnp.asarray(pos), jnp.asarray(lens),
                            use_kernel=False)), atol=tol, rtol=tol)


def test_paged_decode_empty_sequence_partials():
    """A sequence with no valid slot gives m = -1e30, l = 0, acc = 0 on
    both planes (a page id -1 and a page past the length)."""
    rng = np.random.default_rng(5)
    q, kp, vp, _, _, _ = decode_inputs(rng, 2, 4, 2, 16, 8, 6, 3, "float32")
    pt = np.array([[-1, -1, -1], [2, 3, -1]], np.int32)
    pos = np.array([[0, 8, 16], [8, 16, 0]], np.int32)
    lens = np.array([5, 8], np.int32)
    want = jd.paged_decode_attention(q[0], kp[0], vp[0], jnp.asarray(pt),
                                     jnp.asarray(pos), jnp.asarray(lens))
    got = td.paged_decode_attention(q[1], kp[1], vp[1],
                                    *(torch.from_numpy(x)
                                      for x in (pt, pos, lens)))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(f32(g), f32(w))
    assert float(got[1].max()) == np.float32(-1e30)
    assert float(got[2].abs().max()) == 0


@pytest.mark.parametrize("nsplit", [2, 3])
def test_ownership_split_merge_invariance(nsplit):
    """Any partition of the pages across owners merges to the one-owner
    output, on the port as on the reference (2e-5: f32 merges)."""
    b, h, kh, d, ps, npages, p = 2, 4, 2, 16, 8, 16, 6
    rng = np.random.default_rng(nsplit)
    q = both(rng.standard_normal((b, h, d)), "float32")
    kp = both(rng.standard_normal((npages, ps, kh, d)), "float32")
    vp = both(rng.standard_normal((npages, ps, kh, d)), "float32")
    pt = np.array([[0, 1, 2, 3, 4, 5], [6, 7, 8, -1, -1, -1]], np.int32)
    pos = np.array([[0, 8, 16, 24, 32, 40], [0, 8, 16, 0, 0, 0]], np.int32)
    lens = np.array([44, 20], np.int32)
    pos_t, lens_t = torch.from_numpy(pos), torch.from_numpy(lens)
    whole = td.normalize(*td.paged_decode_ref(q[1], kp[1], vp[1],
                                              torch.from_numpy(pt), pos_t,
                                              lens_t))
    jparts, tparts = [], []
    for s in range(nsplit):
        pts = np.where((np.arange(p) % nsplit == s)[None, :], pt, -1)
        jparts.append(jd.paged_decode_attention(
            q[0], kp[0], vp[0], jnp.asarray(pts), jnp.asarray(pos),
            jnp.asarray(lens)))
        tparts.append(td.paged_decode_partial(
            q[1], kp[1], vp[1], torch.from_numpy(pts), pos_t, lens_t))
    merged = td.normalize(*td.merge_partials(tparts))
    np.testing.assert_allclose(f32(merged), f32(whole), atol=2e-5,
                               rtol=2e-5)
    np.testing.assert_allclose(
        f32(merged), f32(jd.normalize(*jd.merge_partials(jparts))),
        atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("page_size", [1, 4, 8, 16, 24, 64, 100])
def test_split_count_covers_every_slot_once(page_size):
    """The kernel's split of a row's slots, for every shape on a grid:
    the runs cover every slot exactly once, in order; none is shorter
    than one tile of tokens unless it is the only run; there are no
    more runs than tiles; and rows that already fill two waves of the
    SMs are not split."""
    for blocks in (1, 2, 3, 16, 48, 100, 131, 263, 264, 265, 1024, 4096):
        for slots in (0, 1, 2, 7, 8, 9, 41, 63, 64, 65, 256, 512, 4097):
            n = td.split_count(blocks, slots, page_size)
            bounds = td.split_bounds(n, slots)
            assert n >= 1 and bounds[0] == 0 and bounds[-1] == slots
            sizes = np.diff(bounds)
            assert (sizes >= 0).all() and sizes.sum() == slots
            if n > 1:
                assert (sizes * page_size >= td.TILE).all(), \
                    (blocks, slots, page_size, n)
            tiles = -(-slots * page_size // td.TILE)
            assert n <= max(1, tiles)
            if blocks >= 2 * td.H100_SMS:
                assert n == 1
            if blocks < 2 * td.H100_SMS and slots * page_size >= \
                    2 * td.TILE * 2 * td.H100_SMS:
                assert n > 1      # a long row on an idle card is split


@pytest.mark.parametrize("group,block", [(1, 1), (2, 2), (3, 1), (6, 2),
                                         (8, 8), (12, 4), (16, 8)])
def test_head_block_divides_the_group(group, block):
    assert td.head_block(group) == block
