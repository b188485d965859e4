"""The long-sequence attention paths of the port (above 2048 keys, in
blocks of 1024) against the reference's: ``blocked_mha`` and
``blocked_mha_heads`` against ``blocked_mha_jnp`` and
``blocked_mha_heads`` (GQA, causal and not, f32 and bf16, at 4096 keys),
``attention`` on the CPU against the reference's
``attention(use_kernel=False)``, and ``FlashAttention``'s gradients
against ``jax.grad`` of ``blocked_mha_jnp``; the dispatch rule of
``plain_attention`` (ops.py:48-63 of the reference), on CPU and meta
tensors, under the head-sharding toggle. The card's kernel at the two new
main-path views is held to ``blocked_mha`` in tests/test_torch_cuda.py.

Tolerances: f32 3e-5 (test_perf_variants.py:54's, the same f32 online
softmax in another order of sums); bf16 2.5e-2, test_kernels.py's for
bf16 (the output is rounded to bf16 once, and P to bf16 for P.V on both
sides); gradients in f32 within 1e-5 of each input's max |g|.
"""

import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels.flash_attention import ops as jops  # noqa: E402
from repro.kernels.flash_attention import ref as jref  # noqa: E402
from repro_torch.distributed.act_sharding import \
    activation_sharding  # noqa: E402
from repro_torch.kernels import flash_attention as tf  # noqa: E402
from repro_torch.kernels.flash_attention import ops as tops  # noqa: E402
from repro_torch.kernels.flash_attention import ref as tref  # noqa: E402
from repro_torch.launch.mesh import make_production_mesh  # noqa: E402

# the module (the package's attribute of that name is the function)
fa_mod = importlib.import_module(
    "repro_torch.kernels.flash_attention.flash_attention")
TOL = {"float32": 3e-5, "bfloat16": 2.5e-2}
GRAD_TOL = 1e-5


def both(a: np.ndarray, dtype: str):
    """The same values as a JAX array and a torch tensor of ``dtype``."""
    j = jnp.asarray(a, getattr(jnp, dtype))
    t = torch.from_numpy(np.array(j, np.float32)).to(getattr(torch, dtype))
    return j, t


def f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def qkv(seed, b, h, kh, sq, sk, d, dtype):
    g = np.random.default_rng(seed)
    return [both(g.standard_normal(shape).astype(np.float32), dtype)
            for shape in ((b, h, sq, d), (b, kh, sk, d), (b, kh, sk, d))]


def test_blocked_mha_heads_matches_ref():
    """The twin of tests/test_perf_variants.py:54: 64 queries over 2048
    keys (the causal mask on the last 64 positions), against mha_ref, in
    both packages."""
    (jq, q), (jk, k), (jv, v) = qkv(9, 1, 8, 2, 64, 2048, 32, "float32")
    for causal in (True, False):
        a = tref.blocked_mha_heads(q, k, v, causal=causal, bk=1024)
        b = tref.mha_ref(q, k, v, causal=causal)
        np.testing.assert_allclose(f32(a), f32(b), atol=3e-5, rtol=3e-5)
        ref = jref.blocked_mha_heads(jq, jk, jv, causal=causal, bk=1024)
        np.testing.assert_allclose(f32(a), f32(ref), atol=3e-5, rtol=3e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal,sq", [(True, 4096), (False, 256)])
@pytest.mark.parametrize("heads", [False, True])
def test_blocked_versions_match_the_reference_at_4096_keys(heads, causal, sq,
                                                           dtype):
    (jq, q), (jk, k), (jv, v) = qkv(3, 1, 4, 2, sq, 4096, 32, dtype)
    if heads:
        got = tref.blocked_mha_heads(q, k, v, causal=causal)
        ref = jref.blocked_mha_heads(jq, jk, jv, causal=causal)
    else:
        got = tref.blocked_mha(q, k, v, causal=causal)
        ref = jref.blocked_mha_jnp(jq, jk, jv, causal=causal)
    assert got.dtype == q.dtype and tuple(got.shape) == tuple(ref.shape)
    np.testing.assert_allclose(f32(got), f32(ref), atol=TOL[dtype],
                               rtol=TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_attention_on_cpu_at_4096_keys_matches_the_reference(dtype):
    """The model-layout op, (B, S, H, D), causal."""
    g = np.random.default_rng(5)
    shapes = ((1, 4096, 4, 32), (1, 4096, 2, 32), (1, 4096, 2, 32))
    (jq, q), (jk, k), (jv, v) = [
        both(g.standard_normal(s).astype(np.float32), dtype) for s in shapes]
    got = tf.attention(q, k, v, causal=True)
    ref = jops.attention(jq, jk, jv, causal=True, use_kernel=False)
    np.testing.assert_allclose(f32(got), f32(ref), atol=TOL[dtype],
                               rtol=TOL[dtype])


def test_flash_attention_gradients_at_4096_keys_match_the_reference():
    """FlashAttention's backward recomputes blocked_mha above 2048 keys:
    its gradients against jax.grad of blocked_mha_jnp, f32, GQA, causal,
    for a random cotangent."""
    (jq, q), (jk, k), (jv, v) = qkv(11, 1, 4, 2, 4096, 4096, 16, "float32")
    g = np.random.default_rng(12).standard_normal(q.shape).astype(np.float32)
    ins = [t.clone().requires_grad_() for t in (q, k, v)]
    out = tf.flash_attention(*ins, causal=True)
    got = torch.autograd.grad(out, ins, torch.from_numpy(g))
    ref = jax.grad(lambda a, b, c: jnp.sum(
        jref.blocked_mha_jnp(a, b, c, causal=True) * g),
        argnums=(0, 1, 2))(jq, jk, jv)
    for name, x, y in zip("qkv", got, ref):
        scale = float(np.abs(f32(y)).max())
        gap = float(np.abs(f32(x) - f32(y)).max()) / scale
        assert gap <= GRAD_TOL, (name, gap)


def test_plain_attention_follows_the_reference_rule(monkeypatch):
    """Dense up to 2048 keys and where Sk is not a multiple of 1024, the
    blocked version above; the heads-major one only under the toggle with
    an active head-sharding policy. On meta tensors too, at 32768 keys."""
    calls = []
    for name in ("mha_ref", "blocked_mha", "blocked_mha_heads"):
        real = getattr(fa_mod, name)
        monkeypatch.setattr(fa_mod, name,
                            lambda *a, _r=real, _n=name, **k:
                            calls.append(_n) or _r(*a, **k))

    def path(sk, device="cpu", h=4):
        calls.clear()
        q = torch.zeros((1, h, 8, 16), device=device)
        k = torch.zeros((1, 2, sk, 16), device=device)
        out = tf.plain_attention(q, k, k, False)
        assert tuple(out.shape) == tuple(q.shape)
        return calls[-1]

    assert path(2048) == "mha_ref"
    assert path(3072) == "blocked_mha"
    assert path(3000) == "mha_ref"
    assert path(32768, "meta") == "blocked_mha"
    mesh = make_production_mesh()
    with activation_sharding(mesh, ("data",), "model"):
        assert path(4096, h=16) == "blocked_mha"
    monkeypatch.setattr(fa_mod, "HEAD_SHARDED_ATTENTION", False)
    tops.set_head_sharded_attention(True)
    assert path(4096, h=16) == "blocked_mha"         # no policy
    with activation_sharding(mesh, ("data",), "model"):
        assert path(4096, h=16) == "blocked_mha_heads"
        assert path(4096, h=4) == "blocked_mha"      # 4 % 16 != 0
        assert path(2048, h=16) == "mha_ref"


def test_on_meta_the_attention_op_computes_shapes_only():
    q = torch.empty((1, 32768, 16, 64), dtype=torch.bfloat16, device="meta")
    k = torch.empty((1, 32768, 16, 64), dtype=torch.bfloat16, device="meta")
    out = tf.attention(q, k, k, causal=True)
    assert out.device.type == "meta" and out.shape == q.shape
    assert out.dtype == torch.bfloat16
