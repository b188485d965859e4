"""Shared cases of the port's training tests (tests/test_torch_train.py,
tests/test_torch_optim.py): a smoke config's weights drawn by the JAX
package and carried to the port, batches from a numpy seed, and the
comparison of two trees in the reference's layout, in values or, for
checkpoints, in bits."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.checkpoint.ckpt import _leaf_paths as jax_leaf_paths
from repro.configs import get_smoke_config as jax_smoke
from repro.models import build_model as jax_build
from repro.models import encdec as je
from repro_torch import state
from repro_torch.checkpoint.ckpt import _leaf_paths
from repro_torch.configs import get_smoke_config
from repro_torch.launch import steps
from repro_torch.models import encdec as te

# f32 weights: the loss within F32_LOSS_TOL, every leaf's gradient within
# GRAD_TOL of that leaf's max |g|
GRAD_TOL = 1e-4
F32_LOSS_TOL = 1e-5
B, S = 2, 16
# one arch of each family that has its own loss_fn
FAMILY_ARCHS = ["qwen1_5_0_5b", "olmoe_1b_7b", "mamba2_2_7b", "zamba2_1_2b",
                "seamless_m4t_medium"]


def f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def as_f32(tree):
    """A tree of tensors (dicts and lists) with every leaf in f32."""
    if isinstance(tree, dict):
        return {k: as_f32(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [as_f32(v) for v in tree]
    return tree.float()


def f32_param_dtype(monkeypatch):
    """Both encdec modules' PARAM_DTYPE set to f32: the reference's encoder
    casts the frames to it, and its scan cannot carry bf16 frames into
    f32 layers."""
    monkeypatch.setattr(je, "PARAM_DTYPE", jnp.float32)
    monkeypatch.setattr(te, "PARAM_DTYPE", torch.float32)


def carried(arch, seed=7, f32=False, **replace):
    """(reference cfg, port cfg, reference params, port params on the
    CPU): the reference's weights of ``arch``'s smoke config, every norm
    moved off 1 and every bias off 0 so that it matters, carried by
    ``params_from_jax``. With
    ``f32`` both sides hold the same bf16-representable values in f32."""
    jcfg = jax_smoke(arch).replace(**replace)
    cfg = get_smoke_config(arch).replace(**replace)
    params = jax_build(jcfg).init(jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed)

    def jitter(path, x):
        name = getattr(path[-1], "key", "")
        if name.startswith("ln") or name == "norm_w":
            x = x * jnp.asarray(1 + 0.2 * rng.standard_normal(x.shape),
                                x.dtype)
        elif name in ("bq", "bk", "bv", "conv_b"):
            x = x + jnp.asarray(0.05 * rng.standard_normal(x.shape), x.dtype)
        return x

    params = jax.tree_util.tree_map_with_path(jitter, params)
    host = jax.tree.map(lambda x: np.asarray(x, np.float32), params)
    tp = state.params_from_jax(host, cfg, device="cpu")
    # the values the port holds, back in the reference's tree and types
    back = state.params_to_numpy(tp, cfg)
    params = jax.tree.map(lambda ref, v: jnp.asarray(v, ref.dtype), params,
                          back)
    if f32:
        params = jax.tree.map(lambda x: x.astype(jnp.float32), params)
        tp = as_f32(tp)
    return jcfg, cfg, params, tp


def batch(cfg, b, s, seed, mask=False):
    """(reference batch, port batch): tokens from a numpy seed, labels
    rolled left by one as ``make_batch``'s, frames for the encoder
    families, and a 0/1 mask when asked for."""
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    out = {"tokens": tokens, "labels": np.roll(tokens, -1, axis=1)}
    if cfg.encoder_layers:
        out["frames"] = (rng.standard_normal((b, s, cfg.d_model))
                         * 0.02).astype(np.float32)
    if mask:
        out["mask"] = (rng.random((b, s)) < 0.7).astype(np.float32)
    jb = {k: jnp.asarray(v) for k, v in out.items()}
    tb = {k: torch.from_numpy(v) for k, v in out.items()}
    return jb, tb


def jax_leaves(tree):
    """{path string: float32 numpy array} of a reference-layout tree."""
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    return {jax.tree_util.keystr(p): np.asarray(x, np.float32)
            for p, x in flat}


def worst_leaf_gap(got, want):
    """max over leaves of max |got - want| / max |want| for two
    reference-layout trees (numpy or JAX leaves), and the leaf where it
    falls; raises if their paths or shapes differ."""
    g, w = jax_leaves(got), jax_leaves(want)
    assert sorted(g) == sorted(w), (sorted(set(g) ^ set(w)))
    worst, where = 0.0, None
    for k in w:
        assert g[k].shape == w[k].shape, (k, g[k].shape, w[k].shape)
        scale = float(np.abs(w[k]).max())
        gap = float(np.abs(g[k] - w[k]).max()) / (scale or 1.0)
        if gap > worst:
            worst, where = gap, k
    return worst, where


def loss_and_grads(arch, monkeypatch, f32_weights=True, seed=3, s=S,
                   mask=False, **replace):
    """The reference's and the port's (loss, metrics, gradients) of one
    batch of ``arch``'s smoke config (``replace``d), the gradients in the
    reference's layout."""
    jcfg, cfg, jp, tp = carried(arch, f32=f32_weights, **replace)
    if f32_weights:
        f32_param_dtype(monkeypatch)
    jb, tb = batch(cfg, B, s, seed, mask=mask)
    (jl, jm), jg = jax.value_and_grad(jax_build(jcfg).loss,
                                      has_aux=True)(jp, jb)
    tl, tm, tg = steps.value_and_grad(tp, tb, cfg)
    return (jl, jm, jg), (tl, tm, state.params_to_numpy(tg, cfg))


# the reference's and torch's names of the dtypes stored as their bits
BITS = {"bfloat16": np.int16, "float8_e4m3fn": np.uint8,
        "float8_e5m2": np.uint8}


def bits(x) -> tuple[str, np.ndarray]:
    """(logical dtype name, the raw bits as a numpy array) of a torch
    tensor or a reference (numpy / JAX) array."""
    if isinstance(x, torch.Tensor):
        name = str(x.dtype).removeprefix("torch.")
        if name in BITS:
            x = x.view(torch.int16 if name == "bfloat16" else torch.uint8)
        return name, x.detach().cpu().numpy().view(
            BITS.get(name, x.detach().cpu().numpy().dtype))
    a = np.asarray(x)
    return str(a.dtype), a.view(BITS.get(str(a.dtype), a.dtype))


def assert_same_bits(ours, ref):
    """Two trees (the port's torch tree, the reference's) leaf for leaf,
    named as the store names them, equal in dtype, shape and bits."""
    a, b = dict(_leaf_paths(ours)), dict(jax_leaf_paths(ref))
    assert sorted(a) == sorted(b)
    for name in b:
        (na, xa), (nb, xb) = bits(a[name]), bits(b[name])
        assert na == nb, (name, na, nb)
        assert xa.shape == xb.shape and np.array_equal(xa, xb), name
