"""The port's hybrid family (models/zamba2.py, through model_zoo.py and
launch/steps.py) against the JAX package's, with the JAX weights carried
across by ``state.params_from_jax``: zamba2-1.2b's smoke config (5 mamba
layers, the shared block after every 2: two groups and one tail layer),
the same with 4 layers (two groups, no tail) and with ``attn_every`` 0
(one group of all the layers).

Tolerances, as tests/test_torch_families.py and tests/test_torch_ssm.py:
with bf16 weights XLA and torch round the same values one unit in the
last place apart in places, so the model's logits agree within 5e-2;
with f32 weights and activations on both sides within 1e-4. Decode
against the reference's decode step within 5e-2 a step, and against the
port's own forward within tests/test_models.py's 2e-2.
"""

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_full  # noqa: E402
from repro.configs import get_smoke_config as jax_smoke  # noqa: E402
from repro.models import zamba2 as jz  # noqa: E402
from repro.models.layers import unembed as j_unembed  # noqa: E402
from repro_torch import state  # noqa: E402
from repro_torch.configs import get_config, get_smoke_config  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.models import ssm_lm as ts  # noqa: E402
from repro_torch.models import zamba2 as tz  # noqa: E402
from repro_torch.models.model_zoo import (build_model,  # noqa: E402
                                          make_batch)

ARCH = "zamba2-1.2b"
# smoke: 2 groups + 1 tail; no tail: 4 layers, every 2; one group
VARIANTS = {"smoke": {}, "no_tail": {"num_layers": 4},
            "one_group": {"num_layers": 3, "attn_every": 0}}
SEQ = 16


def configs(variant):
    kw = VARIANTS[variant]
    return jax_smoke(ARCH).replace(**kw), get_smoke_config(ARCH).replace(**kw)


def f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def as_f32(tree):
    if isinstance(tree, dict):
        return {k: as_f32(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [as_f32(v) for v in tree]
    return tree.float()


@pytest.fixture(scope="module", params=list(VARIANTS))
def carried(request):
    jcfg, cfg = configs(request.param)
    params = jz.init_params(jax.random.PRNGKey(11), jcfg)
    # the conv bias, dt bias and skip start at 0, 0 and 1; the shared
    # block's norms at 1: make them matter
    rng = np.random.default_rng(11)
    mp = params["layers"]["mamba"]
    for name, dtype, scale in (("conv_b", jnp.bfloat16, 0.1),
                               ("dt_bias", jnp.float32, 0.5),
                               ("d_skip", jnp.float32, 0.5)):
        mp[name] = jnp.asarray(1.0 * (name == "d_skip") + scale
                               * rng.standard_normal(mp[name].shape), dtype)
    for name in ("ln1", "ln2"):
        sp = params["shared"]
        sp[name] = jnp.asarray(1 + 0.2 * rng.standard_normal(sp[name].shape),
                               jnp.bfloat16)
    host = jax.tree.map(lambda x: np.asarray(x, np.float32), params)
    return jcfg, cfg, params, state.params_from_jax(host, cfg, device="cpu")


def tokens(cfg, b, s, seed):
    t = np.random.default_rng(seed).integers(0, cfg.vocab_size, (b, s))
    return jnp.asarray(t, jnp.int32), torch.from_numpy(t)


def test_configs_match_reference():
    for ours, theirs in ((get_smoke_config(ARCH), jax_smoke(ARCH)),
                         (get_config(ARCH), jax_full(ARCH))):
        assert ours.__dict__ == theirs.__dict__
        assert (ours.hd, ours.ssm_heads, ours.d_inner) == \
            (theirs.hd, theirs.ssm_heads, theirs.d_inner)
        assert ours.param_count() == theirs.param_count()


@pytest.mark.parametrize("variant", list(VARIANTS) + ["full"])
def test_group_shape_matches_reference(variant):
    if variant == "full":
        jcfg, cfg = jax_full(ARCH), get_config(ARCH)
    else:
        jcfg, cfg = configs(variant)
    assert tz._group_shape(cfg) == jz._group_shape(jcfg)
    every, groups, tail = tz._group_shape(cfg)
    sites = [tz._site_after(cfg, li) for li in range(cfg.num_layers)]
    assert [s for s in sites if s is not None] == list(range(groups))
    assert sites[cfg.num_layers - tail:] == [None] * tail
    if variant == "full":
        assert (every, groups, tail) == (6, 6, 2)


def test_param_count_at_full_width():
    """The full-width parameters' sizes against the analytic count (which
    leaves out norms and the conv bias), built as fake tensors: nothing is
    allocated. About 1.2 B parameters, the shared block one set."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    cfg = get_config(ARCH)
    with FakeTensorMode():
        params = tz.init_params(0, cfg, device="cpu")
    skip = {"ln", "ln1", "ln2", "ln_f", "norm_w", "conv_b"}

    def count(node, name=None):
        if isinstance(node, dict):
            return sum(count(v, k) for k, v in node.items())
        if isinstance(node, list):
            return sum(count(v) for v in node)
        return 0 if name in skip else node.numel()

    assert count(params) == cfg.param_count()
    assert round(cfg.param_count() / 1e9, 1) == 1.2
    assert len(params["layers"]) == 38
    assert tuple(params["shared"]["attn"]["wq"].shape) == (2048, 32 * 64)
    assert tuple(params["shared"]["mlp"]["wi"].shape) == (2048, 8192)
    assert tuple(params["head"].shape) == (2048, 32000)
    mp = params["layers"][0]["mamba"]
    assert tuple(mp["in_proj"].shape) == (2048, 2 * 4096 + 2 * 64 + 64)
    assert mp["a_log"].dtype == torch.float32


def test_params_from_jax_carries_the_shared_block_once(carried):
    jcfg, cfg, params, tp = carried
    assert isinstance(tp["shared"], dict) and len(tp["layers"]) == \
        cfg.num_layers
    for path, leaf in (("attn", "wq"), ("attn", "wo"), ("mlp", "wg")):
        got = tp["shared"][path][leaf]
        assert got.dtype == torch.bfloat16
        np.testing.assert_array_equal(f32(got),
                                      f32(params["shared"][path][leaf]))
    np.testing.assert_array_equal(f32(tp["shared"]["ln1"]),
                                  f32(params["shared"]["ln1"]))
    for li in range(cfg.num_layers):
        mp = tp["layers"][li]["mamba"]
        assert mp["a_log"].dtype == torch.float32
        np.testing.assert_array_equal(
            mp["d_skip"].numpy(), np.asarray(params["layers"]["mamba"]
                                             ["d_skip"][li]))
    assert tuple(tp["head"].shape) == (cfg.d_model, cfg.vocab_size)
    # the port's own init makes the same layout and types
    own = tz.init_params(0, cfg, device="cpu")

    def shapes(t):
        return {k: (tuple(v.shape), v.dtype) for k, v in t.items()}

    assert shapes(own["shared"]["attn"]) == shapes(tp["shared"]["attn"])
    assert shapes(own["layers"][0]["mamba"]) == \
        shapes(tp["layers"][0]["mamba"])
    host = jax.tree.map(lambda x: np.asarray(x, np.float32), params)
    with pytest.raises(ValueError, match="deep"):
        state.params_from_jax(host, cfg.replace(num_layers=cfg.num_layers + 1),
                              device="cpu")


@pytest.mark.parametrize("dtype", ["bf16", "f32"])
def test_hidden_forward_and_prefill_step_match_reference(carried, dtype):
    jcfg, cfg, params, tp = carried
    tol = 5e-2
    if dtype == "f32":
        params = jax.tree.map(lambda x: x.astype(jnp.float32), params)
        tp, tol = as_f32(tp), 1e-4
    tj, tt = tokens(cfg, 2, SEQ, 4)
    wx = jz.hidden(params, tj, jcfg)
    x = tz.hidden(tp, tt, cfg)
    assert tuple(x.shape) == wx.shape
    np.testing.assert_allclose(f32(x), f32(wx), atol=tol, rtol=tol)
    want = jz.forward(params, tj, jcfg)[0]
    got = build_model(cfg).forward(tp, {"tokens": tt})
    assert got.dtype == torch.float32
    assert tuple(got.shape) == (2, SEQ, cfg.vocab_size)
    np.testing.assert_allclose(f32(got), f32(want), atol=tol, rtol=tol)
    # the reference's prefill step: hidden, then the last token's untied
    # unembed (launch/steps.py:117-129)
    last = steps.prefill_step(tp, tt, cfg)
    assert tuple(last.shape) == (2, cfg.vocab_size)
    np.testing.assert_allclose(
        f32(last), f32(j_unembed(params, wx[:, -1:], jcfg)[:, 0]),
        atol=tol, rtol=tol)
    np.testing.assert_allclose(f32(last), f32(got[:, -1]), atol=1e-6,
                               rtol=1e-6)


def test_init_cache_matches_reference(carried):
    jcfg, cfg, _, _ = carried
    want = jz.init_cache(jcfg, 2, 12)
    for cache in (tz.init_cache(cfg, 2, 12, device="cpu"),
                  build_model(cfg).init_cache(2, 12, device="cpu"),
                  steps.init_cache(cfg, 2, 12, "v3", device="cpu")):
        for name in ("k", "v"):
            assert tuple(cache[name].shape) == want[name].shape
            assert cache[name].dtype == torch.bfloat16
        assert len(cache["mamba"]) == cfg.num_layers
        for name in ("conv", "ssm"):
            assert tuple(cache["mamba"][0][name].shape) == \
                want["mamba"][name].shape[1:]
            assert cache["mamba"][-1][name].dtype == torch.float32


def test_decode_matches_reference_and_forward(carried):
    """8 tokens teacher-forced through serve_step from init_cache against
    the reference's decode_step (logits every step, then every layer's
    state, the tail's included, and every site's KV) and against the
    port's forward, as tests/test_models.py:49-65 runs the reference."""
    jcfg, cfg, params, tp = carried
    tj, tt = tokens(cfg, 1, 8, 6)
    full = tz.forward(tp, tt, cfg)[0]
    cache = steps.init_cache(cfg, 1, 12, device="cpu")
    jcache = jz.init_cache(jcfg, 1, 12)
    for t in range(8):
        logits, cache = steps.serve_step(tp, cache, tt[:, t], t, cfg,
                                         optimized=True)
        jlogits, jcache = jz.decode_step(params, jcache, tj[:, t], t, jcfg)
        assert tuple(logits.shape) == (1, cfg.vocab_size)
        np.testing.assert_allclose(f32(logits), f32(jlogits), atol=5e-2,
                                   rtol=5e-2)
        np.testing.assert_allclose(f32(logits[0]), f32(full[0, t]),
                                   atol=2e-2, rtol=2e-2)
    for li in range(cfg.num_layers):
        for name in ("conv", "ssm"):
            np.testing.assert_allclose(
                f32(cache["mamba"][li][name]),
                f32(jcache["mamba"][name][li]), atol=5e-2, rtol=5e-2)
    for name in ("k", "v"):
        np.testing.assert_allclose(f32(cache[name]), f32(jcache[name]),
                                   atol=5e-2, rtol=5e-2)
        assert not torch.any(cache[name][:, :, 8:])


def test_build_model_and_make_batch():
    cfg = get_smoke_config(ARCH)
    model = build_model(cfg)
    params = model.init(0, device="cpu")
    assert set(params) == {"layers", "shared", "embed", "ln_f", "head"}
    batch = make_batch(cfg, 2, 8, torch.Generator().manual_seed(1))
    assert set(batch) == {"tokens", "labels"}
    logits = model.forward(params, batch)
    assert tuple(logits.shape) == (2, 8, cfg.vocab_size)
    assert bool(torch.isfinite(logits).all())
    cache = model.init_cache(2, 8, device="cpu")
    step, cache = model.decode_step(params, cache, batch["tokens"][:, 0], 0)
    np.testing.assert_allclose(f32(step), f32(logits[:, 0]), atol=2e-2,
                               rtol=2e-2)


def test_zamba2_refuses_foreign_families_and_names_their_module():
    dense = get_smoke_config("qwen1.5-0.5b")
    with pytest.raises(NotImplementedError, match="models/transformer.py"):
        tz.init_params(0, dense, device="cpu")
    with pytest.raises(NotImplementedError, match="models/ssm_lm.py"):
        tz.init_cache(get_smoke_config("mamba2-2.7b"), 1, 4, device="cpu")
    with pytest.raises(NotImplementedError, match="models/zamba2.py"):
        ts.init_params(0, get_smoke_config(ARCH), device="cpu")
