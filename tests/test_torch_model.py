"""The port's dense transformer against the JAX package's, with the JAX
weights carried across by ``state.params_from_jax`` (SMOKE_CONFIG of
qwen1.5-0.5b: 2 layers, d_model 64, 4 heads, QKV bias, SwiGLU).

Both sides run bf16 weights and activations with the same casts, so the
layers agree up to bf16 rounding of the same values: XLA and torch may
round a product or a transcendental one unit in the last place apart
(2^-8 relative), which one more bf16 op can carry on. Single layers are
held to 2e-2 and the whole model's logits to 5e-2, the bar
tests/test_serve_equivalence.py sets for two paths of one model.
"""

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke_config as jax_smoke  # noqa: E402
from repro.models import layers as jl  # noqa: E402
from repro.models import transformer as jt  # noqa: E402
from repro_torch import state  # noqa: E402
from repro_torch.configs import get_config, get_smoke_config  # noqa: E402
from repro_torch.models import layers as tl  # noqa: E402
from repro_torch.models import transformer as tt  # noqa: E402
from repro_torch.models.model_zoo import build_model  # noqa: E402

ARCH = "qwen1.5-0.5b"
CFG = get_smoke_config(ARCH)
JCFG = jax_smoke(ARCH)


@pytest.fixture(scope="module")
def weights():
    params = jt.init_params(jax.random.PRNGKey(7), JCFG)
    # the QKV biases start at zero; make them matter
    rng = np.random.default_rng(7)
    attn = params["layers"]["attn"]
    for name in ("bq", "bk", "bv"):
        attn[name] = jnp.asarray(rng.standard_normal(attn[name].shape) * 0.1,
                                 jnp.bfloat16)
    host = jax.tree.map(lambda x: np.asarray(x, np.float32), params)
    return params, state.params_from_jax(host, CFG, device="cpu")


def f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def activations(shape, seed):
    a = np.random.default_rng(seed).standard_normal(shape)
    j = jnp.asarray(a, jnp.bfloat16)
    return j, torch.from_numpy(np.array(j, np.float32)).to(torch.bfloat16)


def tokens(b, s, seed):
    t = np.random.default_rng(seed).integers(0, CFG.vocab_size, (b, s))
    return jnp.asarray(t, jnp.int32), torch.from_numpy(t.astype(np.int64))


def test_configs_match_reference():
    from repro.configs import get_config as jax_full
    for ours, theirs in ((CFG, JCFG), (get_config(ARCH), jax_full(ARCH))):
        assert ours.__dict__ == theirs.__dict__
        assert ours.hd == theirs.hd
        assert ours.param_count() == theirs.param_count()
    assert CFG.replace(num_layers=3).num_layers == 3
    assert get_config("zamba2-1.2b").family == "hybrid"
    with pytest.raises(KeyError):
        get_config("no-such-arch")


def test_params_from_jax_layout(weights):
    params, tp = weights
    assert len(tp["layers"]) == CFG.num_layers
    for li in range(CFG.num_layers):
        for name in ("wq", "bk", "wo"):
            np.testing.assert_array_equal(
                f32(tp["layers"][li]["attn"][name]),
                f32(params["layers"]["attn"][name][li]))
    assert tp["head"].shape == (CFG.d_model, CFG.vocab_size)
    assert all(t.dtype == torch.bfloat16 for t in
               (tp["embed"], tp["ln_f"], tp["layers"][0]["mlp"]["wg"]))
    # the raw bits of bf16 as uint16 give the same tensor
    bits = {"embed": np.asarray(params["embed"]).view(np.uint16),
            "ln_f": np.asarray(params["ln_f"]).view(np.uint16),
            "layers": jax.tree.map(lambda x: np.asarray(x).view(np.uint16),
                                   params["layers"])}
    tb = state.params_from_jax(bits, CFG, device="cpu")
    assert torch.equal(tb["embed"], tp["embed"])
    with pytest.raises(ValueError, match="deep"):
        state.params_from_jax(bits, CFG.replace(num_layers=3), device="cpu")


def test_rmsnorm_and_rope(weights):
    xj, xt = activations((2, 5, CFG.d_model), 1)
    w = weights[0]["layers"]["ln1"][0]
    np.testing.assert_allclose(
        f32(tl.rmsnorm(weights[1]["layers"][0]["ln1"], xt, CFG.norm_eps)),
        f32(jl.rmsnorm(w, xj, JCFG.norm_eps)), atol=2e-2, rtol=2e-2)
    qj, qt = activations((2, 5, CFG.num_heads, CFG.hd), 2)
    pos = np.array([[0, 1, 2, 3, 4], [7, 9, 11, 300, 4095]], np.int32)
    np.testing.assert_allclose(
        f32(tl.apply_rope(qt, torch.from_numpy(pos), CFG.rope_theta)),
        f32(jl.apply_rope(qj, jnp.asarray(pos), JCFG.rope_theta)),
        atol=2e-2, rtol=2e-2)


def test_qkv_proj_and_mlp(weights):
    params, tp = weights
    jp = jax.tree.map(lambda t: t[1], params["layers"])
    lp = tp["layers"][1]
    xj, xt = activations((2, 6, CFG.d_model), 3)
    pos = np.broadcast_to(np.arange(6, dtype=np.int32), (2, 6))
    got = tl.qkv_proj(lp["attn"], xt, CFG, torch.from_numpy(pos.copy()))
    want = jl.qkv_proj(jp["attn"], xj, JCFG, jnp.asarray(pos))
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape and g.dtype == torch.bfloat16
        np.testing.assert_allclose(f32(g), f32(w), atol=2e-2, rtol=2e-2)
    np.testing.assert_allclose(f32(tl.mlp(lp["mlp"], xt, CFG)),
                               f32(jl.mlp(jp["mlp"], xj, JCFG)),
                               atol=2e-2, rtol=2e-2)


def test_forward_matches_reference(weights):
    params, tp = weights
    tj, tt_ = tokens(2, 16, 4)
    want, _ = jt.forward(params, tj, JCFG)
    got = build_model(CFG).forward(tp, {"tokens": tt_})
    assert got.dtype == torch.float32
    assert tuple(got.shape) == (2, 16, CFG.vocab_size)
    np.testing.assert_allclose(f32(got), f32(want), atol=5e-2, rtol=5e-2)
    _, aux = tt.forward(tp, tt_, CFG)
    assert float(aux["load_balance"]) == 0.0


def test_prefill_matches_reference(weights):
    params, tp = weights
    tj, tt_ = tokens(2, 24, 5)
    want, wkv = jt.prefill(params, tj, JCFG)
    got, kv = build_model(CFG).prefill(tp, tt_)
    assert tuple(got.shape) == (2, CFG.vocab_size)
    np.testing.assert_allclose(f32(got), f32(want), atol=5e-2, rtol=5e-2)
    for name in ("k", "v"):
        assert tuple(kv[name].shape) == wkv[name].shape
        assert kv[name].dtype == torch.bfloat16
        np.testing.assert_allclose(f32(kv[name]), f32(wkv[name]), atol=5e-2,
                                   rtol=5e-2)
    # the last position of forward's logits is prefill's
    full = tt.forward(tp, tt_, CFG)[0][:, -1]
    np.testing.assert_allclose(f32(got), f32(full), atol=1e-5, rtol=1e-5)


def test_other_families_name_their_roadmap_item():
    """build_model takes every family; the transformer refuses the others,
    naming the module that runs each."""
    for family, module in (("hybrid", "zamba2"), ("encdec", "encdec")):
        assert build_model(CFG.replace(family=family)).cfg.family == family
        with pytest.raises(NotImplementedError, match=f"models/{module}.py"):
            tt.init_params(0, CFG.replace(family=family), device="cpu")
    with pytest.raises(NotImplementedError, match="models/ssm_lm.py"):
        tt.init_params(0, CFG.replace(family="ssm"), device="cpu")
