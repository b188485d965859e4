"""The port's configs and the MoE and VLM families of its transformer
against the JAX package's: the six configs of the MoE, VLM and D = 128
dense families, field for field with the reference's parameter counts;
``forward`` and ``prefill`` of the olmoe, granite-moe and chameleon smoke
configs with the JAX weights carried across by ``state.params_from_jax``;
the MoE layers' layout and types after the carry.

Tolerances as tests/test_torch_model.py: bf16 weights and activations
rounded in other places by XLA and torch, logits within 5e-2 and KV
within 5e-2. The MoE configs run at capacity factor 8.0, where no choice
drops, with f32 weights and activations: top-k routing is discontinuous,
and bf16 rounding differences between the packages can pick another
expert for a token whose top choices nearly tie (tests/test_torch_decode.py
says more; tests/test_torch_moe.py holds the bf16 MoE layer alone).
"""

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_full  # noqa: E402
from repro.configs import get_smoke_config as jax_smoke  # noqa: E402
from repro.models import transformer as jt  # noqa: E402
from repro_torch import state  # noqa: E402
from repro_torch.configs import (ARCHS, get_config,  # noqa: E402
                                 get_smoke_config)
from repro_torch.models import transformer as tt  # noqa: E402
from repro_torch.models.model_zoo import (build_model,  # noqa: E402
                                          make_batch)

NEW = ["llama3.2-3b", "internlm2-20b", "nemotron-4-15b", "chameleon-34b",
       "olmoe-1b-7b", "granite-moe-1b-a400m"]
FAMILY_ARCHS = ["olmoe-1b-7b", "granite-moe-1b-a400m", "chameleon-34b"]


def f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


@pytest.mark.parametrize("arch", NEW)
def test_configs_match_reference(arch):
    for ours, theirs in ((get_smoke_config(arch), jax_smoke(arch)),
                         (get_config(arch), jax_full(arch))):
        assert ours.__dict__ == theirs.__dict__
        assert ours.hd == theirs.hd
        assert ours.param_count() == theirs.param_count()
        assert ours.active_param_count() == theirs.active_param_count()


def test_head_dims_and_sizes_of_the_slice():
    """Five configs at head dim 128; llama3.2-3b about 3.61 B parameters,
    olmoe-1b-7b about 6.92 B, of which about 1.3 B active."""
    assert [a for a in NEW if get_config(a).hd == 128] == NEW[:5]
    assert get_config("granite-moe-1b-a400m").hd == 64
    assert round(get_config("llama3.2-3b").param_count() / 1e9, 2) == 3.61
    olmoe = get_config("olmoe-1b-7b")
    assert round(olmoe.param_count() / 1e9, 2) == 6.92
    assert 1.2e9 < olmoe.active_param_count() < 1.4e9
    from repro.configs import ARCHS as JARCHS
    assert set(ARCHS) == set(JARCHS)


def as_f32(tree):
    if isinstance(tree, dict):
        return {k: as_f32(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [as_f32(v) for v in tree]
    return tree.float()


@pytest.fixture(scope="module", params=FAMILY_ARCHS)
def carried(request):
    arch = request.param
    jcfg, cfg = jax_smoke(arch), get_smoke_config(arch)
    params = jt.init_params(jax.random.PRNGKey(5), jcfg)
    host = jax.tree.map(lambda x: np.asarray(x, np.float32), params)
    tp = state.params_from_jax(host, cfg, device="cpu")
    if cfg.family == "moe":
        jcfg = jcfg.replace(moe_capacity_factor=8.0)
        cfg = cfg.replace(moe_capacity_factor=8.0)
        params = jax.tree.map(lambda x: x.astype(jnp.float32), params)
        tp = as_f32(tp)
    return jcfg, cfg, params, tp


def tokens(cfg, b, s, seed):
    t = np.random.default_rng(seed).integers(0, cfg.vocab_size, (b, s))
    return jnp.asarray(t, jnp.int32), torch.from_numpy(t)


def test_forward_matches_reference(carried):
    jcfg, cfg, params, tp = carried
    tj, tt_ = tokens(cfg, 2, 16, 4)
    want, waux = jt.forward(params, tj, jcfg)
    got, aux = tt.forward(tp, tt_, cfg)
    assert got.dtype == torch.float32
    assert tuple(got.shape) == (2, 16, cfg.vocab_size)
    np.testing.assert_allclose(f32(got), f32(want), atol=5e-2, rtol=5e-2)
    np.testing.assert_allclose(
        f32(build_model(cfg).forward(tp, {"tokens": tt_})), f32(got),
        atol=0, rtol=0)
    for name in ("load_balance", "router_z"):
        np.testing.assert_allclose(f32(aux[name]), f32(waux[name]),
                                   atol=1e-4, rtol=1e-4)
    if cfg.family == "moe":
        assert float(aux["load_balance"]) > 0


def test_prefill_matches_reference(carried):
    jcfg, cfg, params, tp = carried
    tj, tt_ = tokens(cfg, 2, 24, 5)
    want, wkv = jt.prefill(params, tj, jcfg)
    got, kv = build_model(cfg).prefill(tp, tt_)
    assert tuple(got.shape) == (2, cfg.vocab_size)
    np.testing.assert_allclose(f32(got), f32(want), atol=5e-2, rtol=5e-2)
    for name in ("k", "v"):
        assert tuple(kv[name].shape) == wkv[name].shape
        assert kv[name].dtype == torch.bfloat16
        np.testing.assert_allclose(f32(kv[name]), f32(wkv[name]), atol=5e-2,
                                   rtol=5e-2)
    full = tt.forward(tp, tt_, cfg)[0][:, -1]
    np.testing.assert_allclose(f32(got), f32(full), atol=1e-5, rtol=1e-5)


def test_params_from_jax_carries_moe_layers():
    jcfg, cfg = jax_smoke("olmoe-1b-7b"), get_smoke_config("olmoe-1b-7b")
    params = jt.init_params(jax.random.PRNGKey(2), jcfg)
    host = jax.tree.map(lambda x: np.asarray(x, np.float32), params)
    tp = state.params_from_jax(host, cfg, device="cpu")
    d, ff, e = cfg.d_model, cfg.d_ff, cfg.num_experts
    assert len(tp["layers"]) == cfg.num_layers
    for li, lp in enumerate(tp["layers"]):
        assert "mlp" not in lp and set(lp["moe"]) == {"router", "wi", "wg",
                                                      "wo"}
        assert lp["moe"]["router"].dtype == torch.float32
        assert tuple(lp["moe"]["router"].shape) == (d, e)
        np.testing.assert_array_equal(
            f32(lp["moe"]["router"]),
            f32(params["layers"]["moe"]["router"][li]))
        for name, shape in (("wi", (e, d, ff)), ("wg", (e, d, ff)),
                            ("wo", (e, ff, d))):
            assert lp["moe"][name].dtype == torch.bfloat16
            assert tuple(lp["moe"][name].shape) == shape
            np.testing.assert_array_equal(
                f32(lp["moe"][name]),
                f32(params["layers"]["moe"][name][li]))
    # the port's own init makes the same layout and types
    own = tt.init_params(0, cfg, device="cpu")
    for a, b in zip(own["layers"], tp["layers"]):
        assert {k: (tuple(v.shape), v.dtype) for k, v in a["moe"].items()} \
            == {k: (tuple(v.shape), v.dtype) for k, v in b["moe"].items()}
    with pytest.raises(ValueError, match="deep"):
        state.params_from_jax(host, cfg.replace(num_layers=3), device="cpu")


def test_make_batch_takes_a_generator():
    cfg = get_smoke_config("chameleon-34b")
    a = make_batch(cfg, 2, 9, torch.Generator().manual_seed(3))
    b = make_batch(cfg, 2, 9, torch.Generator().manual_seed(3))
    assert torch.equal(a["tokens"], b["tokens"])
    assert tuple(a["tokens"].shape) == (2, 9)
    assert int(a["tokens"].max()) < cfg.vocab_size
    assert torch.equal(a["labels"], torch.roll(a["tokens"], -1, dims=1))
    c = make_batch(cfg, 1, 4, device="cpu")
    assert c["tokens"].device.type == "cpu"


@pytest.mark.parametrize("family", ["hybrid", "encdec"])
def test_waiting_families_name_their_roadmap_item(family):
    """The two families that waited for ROADMAP Queue 2 item 6 run now:
    build_model and make_batch take their configs, and the transformer
    refuses them, naming the module that runs each."""
    arch, module = {"hybrid": ("zamba2-1.2b", "zamba2"),
                    "encdec": ("seamless-m4t-medium", "encdec")}[family]
    cfg = get_smoke_config(arch)
    model = build_model(cfg)
    batch = make_batch(cfg, 1, 4, device="cpu")
    logits = model.forward(model.init(0, device="cpu"), batch)
    assert tuple(logits.shape) == (1, 4, cfg.vocab_size)
    with pytest.raises(NotImplementedError, match=f"models/{module}.py"):
        tt.init_params(0, cfg, device="cpu")
