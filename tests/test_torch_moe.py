"""The port's MoE feed-forward (``models/moe.py:moe_ff``) against the JAX
package's single-partition path (``repro.models.moe._moe_ff_ref``) on the
same weights, carried across by ``state.params_from_jax``, and the same
bf16 inputs: olmoe's and granite-moe's smoke configs, at capacity factors
that drop choices (0.5), that drop none (8.0), and the default 1.25, also
at T = 1 and T = 4, where the capacity is 1 (at T = 1 a token's k choices
go to k experts, so nothing drops).

Tolerances: the routing is f32 on the same bf16 inputs, so the experts
chosen are the same and ``expert_load`` (counts over T*k) is exact; the
aux losses are f32 reductions, 1e-5. The output runs the experts' bf16
products and a bf16 scatter-add, rounded in other places by XLA and
torch: 2e-2, the bar of one bf16 layer in tests/test_torch_model.py.
"""

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke_config as jax_smoke  # noqa: E402
from repro.models import moe as jm  # noqa: E402
from repro_torch import state  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.models import moe as tm  # noqa: E402

ARCHS = ["olmoe-1b-7b", "granite-moe-1b-a400m"]
# (capacity factor, B, S): None is the config's 1.25
CASES = [(None, 2, 8), (0.5, 2, 8), (8.0, 2, 8), (None, 1, 1),
         (None, 4, 1), (8.0, 4, 1), (0.5, 3, 5)]


def carried(arch, seed):
    """The reference's moe_init weights and the port's copy of them,
    through params_from_jax as a one-layer MoE tree."""
    jcfg = jax_smoke(arch)
    cfg = get_smoke_config(arch)
    jp = jm.moe_init(jax.random.PRNGKey(seed), jcfg)
    host = {"layers": {"moe": {k: np.asarray(v, np.float32)[None]
                               for k, v in jp.items()}},
            "embed": np.zeros((1, 1), np.float32)}
    tp = state.params_from_jax(host, cfg.replace(num_layers=1),
                               device="cpu")["layers"][0]["moe"]
    return jcfg, cfg, jp, tp


def inputs(shape, seed):
    a = np.random.default_rng(seed).standard_normal(shape)
    j = jnp.asarray(a, jnp.bfloat16)
    return j, torch.from_numpy(np.array(j, np.float32)).to(torch.bfloat16)


def f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def dropped(load, t, k, capacity):
    counts = np.rint(f32(load) * t * k).astype(np.int64)
    return int(np.maximum(counts - capacity, 0).sum())


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("cf,b,s", CASES)
def test_moe_ff_matches_reference(arch, cf, b, s):
    jcfg, cfg, jp, tp = carried(arch, 3)
    xj, xt = inputs((b, s, cfg.d_model), b * 100 + s)
    want, waux = jm._moe_ff_ref(jp, xj, jcfg,
                                cf if cf is not None
                                else jcfg.moe_capacity_factor)
    got, aux = tm.moe_ff(tp, xt, cfg, cf)
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == (b, s,
                                                                cfg.d_model)
    np.testing.assert_allclose(f32(got), f32(want), atol=2e-2, rtol=2e-2)
    np.testing.assert_array_equal(f32(aux["expert_load"]),
                                  f32(waux["expert_load"]))
    for name in ("load_balance", "router_z"):
        assert aux[name].dtype == torch.float32
        np.testing.assert_allclose(f32(aux[name]), f32(waux[name]),
                                   atol=1e-5, rtol=1e-5)
    # the capacity of the reference, and whether choices were dropped
    t, k, e = b * s, cfg.experts_per_token, cfg.num_experts
    capacity = max(int(t * k / e * (cf or cfg.moe_capacity_factor)), 1)
    lost = dropped(aux["expert_load"], t, k, capacity)
    if cf == 8.0:
        assert lost == 0
    if cf == 0.5:
        assert lost > 0


def test_dropped_choices_add_nothing():
    """With every choice dropped but the first of each expert, a token
    whose choices all fell past the capacity gets a zero output: the
    gather back weights a dropped choice by 0, on both packages."""
    jcfg, cfg, jp, tp = carried("olmoe-1b-7b", 5)
    xj, xt = inputs((1, 16, cfg.d_model), 9)
    got, aux = tm.moe_ff(tp, xt, cfg, 1e-3)          # capacity 1
    want, _ = jm._moe_ff_ref(jp, xj, jcfg, 1e-3)
    np.testing.assert_allclose(f32(got), f32(want), atol=2e-2, rtol=2e-2)
    zero_rows = (f32(got[0]) == 0).all(axis=1)
    assert zero_rows.sum() == (f32(want[0]) == 0).all(axis=1).sum() > 0


def test_moe_init_layout():
    cfg = get_smoke_config("olmoe-1b-7b")
    gen = torch.Generator().manual_seed(0)
    p = tm.moe_init(gen, cfg)
    d, ff, e = cfg.d_model, cfg.d_ff, cfg.num_experts
    assert p["router"].dtype == torch.float32
    assert tuple(p["router"].shape) == (d, e)
    for name, shape in (("wi", (e, d, ff)), ("wg", (e, d, ff)),
                        ("wo", (e, ff, d))):
        assert p[name].dtype == torch.bfloat16
        assert tuple(p[name].shape) == shape
    jp = jm.moe_init(jax.random.PRNGKey(0), jax_smoke("olmoe-1b-7b"))
    assert {k: tuple(v.shape) for k, v in jp.items()} == \
        {k: tuple(v.shape) for k, v in p.items()}
    assert {k: str(v.dtype) for k, v in jp.items()} == \
        {"router": "float32", "wi": "bfloat16", "wg": "bfloat16",
         "wo": "bfloat16"}
