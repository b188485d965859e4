"""The port's training step against the JAX package's: ``remat="full"``
(the same loss and gradients, each checkpointed block's kernels run again
in the backward, zamba2's shared block not checkpointed), the shared
block's gradient gathered over its sites, the MoE dispatch's gradients,
and ``launch/steps.py:train_step`` against the reference's
``build_train_step(...).fn`` on a 1 x 1 CPU mesh.

Tolerances: the f32 bars of tests/test_torch_train.py. After two AdamW
steps the metrics agree within 1e-5 and each parameter as STEP_MEAN_TOL
and STEP_MAX_TOL say.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from jax.sharding import AxisType  # noqa: E402

import torch_train_cases as cases  # noqa: E402
from repro.configs import get_smoke_config as jax_smoke  # noqa: E402
from repro.configs.base import ShapeConfig  # noqa: E402
from repro.distributed.sharding import make_rules  # noqa: E402
from repro.launch.steps import build_train_step  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.optim import AdamWConfig as JaxAdamW  # noqa: E402
from repro.optim import init_state as jax_init_state  # noqa: E402
from repro_torch import optim, state  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.models import encdec, moe, ssm_lm, transformer  # noqa: E402
from repro_torch.models import zamba2  # noqa: E402

# the wrappers' modules (each package exports its function over the name)
fa_mod = importlib.import_module(
    "repro_torch.kernels.flash_attention.flash_attention")
ssd_mod = importlib.import_module("repro_torch.kernels.ssd_scan.ssd_scan")

GRAD_TOL = cases.GRAD_TOL
B, S, f32 = cases.B, cases.S, cases.f32
FAMILY_ARCHS = cases.FAMILY_ARCHS
# |port - reference| of a parameter after two AdamW steps, in learning
# rates: the mean over the leaf, and the max. A gradient element near 0
# carries the gradients' last-place differences as a large relative error
# into Adam's normalized step, so a few elements differ by up to 2.1e-2
# of the rate (measured), while the leaf's mean stays under 1e-4 of it; a
# step without weight decay would move the mean by about 1e-2.
STEP_MEAN_TOL = 1e-3
STEP_MAX_TOL = 5e-2


class Counted:
    """Counts the forward runs of the attention and SSD kernels' wrappers
    (their ``_run``, which launches the kernel on the card)."""

    def __init__(self, monkeypatch):
        self.n = {"flash_attention": 0, "ssd_scan": 0}
        for name, mod in (("flash_attention", fa_mod), ("ssd_scan", ssd_mod)):
            real = mod._run

            def run(*args, _real=real, _name=name):
                self.n[_name] += 1
                return _real(*args)

            monkeypatch.setattr(mod, "_run", run)


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_remat_does_not_change_loss_or_grads(arch, monkeypatch):
    """The twin of tests/test_models.py:121, with the gradients: remat
    "full" against "none" on the same weights, equal; and under remat the
    backward runs each checkpointed block's kernels again (the card's
    second launch), but not zamba2's shared block, which the reference
    does not checkpoint."""
    cfg = get_smoke_config(arch)
    _, _, _, tp = cases.carried(arch, f32=True)
    _, tb = cases.batch(cfg, B, S, 5)
    out, counts = {}, {}
    for remat in ("none", "full"):
        counted = Counted(monkeypatch)
        loss, _, grads = steps.value_and_grad(tp, tb,
                                              cfg.replace(remat=remat))
        out[remat] = (float(loss), state.params_to_numpy(grads, cfg))
        counts[remat] = dict(counted.n)
    assert out["full"][0] == pytest.approx(out["none"][0], abs=1e-6)
    gap, where = cases.worst_leaf_gap(out["full"][1], out["none"][1])
    assert gap <= 1e-6, (where, gap)
    every, groups, _ = zamba2._group_shape(cfg)
    attn = {"qwen1_5_0_5b": cfg.num_layers, "olmoe_1b_7b": cfg.num_layers,
            "mamba2_2_7b": 0, "zamba2_1_2b": groups,
            "seamless_m4t_medium": cfg.encoder_layers + 2 * cfg.num_layers
            }[arch]
    scans = cfg.num_layers if cfg.family in ("ssm", "hybrid") else 0
    assert counts["none"] == {"flash_attention": attn, "ssd_scan": scans}
    shared = groups if cfg.family == "hybrid" else 0
    assert counts["full"] == {"flash_attention": 2 * attn - shared,
                              "ssd_scan": 2 * scans}


def test_zamba2_shared_block_gathers_every_site(monkeypatch):
    """The shared block's gradient is the sum of its sites': with each
    site given its own copy of the block (the same values), the copies'
    gradients differ from site to site and sum to the one block's."""
    cfg = get_smoke_config("zamba2_1_2b")
    _, _, _, tp = cases.carried("zamba2_1_2b", f32=True)
    _, tb = cases.batch(cfg, B, S, 9)
    _, groups, _ = zamba2._group_shape(cfg)
    assert groups >= 2
    full = steps.value_and_grad(tp, tb, cfg)[2]
    copies = [optim.adamw.tree_map(lambda t: t.detach().clone()
                                   .requires_grad_(), tp["shared"])
              for _ in range(groups)]
    real, site = zamba2._shared_attn, iter(copies)
    monkeypatch.setattr(zamba2, "_shared_attn",
                        lambda sp, *args: real(next(site), *args))
    loss, _ = zamba2.loss_fn(tp, tb, cfg)
    flat = [[t for _, t in optim.adamw.leaves(c)] for c in copies]
    per_site = torch.autograd.grad(loss, [t for f in flat for t in f])
    n = len(flat[0])
    for i, (_, want) in enumerate(optim.adamw.leaves(full["shared"])):
        parts = [per_site[k * n + i] for k in range(groups)]
        assert not torch.allclose(parts[0], parts[1])
        np.testing.assert_allclose(sum(parts).numpy(), want.numpy(), rtol=0,
                                   atol=1e-6 * float(want.abs().max()))


@pytest.mark.parametrize("capacity", [1.25, 8.0])
def test_moe_dispatch_gradients_match_reference(capacity):
    """moe_ff's output, aux terms and gradients (x, router, experts)
    against the reference's ``_moe_ff_ref`` in f32: with choices dropped
    at capacity 1.25 and with none dropped at 8. Top-k is held in f32
    because bf16 near-ties flip it between XLA and torch."""
    jcfg = jax_smoke("olmoe_1b_7b")
    cfg = get_smoke_config("olmoe_1b_7b")
    jp = jax.tree.map(lambda x: x.astype(jnp.float32),
                      jmoe.moe_init(jax.random.PRNGKey(4), jcfg))
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 16, cfg.d_model)).astype(np.float32)
    r = rng.standard_normal((2, 16, cfg.d_model)).astype(np.float32)

    def jloss(p, x):
        y, aux = jmoe._moe_ff_ref(p, x, jcfg, capacity)
        return jnp.sum(y * r) + aux["load_balance"] + aux["router_z"], aux

    (jv, jaux), (jgp, jgx) = jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True)(jp, jnp.asarray(x))
    tp = {k: torch.from_numpy(np.array(v)).requires_grad_()
          for k, v in jp.items()}
    tx = torch.from_numpy(x).requires_grad_()
    y, aux = moe.moe_ff(tp, tx, cfg, capacity)
    tv = (y * torch.from_numpy(r)).sum() + aux["load_balance"] \
        + aux["router_z"]
    grads = torch.autograd.grad(tv, [tx, *tp.values()])
    assert abs(float(tv.detach()) - float(jv)) <= 1e-4 * abs(float(jv))
    np.testing.assert_array_equal(f32(aux["expert_load"]),
                                  f32(jaux["expert_load"]))
    for got, want in zip(grads, [jgx, *(jgp[k] for k in tp)]):
        scale = float(np.abs(np.asarray(want)).max())
        assert float(np.abs(f32(got) - f32(want)).max()) <= GRAD_TOL * scale


def mesh_train_step(jcfg, b, s):
    mesh = jax.make_mesh((1, 1), ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2)
    return mesh, build_train_step(jcfg, ShapeConfig("t", s, b, "train"),
                                  make_rules(mesh),
                                  JaxAdamW(lr=1e-3, warmup_steps=1))


@pytest.mark.parametrize("arch", ["llama3_2_3b", "zamba2_1_2b"])
def test_train_step_matches_build_train_step(arch, monkeypatch):
    """Two steps of ``steps.train_step`` against two of the reference's
    ``build_train_step(...).fn`` on a 1 x 1 CPU mesh (remat "full" and
    loss_chunk 512, cut to S, on both), f32 weights, one batch: the
    metrics after each step and every parameter after the second, through
    ``params_to_numpy``."""
    jcfg, cfg, jp, tp = cases.carried(arch, f32=True)
    jb, tb = cases.batch(cfg, B, S, 11)
    mesh, bundle = mesh_train_step(jcfg, B, S)
    js = jax_init_state(jp)
    ts = optim.init_state(tp)
    opt = optim.AdamWConfig(lr=1e-3, warmup_steps=1)
    with mesh:
        fn = jax.jit(bundle.fn)
        for _ in range(2):
            jp, js, jm = fn(jp, js, jb)
            tp, ts, tm = steps.train_step(tp, ts, tb, cfg, opt)
            assert sorted(tm) == sorted(jm)
            for k in jm:
                np.testing.assert_allclose(f32(tm[k]), f32(jm[k]), rtol=1e-5,
                                           atol=1e-6, err_msg=k)
    assert int(ts["step"]) == int(js["step"]) == 2
    got = cases.jax_leaves(state.params_to_numpy(tp, cfg))
    want = cases.jax_leaves(jp)
    for k in want:
        gap = np.abs(got[k] - want[k]) / opt.lr
        assert gap.mean() <= STEP_MEAN_TOL and gap.max() <= STEP_MAX_TOL, \
            (k, gap.mean(), gap.max())


def test_train_step_refuses_a_foreign_family():
    cfg = get_smoke_config("qwen1_5_0_5b").replace(family="rnn")
    with pytest.raises(ValueError, match="unknown family"):
        steps.train_step({}, {}, {}, cfg)


def test_family_loss_fns_refuse_foreign_families():
    batch = {"tokens": torch.zeros((1, 4), dtype=torch.int64)}
    for mod, arch in ((transformer, "mamba2_2_7b"), (ssm_lm, "qwen1_5_0_5b"),
                      (zamba2, "qwen1_5_0_5b")):
        with pytest.raises(NotImplementedError, match="does not run it"):
            mod.loss_fn({}, {**batch, "labels": batch["tokens"]},
                        get_smoke_config(arch))
    with pytest.raises(NotImplementedError, match="does not run it"):
        encdec.loss_fn({}, {**batch, "frames": torch.zeros((1, 4, 8)),
                            "labels": batch["tokens"]},
                       get_smoke_config("qwen1_5_0_5b"))
