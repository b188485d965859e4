"""The port's losses (every family's ``loss_fn`` through ``Model.loss``,
``layers.cross_entropy`` and ``chunked_cross_entropy``) and their
gradients against the JAX package's ``jax.value_and_grad(model.loss)``,
with the reference's weights carried across by ``state.params_from_jax``
and the gradients brought back to the reference's stacked layout by
``state.params_to_numpy``.

Tolerances. With f32 weights (bf16-representable values, both encdec
modules' ``PARAM_DTYPE`` set to f32) the loss agrees within 1e-5 and
every leaf's gradient within 1e-4 of that leaf's max |g| (measured here:
at most 2.0e-5, on mamba's ``a_log``). With bf16 weights XLA and torch
round the activations one unit apart in places, so the loss is held
within 1e-3 of itself (measured: at most 1.3e-4) and the gradients are
not held.

On the CPU the kernels' wrappers run their plain versions inside the same
autograd functions the card runs (``FlashAttention``, ``SSDScan``), so
these tests also hold the functions' backward: a recompute of the plain
version under autograd. The remat, the optimizer step and the train step
are in tests/test_torch_train_step.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch_train_cases as cases  # noqa: E402
from repro.configs import ARCHS  # noqa: E402
from repro.models import layers as jl  # noqa: E402
from repro_torch import optim  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.models import layers  # noqa: E402
from repro_torch.models.model_zoo import build_model, make_batch  # noqa: E402

GRAD_TOL, F32_LOSS_TOL = cases.GRAD_TOL, cases.F32_LOSS_TOL
BF16_LOSS_RTOL = 1e-3
FAMILY_ARCHS, B, f32 = cases.FAMILY_ARCHS, cases.B, cases.f32
loss_and_grads = cases.loss_and_grads


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_gradients_match_reference_in_f32(arch, monkeypatch):
    """Every leaf's gradient, the shared block's of zamba2 summed over its
    sites and the MoE's through the capacity dispatch included."""
    (jl, jm, jg), (tl, tm, tg) = loss_and_grads(arch, monkeypatch)
    assert tl.dtype == torch.float32 and tl.shape == ()
    assert abs(float(tl) - float(jl)) <= F32_LOSS_TOL
    assert sorted(tm) == sorted(jm)
    for k in jm:
        np.testing.assert_allclose(f32(tm[k]), f32(jm[k]), atol=F32_LOSS_TOL,
                                   rtol=F32_LOSS_TOL)
    gap, where = cases.worst_leaf_gap(tg, jg)
    assert gap <= GRAD_TOL, (where, gap)


@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_loss_matches_reference(arch, monkeypatch):
    (jl, _, _), (tl, _, tg) = loss_and_grads(arch, monkeypatch,
                                             f32_weights=False)
    assert tl.dtype == torch.float32
    np.testing.assert_allclose(float(tl), float(jl), rtol=BF16_LOSS_RTOL)
    assert all(np.isfinite(v).all() for v in cases.jax_leaves(tg).values())


@pytest.mark.parametrize("arch", ARCHS)
def test_arch_smoke_train_step(arch):
    """tests/test_models.py:19's twin on the port's own weights: one
    loss on the CPU, of shape () and finite, and gradients finite and not
    all zero."""
    cfg = get_smoke_config(arch)
    m = build_model(cfg)
    params = m.init(0, device="cpu")
    batch = make_batch(cfg, 2, 16, device="cpu")
    loss, metrics = m.loss(params, batch)
    assert loss.shape == () and bool(torch.isfinite(loss))
    assert float(metrics["loss"]) == float(loss)
    _, _, grads = steps.value_and_grad(params, batch, cfg)
    gn = sum(float(g.abs().sum()) for _, g in optim.adamw.leaves(grads))
    assert np.isfinite(gn) and gn > 0


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
@pytest.mark.parametrize("case", ["chunked", "ragged", "mask"])
def test_chunked_and_masked_losses_match_reference(arch, case, monkeypatch):
    """Each family's loss_fn down each branch, against the reference's:
    the chunked loss (S 32, chunk 8) equals the dense one (the twin of
    tests/test_models.py:109); at S 30 the chunk does not divide S, and
    both fall back to the dense loss without the mask; with loss_chunk 0
    the dense loss reads the mask."""
    s, chunk, mask = {"chunked": (32, 8, False), "ragged": (30, 8, True),
                      "mask": (32, 0, True)}[case]
    (jl, _, jg), (tl, _, tg) = loss_and_grads(
        arch, monkeypatch, s=s, mask=mask, loss_chunk=chunk)
    assert abs(float(tl) - float(jl)) <= F32_LOSS_TOL
    gap, where = cases.worst_leaf_gap(tg, jg)
    assert gap <= GRAD_TOL, (where, gap)
    cfg = get_smoke_config(arch)
    _, _, _, tp = cases.carried(arch, f32=True)
    _, tb = cases.batch(cfg, B, s, 3, mask=mask)
    dense = build_model(cfg.replace(loss_chunk=0))
    unmasked = {k: v for k, v in tb.items() if k != "mask"}
    want = dense.loss(tp, tb if case == "mask" else unmasked)[0]
    got = build_model(cfg.replace(loss_chunk=chunk)).loss(tp, tb)[0]
    np.testing.assert_allclose(float(got), float(want), rtol=2e-6)
    if case == "mask":
        assert abs(float(got) - float(dense.loss(tp, unmasked)[0])) > 1e-4


def test_cross_entropy_matches_reference_with_an_empty_mask():
    """The masked mean divides by max(mask.sum(), 1): an all-zero mask
    gives 0, not NaN, in both."""
    rng = np.random.default_rng(0)
    logits = rng.standard_normal((2, 5, 11)).astype(np.float32)
    labels = rng.integers(0, 11, (2, 5)).astype(np.int32)
    for mask in (np.zeros((2, 5), np.float32),
                 (rng.random((2, 5)) < 0.5).astype(np.float32), None):
        want = jl.cross_entropy(jnp.asarray(logits), jnp.asarray(labels),
                                None if mask is None else jnp.asarray(mask))
        got = layers.cross_entropy(
            torch.from_numpy(logits), torch.from_numpy(labels),
            None if mask is None else torch.from_numpy(mask))
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6,
                                   atol=1e-7)
