"""The port's optimizer (``repro_torch/optim``: AdamW, its schedule, the
gradient compression) and the state it carries
(``state.opt_state_from_jax``, ``params_to_numpy``, ``reference_ndim``)
against the JAX package's ``repro/optim``.

One ``apply_updates`` from carried parameters, gradients and a carried
mid-training state (step 7, moments drawn from a seed) is held to the
reference's in f32: the parameters and the moments within 1e-6 of each
leaf's largest value (the two round the same f32 arithmetic in a
different order in places), 1e-5 where the gradients are clipped by their
global norm (whose sums of squares the two add in another order), the step
exactly. The compression functions
are held exactly.
"""

import jax
import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import repro.optim as jopt  # noqa: E402
import torch_train_cases as cases  # noqa: E402
from repro_torch import optim, state  # noqa: E402
from repro_torch.optim.adamw import leaves, tree_map  # noqa: E402

UPDATE_TOL = 1e-6
CLIPPED_UPDATE_TOL = 1e-5


# ---------------------------------------------------------------------------
# twins of tests/test_models.py:146, :160 and :175
# ---------------------------------------------------------------------------
def test_adamw_optimizes_quadratic():
    cfg = optim.AdamWConfig(lr=0.1, warmup_steps=1, total_steps=100,
                            weight_decay=0.0)
    params = {"w": torch.ones((4,)) * 5.0}
    st_ = optim.init_state(params)
    for _ in range(60):
        g = {"w": 2 * params["w"]}
        params, st_, _ = optim.apply_updates(params, g, st_, cfg)
    assert float(params["w"].abs().max()) < 0.5
    assert int(st_["step"]) == 60


@given(st.integers(0, 10**6))
@settings(max_examples=15, deadline=None)
def test_int8_error_feedback_converges(seed):
    """With error feedback, the sum of applied compressed gradients tracks
    the sum of true gradients."""
    rng = np.random.default_rng(seed)
    g_true = torch.from_numpy(rng.standard_normal(128).astype(np.float32))
    res = torch.zeros_like(g_true)
    applied = torch.zeros_like(g_true)
    for _ in range(8):
        g_hat, res = optim.compressed_grad(g_true, res, "int8")
        applied = applied + g_hat
    assert float((applied + res - 8 * g_true).abs().max()) < 1e-3


def test_schedule_warmup_and_decay():
    cfg = optim.AdamWConfig(lr=1.0, warmup_steps=10, total_steps=100)
    assert float(optim.schedule(cfg, 5)) == pytest.approx(0.5)
    assert float(optim.schedule(cfg, torch.tensor(10, dtype=torch.int32))) \
        == pytest.approx(1.0)
    assert float(optim.schedule(cfg, 100)) == pytest.approx(
        cfg.min_lr_ratio, abs=1e-3)


@pytest.mark.parametrize("warmup,total", [(10, 100), (0, 50), (1, 1),
                                          (100, 10_000)])
def test_schedule_matches_reference(warmup, total):
    jcfg = jopt.AdamWConfig(lr=3e-4, warmup_steps=warmup, total_steps=total)
    cfg = optim.AdamWConfig(lr=3e-4, warmup_steps=warmup, total_steps=total)
    for step in (0, 1, 2, warmup - 1, warmup, warmup + 1, total // 2, total,
                 total + 7):
        want = float(jopt.schedule(jcfg, jnp.int32(step)))
        got = optim.schedule(cfg, torch.tensor(step, dtype=torch.int32))
        assert got.dtype == torch.float32
        assert float(got) == pytest.approx(want, rel=1e-6, abs=1e-12), step


# ---------------------------------------------------------------------------
# the compression, exactly
# ---------------------------------------------------------------------------
def grad_cases():
    rng = np.random.default_rng(21)
    tied = np.repeat(rng.standard_normal(8), 16).astype(np.float32)
    return {"normal": rng.standard_normal((37, 11)).astype(np.float32),
            "ties": tied.reshape(8, 16),
            "zeros": np.zeros((5, 3), np.float32),
            "one": np.array([-2.5], np.float32),
            "halves": (np.arange(-64, 64) / 2 * 127 / 32).astype(
                np.float32)}


@pytest.mark.parametrize("name", list(grad_cases()))
def test_compress_int8_matches_reference(name):
    g = grad_cases()[name]
    jq, js = jopt.adamw.compress_int8(jnp.asarray(g))
    q, s = optim.compress_int8(torch.from_numpy(g))
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    assert float(s) == float(js)
    np.testing.assert_array_equal(
        optim.decompress_int8(q, s).numpy(),
        np.asarray(jopt.adamw.decompress_int8(jq, js)))


@pytest.mark.parametrize("name", list(grad_cases()))
@pytest.mark.parametrize("frac", [0.05, 0.3, 1e-9])
def test_topk_sparsify_matches_reference(name, frac):
    """Ties at the threshold are all kept, as ``>=`` keeps them."""
    g = grad_cases()[name]
    jk, jr = jopt.adamw.topk_sparsify(jnp.asarray(g), frac)
    k, r = optim.topk_sparsify(torch.from_numpy(g), frac)
    np.testing.assert_array_equal(k.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(r.numpy(), np.asarray(jr))
    if name == "ties" and frac == 0.05:
        assert int((k != 0).sum()) == 16        # one whole tied group


@pytest.mark.parametrize("mode", ["int8", "topk", "none"])
def test_compressed_grad_matches_reference(mode):
    rng = np.random.default_rng(5)
    g = rng.standard_normal((64, 9)).astype(np.float32)
    res = (rng.standard_normal((64, 9)) * 1e-2).astype(np.float32)
    jg, jres = jnp.asarray(g), jnp.asarray(res)
    tg, tres = torch.from_numpy(g), torch.from_numpy(res)
    for _ in range(3):
        jh, jres = jopt.compressed_grad(jg, jres, mode, 0.1)
        th, tres = optim.compressed_grad(tg, tres, mode, 0.1)
        np.testing.assert_array_equal(th.numpy(), np.asarray(jh))
        np.testing.assert_array_equal(tres.numpy(), np.asarray(jres))


# ---------------------------------------------------------------------------
# the state and one update, against the reference
# ---------------------------------------------------------------------------
def test_init_state_and_global_norm():
    _, cfg, jp, tp = cases.carried("qwen1_5_0_5b", f32=True)
    st_ = optim.init_state(tp)
    assert st_["step"].dtype == torch.int32 and int(st_["step"]) == 0
    for tree in (st_["mu"], st_["nu"]):
        got = state.params_to_numpy(tree, cfg)
        for k, v in cases.jax_leaves(got).items():
            assert v.dtype == np.float32 and not v.any(), k
        assert [p for p, _ in leaves(tree)] == [p for p, _ in leaves(tp)]
    want = float(jopt.global_norm(jp))
    assert float(optim.global_norm(tp)) == pytest.approx(want, rel=1e-5)


def test_init_state_stays_on_the_params_device():
    """init_state makes no device of its own: meta params give meta
    moments (and the card's, the card's)."""
    params = {"layers": [{"w": torch.zeros((3, 2), device="meta")}],
              "b": torch.zeros((2,), dtype=torch.bfloat16, device="meta")}
    st_ = optim.init_state(params)
    for _, t in leaves(st_):
        assert t.device.type == "meta"
    assert st_["mu"]["b"].dtype == torch.float32


def test_reference_ndim_counts_the_stack():
    t1, t2 = torch.zeros(4), torch.zeros(4, 4)
    assert state.reference_ndim(("layers", 0, "ln1"), t1) == 2
    assert state.reference_ndim(("enc_layers", 3, "mlp", "wi"), t2) == 3
    assert state.reference_ndim(("dec_layers", 1, "lnx"), t1) == 2
    assert state.reference_ndim(("layers", 2, "mamba", "a_log"), t1) == 2
    assert state.reference_ndim(("ln_f",), t1) == 1
    assert state.reference_ndim(("shared", "ln1"), t1) == 1
    assert state.reference_ndim(("shared", "attn", "wq"), t2) == 2
    assert state.reference_ndim(("w",), t1) == 1


@pytest.mark.parametrize("arch", ["qwen1_5_0_5b", "zamba2_1_2b",
                                  "seamless_m4t_medium", "olmoe_1b_7b"])
def test_params_round_trip_and_opt_state_carry(arch):
    _, cfg, jp, tp = cases.carried(arch)
    back = state.params_to_numpy(tp, cfg)
    want = cases.jax_leaves(jp)
    got = cases.jax_leaves(back)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    again = state.params_from_jax(back, cfg, device="cpu")
    for (p, a), (_, b) in zip(leaves(again), leaves(tp), strict=True):
        assert a.dtype == b.dtype and torch.equal(a, b), p
    rng = np.random.default_rng(2)
    jst = {"mu": jax.tree.map(lambda x: rng.standard_normal(x.shape)
                              .astype(np.float32), jp),
           "nu": jax.tree.map(lambda x: rng.random(x.shape)
                              .astype(np.float32), jp),
           "step": np.int32(7)}
    ts = state.opt_state_from_jax(jst, cfg, device="cpu")
    assert ts["step"].dtype == torch.int32 and int(ts["step"]) == 7
    for name in ("mu", "nu"):
        got = cases.jax_leaves(state.params_to_numpy(ts[name], cfg))
        for k, v in cases.jax_leaves(jst[name]).items():
            np.testing.assert_array_equal(got[k], v, err_msg=k)


def mid_training(arch, seed=3):
    """(reference cfg, port cfg, reference params, grads and state, port
    params, grads and state): f32 params; bf16-representable gradients; a
    state at step 7 with moments from a seed; carried to the port."""
    jcfg, cfg, jp, tp = cases.carried(arch, f32=True)
    rng = np.random.default_rng(seed)

    def draw(x, scale=1.0, positive=False):
        a = rng.random(x.shape) if positive else rng.standard_normal(x.shape)
        return jnp.asarray((a * scale).astype(np.float32))

    jg = jax.tree.map(lambda x: draw(x, 1e-2).astype(jnp.bfloat16)
                      .astype(jnp.float32), jp)
    js = {"mu": jax.tree.map(lambda x: draw(x, 1e-3), jp),
          "nu": jax.tree.map(lambda x: draw(x, 1e-5, True), jp),
          "step": jnp.int32(7)}
    host = lambda tree: jax.tree.map(lambda x: np.asarray(x, np.float32),
                                     tree)
    tg = cases.as_f32(state.params_from_jax(host(jg), cfg, device="cpu"))
    ts = state.opt_state_from_jax(host(js), cfg, device="cpu")
    return jcfg, cfg, (jp, jg, js), (tp, tg, ts)


@pytest.mark.parametrize("arch", ["qwen1_5_0_5b", "zamba2_1_2b",
                                  "seamless_m4t_medium"])
@pytest.mark.parametrize("clip", [1.0, 1e9])
def test_apply_updates_matches_reference_mid_training(arch, clip):
    """Clipped (the gradients' norm is about 4) and not: the clip scales
    every gradient by 1 / norm, which carries the norm's 1.3e-6 into the
    update."""
    _, cfg, (jp, jg, js), (tp, tg, ts) = mid_training(arch)
    o = dict(lr=1e-2, warmup_steps=3, total_steps=50, grad_clip=clip)
    jcfg_opt, cfg_opt = jopt.AdamWConfig(**o), optim.AdamWConfig(**o)
    tol = UPDATE_TOL if clip > 1 else CLIPPED_UPDATE_TOL
    jp2, js2, jm = jopt.apply_updates(jp, jg, js, jcfg_opt)
    tp2, ts2, tm = optim.apply_updates(tp, tg, ts, cfg_opt)
    assert tp2 is tp and ts2 is ts            # updated in place
    # the norm's sums of squares run in another order: 1.3e-6 apart
    assert float(tm["grad_norm"]) == pytest.approx(float(jm["grad_norm"]),
                                                   rel=1e-5)
    assert float(tm["lr"]) == pytest.approx(float(jm["lr"]), rel=1e-6)
    assert int(ts2["step"]) == int(js2["step"]) == 8
    for got, want in ((tp2, jp2), (ts2["mu"], js2["mu"]),
                      (ts2["nu"], js2["nu"])):
        gap, where = cases.worst_leaf_gap(state.params_to_numpy(got, cfg),
                                          want)
        assert gap <= tol, (where, gap)


@pytest.mark.parametrize("arch", ["qwen1_5_0_5b", "zamba2_1_2b"])
def test_weight_decay_follows_the_reference_rank(arch):
    """With zero gradients and moments only the decay moves a parameter:
    a stacked layer's norms, biases and mamba's (H,) leaves decay (they
    are (L, d) in the reference), ``ln_f`` and zamba2's unstacked
    ``shared`` norms do not; and the port moves exactly the leaves the
    reference moves."""
    jcfg, cfg, jp, tp = cases.carried(arch, f32=True)
    zeros = lambda tree: jax.tree.map(jnp.zeros_like, tree)
    js = {"mu": zeros(jp), "nu": zeros(jp), "step": jnp.int32(0)}
    o = dict(lr=0.5, warmup_steps=1, weight_decay=0.1)
    jp2, _, _ = jopt.apply_updates(jp, zeros(jp), js, jopt.AdamWConfig(**o))
    before = cases.jax_leaves(state.params_to_numpy(tp, cfg))
    tp2, _, _ = optim.apply_updates(tp, tree_map(torch.zeros_like, tp),
                                    optim.init_state(tp),
                                    optim.AdamWConfig(**o))
    after = cases.jax_leaves(state.params_to_numpy(tp2, cfg))
    want = cases.jax_leaves(jp2)
    moved = {k for k in before if not np.array_equal(after[k], before[k])}
    assert moved == {k for k in before
                     if not np.array_equal(want[k], before[k])}
    decayed = ["['layers']['ln1']", "['layers']['attn']['bq']"] \
        if arch == "qwen1_5_0_5b" else \
        ["['layers']['ln']", "['layers']['mamba']['a_log']",
         "['layers']['mamba']['d_skip']", "['layers']['mamba']['norm_w']"]
    kept = ["['ln_f']"] + (["['shared']['ln1']", "['shared']['ln2']"]
                           if arch == "zamba2_1_2b" else [])
    for k in decayed:
        assert k in moved, k
        np.testing.assert_allclose(after[k], before[k] * (1 - 0.5 * 0.1),
                                   rtol=1e-6, err_msg=k)
    for k in kept:
        assert k not in moved, k
