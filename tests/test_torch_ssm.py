"""The port's SSM family (models/mamba2.py, models/ssm_lm.py,
launch/steps.py) against the JAX package's, with the JAX weights carried
across by ``state.params_from_jax`` (SMOKE_CONFIG of mamba2-2.7b: 2
layers, d_model 64, 8 SSD heads of 16, state 16, 1 group, vocab 512).

Both sides run bf16 weights and activations with the same casts (the
prefill conv in bf16, the decode conv in f32, f32 ``a_log``, ``dt_bias``
and ``d_skip``), so they agree up to bf16 rounding of the same values,
which XLA and torch may place one unit in the last place apart (2^-8
relative): one block is held to 2e-2, the whole model's logits to 5e-2
(the bar of two paths of one model, as in test_torch_model.py), and
decode against forward to test_models.py's 2e-2.
"""

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_full  # noqa: E402
from repro.configs import get_smoke_config as jax_smoke  # noqa: E402
from repro.models import mamba2 as jm  # noqa: E402
from repro.models import ssm_lm as js  # noqa: E402
from repro.models.layers import unembed as j_unembed  # noqa: E402
from repro_torch import state  # noqa: E402
from repro_torch.configs import get_config, get_smoke_config  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.models import mamba2 as tm  # noqa: E402
from repro_torch.models import ssm_lm as ts  # noqa: E402
from repro_torch.models.model_zoo import build_model  # noqa: E402

ARCH = "mamba2-2.7b"
CFG = get_smoke_config(ARCH)
JCFG = jax_smoke(ARCH)


@pytest.fixture(scope="module")
def weights():
    params = js.init_params(jax.random.PRNGKey(3), JCFG)
    # the conv bias, dt bias and skip start at 0, 0 and 1; make them matter
    rng = np.random.default_rng(3)
    mp = params["layers"]["mamba"]
    for name, dtype, scale in (("conv_b", jnp.bfloat16, 0.1),
                               ("dt_bias", jnp.float32, 0.5),
                               ("d_skip", jnp.float32, 0.5)):
        mp[name] = jnp.asarray(1.0 * (name == "d_skip") + scale
                               * rng.standard_normal(mp[name].shape), dtype)
    host = jax.tree.map(lambda x: np.asarray(x, np.float32), params)
    return params, state.params_from_jax(host, CFG, device="cpu")


def f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def tokens(b, s, seed):
    t = np.random.default_rng(seed).integers(0, CFG.vocab_size, (b, s))
    return jnp.asarray(t, jnp.int32), torch.from_numpy(t.astype(np.int64))


def test_config_matches_reference():
    for ours, theirs in ((CFG, JCFG), (get_config(ARCH), jax_full(ARCH))):
        assert ours.__dict__ == theirs.__dict__
        assert (ours.ssm_heads, ours.d_inner) == (theirs.ssm_heads,
                                                  theirs.d_inner)
        assert ours.param_count() == theirs.param_count()


def test_param_count_at_full_width():
    """The full-width parameters' sizes against the analytic count
    (which leaves out norms and the conv bias), built as fake tensors:
    nothing is allocated."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    cfg = get_config(ARCH)
    with FakeTensorMode():
        params = ts.init_params(0, cfg, device="cpu")
    skip = {"ln", "ln_f", "norm_w", "conv_b"}

    def count(node, name=None):
        if isinstance(node, dict):
            return sum(count(v, k) for k, v in node.items())
        if isinstance(node, list):
            return sum(count(v) for v in node)
        return 0 if name in skip else node.numel()

    assert count(params) == cfg.param_count()
    mp = params["layers"][0]["mamba"]
    assert tuple(mp["in_proj"].shape) == (2560, 2 * 5120 + 2 * 128 + 80)
    assert mp["a_log"].dtype == torch.float32
    assert mp["in_proj"].dtype == torch.bfloat16
    assert len(params["layers"]) == 64


def test_params_from_jax_keeps_f32_leaves(weights):
    params, tp = weights
    jmp = params["layers"]["mamba"]
    for li in range(CFG.num_layers):
        mp = tp["layers"][li]["mamba"]
        for name in ("a_log", "dt_bias", "d_skip"):
            assert mp[name].dtype == torch.float32
            np.testing.assert_array_equal(mp[name].numpy(),
                                          np.asarray(jmp[name][li]))
        for name in ("in_proj", "conv_w", "conv_b", "norm_w", "out_proj"):
            assert mp[name].dtype == torch.bfloat16
        assert tp["layers"][li]["ln"].dtype == torch.bfloat16
    # log(linspace(1, 16, h)) does not survive a round trip through bf16:
    # the earlier rule (every leaf bf16) would have changed it
    a_log = tp["layers"][0]["mamba"]["a_log"]
    assert not torch.equal(a_log.to(torch.bfloat16).float(), a_log)
    # an f32 leaf given as bf16 bits is refused, not reinterpreted
    bits = jax.tree.map(lambda x: np.asarray(x).view(np.uint16)
                        if x.dtype == jnp.bfloat16 else np.asarray(x),
                        params)
    tb = state.params_from_jax(bits, CFG, device="cpu")
    assert torch.equal(tb["layers"][1]["mamba"]["a_log"],
                       tp["layers"][1]["mamba"]["a_log"])
    assert torch.equal(tb["embed"], tp["embed"])
    bits["layers"]["mamba"]["d_skip"] = np.zeros((2, 8), np.uint16)
    with pytest.raises(TypeError, match="float32"):
        state.params_from_jax(bits, CFG, device="cpu")


def test_mamba_block_matches_reference(weights):
    params, tp = weights
    jp = jax.tree.map(lambda t: t[1], params["layers"]["mamba"])
    a = np.random.default_rng(4).standard_normal((2, 32, CFG.d_model))
    xj = jnp.asarray(a, jnp.bfloat16)
    xt = torch.from_numpy(np.array(xj, np.float32)).to(torch.bfloat16)
    for chunk in (64, 16):
        got = tm.mamba_block(tp["layers"][1]["mamba"], xt, CFG, chunk=chunk)
        want = jm.mamba_block(jp, xj, JCFG, chunk=chunk)
        assert got.dtype == torch.bfloat16 and tuple(got.shape) == want.shape
        np.testing.assert_allclose(f32(got), f32(want), atol=2e-2,
                                   rtol=2e-2)


def test_forward_and_prefill_step_match_reference(weights):
    params, tp = weights
    tj, tt = tokens(2, 48, 5)
    want, _ = js.forward(params, tj, JCFG)
    got = build_model(CFG).forward(tp, {"tokens": tt})
    assert got.dtype == torch.float32
    assert tuple(got.shape) == (2, 48, CFG.vocab_size)
    np.testing.assert_allclose(f32(got), f32(want), atol=5e-2, rtol=5e-2)
    # the reference's prefill step: hidden, then the last token's tied
    # unembed (launch/steps.py:117-129)
    x = js.hidden(params, tj, JCFG)
    want_last = j_unembed(params, x[:, -1:],
                          JCFG.replace(tie_embeddings=True))[:, 0]
    last = steps.prefill_step(tp, tt, CFG)
    assert tuple(last.shape) == (2, CFG.vocab_size)
    np.testing.assert_allclose(f32(last), f32(want_last), atol=5e-2,
                               rtol=5e-2)
    np.testing.assert_allclose(f32(last), f32(got[:, -1]), atol=1e-5,
                               rtol=1e-5)


def test_decode_matches_reference_and_forward(weights):
    """8 tokens teacher-forced through decode_step from init_cache, as
    tests/test_models.py:51-65 runs the reference."""
    params, tp = weights
    tj, tt = tokens(1, 8, 6)
    full = ts.forward(tp, tt, CFG)[0]
    model = build_model(CFG)
    cache = model.init_cache(1, 16, device="cpu")
    jcache = js.init_cache(JCFG, 1)
    assert cache["mamba"][0]["conv"].dtype == torch.float32
    for t in range(8):
        logits, cache = steps.serve_step(tp, cache, tt[:, t], t, CFG)
        jlogits, jcache = js.decode_step(params, jcache, tj[:, t], t, JCFG)
        assert tuple(logits.shape) == (1, CFG.vocab_size)
        np.testing.assert_allclose(f32(logits), f32(jlogits), atol=2e-2,
                                   rtol=2e-2)
        np.testing.assert_allclose(f32(logits[0]), f32(full[0, t]),
                                   atol=2e-2, rtol=2e-2)
    for li in range(CFG.num_layers):
        for name in ("conv", "ssm"):
            np.testing.assert_allclose(
                f32(cache["mamba"][li][name]),
                f32(jcache["mamba"][name][li]), atol=2e-2, rtol=2e-2)
    # decode_multi: the same steps in one call
    multi, _ = ts.decode_multi(tp, ts.init_cache(CFG, 1, device="cpu"), tt,
                               0, CFG)
    np.testing.assert_allclose(f32(multi[0, -1]), f32(logits[0]), atol=1e-6,
                               rtol=1e-6)


def test_bf16_decode_gap_at_full_depth_matches_the_reference():
    """Teacher-forced decode against forward at mamba2-2.7b's full depth
    (64 layers), its state size 128 and head dim 64, at d_model 256 (8
    heads), on the reference's own random weights carried across. In
    bf16 the two paths round differently by design (prefill conv in bf16,
    decode conv in f32; products over T rows against one), and at 2
    layers both models' gaps are near 1e-2. At 64 layers the reference's
    own decode parts from its forward by more than the 5e-2 bar that
    chip_smoke.py's bf16 teacher-forced check states, and the port's gap
    on the same weights and tokens is of the same size: the gap is the
    reference's, carried through depth, not the port's. Run with ``-s``
    to print the numbers."""
    bar, t_len = 5e-2, 128
    kw = {"num_layers": 64, "d_model": 256, "ssm_state": 128,
          "ssm_headdim": 64}
    jcfg, cfg = JCFG.replace(**kw), CFG.replace(**kw)
    params = js.init_params(jax.random.PRNGKey(7), jcfg)
    tp = state.params_from_jax(
        jax.tree.map(lambda x: np.asarray(x, np.float32), params), cfg,
        device="cpu")
    tj, tt = tokens(1, t_len, 8)
    jfull = f32(js.forward(params, tj, jcfg)[0][0])
    step = jax.jit(lambda p, c, x, t: js.decode_step(p, c, x, t, jcfg))
    jcache, jdec = js.init_cache(jcfg, 1), []
    for t in range(t_len):
        logits, jcache = step(params, jcache, tj[:, t], t)
        jdec.append(f32(logits[0]))
    tfull = f32(ts.forward(tp, tt, cfg)[0][0])
    cache, tdec = ts.init_cache(cfg, 1, device="cpu"), []
    for t in range(t_len):
        logits, cache = steps.serve_step(tp, cache, tt[:, t], t, cfg)
        tdec.append(f32(logits[0]))

    def gap(dec, full):
        dec = np.stack(dec)
        return (float(np.abs(dec - full).max() / np.abs(full).max()),
                float((dec.argmax(-1) == full.argmax(-1)).mean()))

    (gj, top_j), (gt, top_t) = gap(jdec, jfull), gap(tdec, tfull)
    print(f"\n64 layers, d_model 256, N 128, P 64, {t_len} tokens: "
          f"reference decode vs forward {gj:.4g} (top-1 {top_j:.4g}); "
          f"port {gt:.4g} (top-1 {top_t:.4g})")
    assert gj > bar
    assert 0.5 < gt / gj < 2.0


def test_ssm_entry_points_refuse_other_families():
    """ssm_lm refuses the other families, naming the module that runs
    each; the step functions and build_model run the hybrid and
    encoder-decoder families through their own modules."""
    dense = get_smoke_config("qwen1.5-0.5b")
    hybrid = get_smoke_config("zamba2-1.2b")
    seamless = get_smoke_config("seamless-m4t-medium")
    with pytest.raises(NotImplementedError, match="models/transformer.py"):
        ts.init_params(0, dense, device="cpu")
    with pytest.raises(NotImplementedError, match="models/zamba2.py"):
        ts.init_cache(hybrid, 1, device="cpu")
    with pytest.raises(NotImplementedError, match="models/encdec.py"):
        ts.hidden({}, torch.zeros((1, 4), dtype=torch.long), seamless)
    tok = torch.zeros((1, 4), dtype=torch.long)
    zp = build_model(hybrid).init(0, device="cpu")
    assert tuple(steps.prefill_step(zp, tok, hybrid).shape) == \
        (1, hybrid.vocab_size)
    ep = build_model(seamless).init(0, device="cpu")
    cache = steps.init_cache(seamless, 1, 4, enc_len=4, device="cpu")
    logits, _ = steps.serve_step(ep, cache, tok[:, 0], 0, seamless)
    assert tuple(logits.shape) == (1, seamless.vocab_size)
