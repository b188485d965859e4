"""The port's encoder-decoder family (models/encdec.py,
``layers.cross_attention_block``, through model_zoo.py and
launch/steps.py) against the JAX package's, with the JAX weights carried
across by ``state.params_from_jax``: seamless-m4t-medium's smoke config
(2 encoder and 2 decoder layers, d_model 64, 4 heads) and the same with 3
encoder layers, so that each stack's depth is its own. The encoder takes
12 frames and the decoder 8 tokens, so that cross-attention runs
Sq != Sk.

Tolerances, as tests/test_torch_families.py: with bf16 weights XLA and
torch round the same values one unit in the last place apart in places,
so a layer agrees within 2e-2 and the model's logits within 5e-2; with
f32 weights and activations on both sides within 1e-4. Decode against
the reference's decode step within 5e-2 a step, and against the port's
own forward within tests/test_models.py's 2e-2.

Kernel 5's bar on the main path (chip_smoke.py's attn_path_bar: rtol
2^-7, atol 2^-8 of the softmax average of |v|) is held here at the card's
views, on the plain version: it passes kernel 5's own rounding and sees a
kernel that drops the ragged last keys.
"""

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_full  # noqa: E402
from repro.configs import get_smoke_config as jax_smoke  # noqa: E402
from repro.models import encdec as je  # noqa: E402
from repro.models import layers as jl  # noqa: E402
from repro.models.layers import unembed as j_unembed  # noqa: E402
from repro_torch import state  # noqa: E402
from repro_torch.configs import get_config, get_smoke_config  # noqa: E402
from repro_torch.kernels.flash_attention import mha_ref  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.models import encdec as te  # noqa: E402
from repro_torch.models import layers as tl  # noqa: E402
from repro_torch.models import transformer as tt  # noqa: E402
from repro_torch.models.model_zoo import (build_model,  # noqa: E402
                                          make_batch)

ARCH = "seamless-m4t-medium"
VARIANTS = {"smoke": {}, "deeper_encoder": {"encoder_layers": 3}}
S_ENC, S_DEC = 12, 8


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
    return tree.float() if isinstance(tree, torch.Tensor) else tree


@pytest.fixture(scope="module", params=list(VARIANTS))
def carried(request):
    jcfg, cfg = configs(request.param)
    params = je.init_params(jax.random.PRNGKey(13), jcfg)
    # the norms start at 1: make them matter
    rng = np.random.default_rng(13)
    for stack, names in (("enc_layers", ("ln1", "ln2")),
                         ("dec_layers", ("ln1", "lnx", "ln2"))):
        for name in names:
            w = params[stack][name]
            params[stack][name] = jnp.asarray(
                1 + 0.2 * rng.standard_normal(w.shape), jnp.bfloat16)
    host = jax.tree.map(lambda x: np.asarray(x, np.float32), params)
    return jcfg, cfg, params, state.params_from_jax(host, cfg, device="cpu")


def frames(cfg, b, s, seed):
    a = np.random.default_rng(seed).standard_normal((b, s, cfg.d_model)) \
        * 0.02
    return jnp.asarray(a, jnp.float32), torch.from_numpy(a.astype(np.float32))


def tokens(cfg, b, s, seed):
    t = np.random.default_rng(seed).integers(0, cfg.vocab_size, (b, s))
    return jnp.asarray(t, jnp.int32), torch.from_numpy(t)


def test_configs_match_reference():
    for ours, theirs in ((get_smoke_config(ARCH), jax_smoke(ARCH)),
                         (get_config(ARCH), jax_full(ARCH))):
        assert ours.__dict__ == theirs.__dict__
        assert ours.hd == theirs.hd
        assert ours.param_count() == theirs.param_count()


def test_param_count_at_full_width():
    """The full-width parameters' sizes against the analytic count (which
    leaves out the norms), built as fake tensors: nothing is allocated.
    About 1.0 B parameters, 12 + 12 layers, vocab 256,206."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    cfg = get_config(ARCH)
    with FakeTensorMode():
        params = te.init_params(0, cfg, device="cpu")
    skip = {"ln1", "ln2", "lnx", "ln_enc", "ln_f"}

    def count(node, name=None):
        if isinstance(node, dict):
            return sum(count(v, k) for k, v in node.items())
        if isinstance(node, list):
            return sum(count(v) for v in node)
        return 0 if name in skip else node.numel()

    assert count(params) == cfg.param_count()
    assert round(cfg.param_count() / 1e9, 1) == 1.0
    assert (len(params["enc_layers"]), len(params["dec_layers"])) == (12, 12)
    assert tuple(params["head"].shape) == (1024, 256206)
    assert cfg.hd == 64


def test_params_from_jax_checks_each_stack_against_its_own_depth(carried):
    jcfg, cfg, params, tp = carried
    assert len(tp["enc_layers"]) == cfg.encoder_layers
    assert len(tp["dec_layers"]) == cfg.num_layers
    for li in range(cfg.num_layers):
        for part in ("self", "cross"):
            np.testing.assert_array_equal(
                f32(tp["dec_layers"][li][part]["wk"]),
                f32(params["dec_layers"][part]["wk"][li]))
    np.testing.assert_array_equal(
        f32(tp["enc_layers"][-1]["mlp"]["wo"]),
        f32(params["enc_layers"]["mlp"]["wo"][-1]))
    assert {k for k in tp if k not in ("enc_layers", "dec_layers")} == \
        {"embed", "ln_enc", "ln_f", "head"}
    # the port's own init makes the same layout and types
    own = te.init_params(0, cfg, device="cpu")
    for stack in ("enc_layers", "dec_layers"):
        assert jax.tree.map(lambda t: (tuple(t.shape), t.dtype),
                            own[stack]) == \
            jax.tree.map(lambda t: (tuple(t.shape), t.dtype), tp[stack])
    host = jax.tree.map(lambda x: np.asarray(x, np.float32), params)
    for kw in ({"encoder_layers": cfg.encoder_layers + 1},
               {"num_layers": cfg.num_layers + 1}):
        with pytest.raises(ValueError, match="deep"):
            state.params_from_jax(host, cfg.replace(**kw), device="cpu")


def test_cross_attention_block_matches_reference(carried):
    jcfg, cfg, params, tp = carried
    rng = np.random.default_rng(5)
    x, mk, mv = (rng.standard_normal(s) for s in (
        (2, S_DEC, cfg.d_model), (2, S_ENC, cfg.num_kv_heads, cfg.hd),
        (2, S_ENC, cfg.num_kv_heads, cfg.hd)))
    js = [jnp.asarray(a, jnp.bfloat16) for a in (x, mk, mv)]
    ts_ = [torch.from_numpy(np.array(a, np.float32)).to(torch.bfloat16)
           for a in js]
    jp = jax.tree.map(lambda t: t[0], params["dec_layers"]["cross"])
    want = jl.cross_attention_block(jp, *js, jcfg)
    got = tl.cross_attention_block(tp["dec_layers"][0]["cross"], *ts_, cfg)
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == want.shape
    np.testing.assert_allclose(f32(got), f32(want), atol=2e-2, rtol=2e-2)


@pytest.mark.parametrize("dtype", ["bf16", "f32"])
def test_encode_hidden_forward_and_prefill_step_match_reference(
        carried, dtype, monkeypatch):
    """In f32 both packages' encoders take the frames in f32 too: the
    reference's scan over the encoder layers cannot carry bf16 frames into
    f32 layers, so both modules' ``PARAM_DTYPE`` is set to f32 here."""
    jcfg, cfg, params, tp = carried
    tol = 5e-2
    if dtype == "f32":
        params = jax.tree.map(lambda x: x.astype(jnp.float32), params)
        tp, tol = as_f32(tp), 1e-4
        monkeypatch.setattr(je, "PARAM_DTYPE", jnp.float32)
        monkeypatch.setattr(te, "PARAM_DTYPE", torch.float32)
    fj, ft = frames(cfg, 2, S_ENC, 3)
    tj, tt_ = tokens(cfg, 2, S_DEC, 4)
    wmem = je.encode(params, fj, jcfg)
    mem = te.encode(tp, ft, cfg)
    assert tuple(mem.shape) == wmem.shape and mem.dtype == {
        "bf16": torch.bfloat16, "f32": torch.float32}[dtype]
    np.testing.assert_allclose(f32(mem), f32(wmem), atol=tol, rtol=tol)
    wx = je.hidden(params, fj, tj, jcfg)
    x = te.hidden(tp, ft, tt_, cfg)
    assert tuple(x.shape) == wx.shape == (2, S_DEC, cfg.d_model)
    np.testing.assert_allclose(f32(x), f32(wx), atol=tol, rtol=tol)
    want = je.forward(params, fj, tj, jcfg)[0]
    got = build_model(cfg).forward(tp, {"frames": ft, "tokens": tt_})
    assert got.dtype == torch.float32
    np.testing.assert_allclose(f32(got), f32(want), atol=tol, rtol=tol)
    last = steps.prefill_step(tp, tt_, cfg, frames=ft)
    assert tuple(last.shape) == (2, cfg.vocab_size)
    np.testing.assert_allclose(
        f32(last), f32(j_unembed(params, wx[:, -1:], jcfg)[:, 0]),
        atol=tol, rtol=tol)
    np.testing.assert_allclose(f32(last), f32(got[:, -1]), atol=1e-6,
                               rtol=1e-6)
    with pytest.raises(ValueError, match="frames"):
        steps.prefill_step(tp, tt_, cfg)


def test_init_cache_and_prepare_cross_match_reference(carried):
    jcfg, cfg, params, tp = carried
    want = je.init_cache(jcfg, 2, 10, S_ENC)
    for cache in (te.init_cache(cfg, 2, 10, S_ENC, device="cpu"),
                  build_model(cfg).init_cache(2, 10, S_ENC, device="cpu"),
                  steps.init_cache(cfg, 2, 10, enc_len=S_ENC, device="cpu")):
        for name in ("k", "v", "xk", "xv"):
            assert tuple(cache[name].shape) == want[name].shape
            assert cache[name].dtype == torch.bfloat16
        assert cache["enc_len"] == int(want["enc_len"])
    # the model's default memory length, as the reference's
    assert build_model(cfg).init_cache(1, 4, device="cpu")["xk"].shape[2] \
        == 1024
    fj, ft = frames(cfg, 2, S_ENC, 3)
    wmem, mem = je.encode(params, fj, jcfg), te.encode(tp, ft, cfg)
    wc = je.prepare_cross(params, wmem, jcfg, want)
    for dtype in (torch.bfloat16, torch.float32):
        cache = te.prepare_cross(
            tp, mem, cfg, te.init_cache(cfg, 2, 10, S_ENC, dtype,
                                        device="cpu"))
        for name in ("xk", "xv"):
            assert cache[name].dtype == dtype
            assert tuple(cache[name].shape) == wc[name].shape
            np.testing.assert_allclose(f32(cache[name]), f32(wc[name]),
                                       atol=5e-2, rtol=5e-2)


def test_decode_matches_reference_and_forward(carried):
    """``encode`` + ``prepare_cross``, then 8 tokens teacher-forced through
    serve_step against the reference's decode_step (logits every step,
    then the self-attention caches) and against the port's forward on the
    same frames and tokens."""
    jcfg, cfg, params, tp = carried
    fj, ft = frames(cfg, 1, S_ENC, 7)
    tj, tt_ = tokens(cfg, 1, S_DEC, 6)
    full = te.forward(tp, ft, tt_, cfg)[0]
    cache = te.prepare_cross(tp, te.encode(tp, ft, cfg), cfg,
                             steps.init_cache(cfg, 1, 10, enc_len=S_ENC,
                                              device="cpu"))
    jcache = je.prepare_cross(params, je.encode(params, fj, jcfg), jcfg,
                              je.init_cache(jcfg, 1, 10, S_ENC))
    for t in range(S_DEC):
        logits, cache = steps.serve_step(tp, cache, tt_[:, t], t, cfg,
                                         optimized=True)
        jlogits, jcache = je.decode_step(params, jcache, tj[:, t], t, jcfg)
        assert tuple(logits.shape) == (1, cfg.vocab_size)
        np.testing.assert_allclose(f32(logits), f32(jlogits), atol=5e-2,
                                   rtol=5e-2)
        np.testing.assert_allclose(f32(logits[0]), f32(full[0, t]),
                                   atol=2e-2, rtol=2e-2)
    for name in ("k", "v"):
        np.testing.assert_allclose(f32(cache[name]), f32(jcache[name]),
                                   atol=5e-2, rtol=5e-2)
        assert not torch.any(cache[name][:, :, S_DEC:])


@pytest.mark.parametrize("family", ["encdec", "audio"])
def test_build_model_and_make_batch(family):
    cfg = get_smoke_config(ARCH).replace(family=family)
    model = build_model(cfg)
    params = model.init(0, device="cpu")
    assert set(params) == {"enc_layers", "dec_layers", "embed", "ln_enc",
                           "ln_f", "head"}
    batch = make_batch(cfg, 2, 8, torch.Generator().manual_seed(1))
    assert set(batch) == {"tokens", "labels", "frames"}
    assert tuple(batch["frames"].shape) == (2, 8, cfg.d_model)
    assert batch["frames"].dtype == torch.float32
    assert 0.01 < float(batch["frames"].std()) < 0.03
    again = make_batch(cfg, 2, 8, torch.Generator().manual_seed(1))
    assert torch.equal(again["frames"], batch["frames"])
    logits = model.forward(params, batch)
    assert tuple(logits.shape) == (2, 8, cfg.vocab_size)
    assert bool(torch.isfinite(logits).all())
    cache = te.prepare_cross(params, te.encode(params, batch["frames"], cfg),
                             cfg, model.init_cache(2, 8, 8, device="cpu"))
    step, cache = model.decode_step(params, cache, batch["tokens"][:, 0], 0)
    np.testing.assert_allclose(f32(step), f32(logits[:, 0]), atol=2e-2,
                               rtol=2e-2)


def test_encdec_refuses_foreign_families_and_names_their_module():
    with pytest.raises(NotImplementedError, match="models/transformer.py"):
        te.init_params(0, get_smoke_config("qwen1.5-0.5b"), device="cpu")
    with pytest.raises(NotImplementedError, match="models/zamba2.py"):
        te.init_cache(get_smoke_config("zamba2-1.2b"), 1, 4, 4, device="cpu")
    with pytest.raises(NotImplementedError, match="models/encdec.py"):
        tt.init_params(0, get_smoke_config(ARCH), device="cpu")
    with pytest.raises(ValueError, match="frames"):
        steps.prefill_step({}, torch.zeros((1, 4), dtype=torch.long),
                           get_smoke_config("qwen1.5-0.5b"),
                           frames=torch.zeros((1, 4, 64)))


def _kernel5_rounding(q, k, v, causal):
    """mha_ref rounded as kernel 5 rounds: p = exp(s - max) to bf16 for
    P.V, l summed from the unrounded p, the output to bf16."""
    sq, sk, d = q.shape[2], k.shape[2], q.shape[3]
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * d ** -0.5
    if causal:
        mask = torch.ones((sq, sk), dtype=torch.bool).tril()
        s = s.masked_fill(~mask, -1e30)
    p = torch.exp(s - s.amax(-1, keepdim=True))
    o = torch.einsum("bhqk,bhkd->bhqd", p.bfloat16().float(), v.float())
    return (o / p.sum(-1, keepdim=True)).bfloat16()


def _outside_attention_bar(got, ref, q, k, v, causal) -> int:
    ref = ref.float()
    bar = 2 ** -8 * mha_ref(q, k, v.abs(), causal=causal).float() \
        + 2 ** -7 * ref.abs()
    return int(((got.float() - ref).abs() > bar).sum())


@pytest.mark.parametrize("h,sq,sk,d,causal", [
    (16, 256, 1500, 64, False),     # seamless's cross-attention, batch 1
    (2, 1500, 1500, 64, False),     # seamless's encoder, two heads
    (2, 2048, 2048, 64, True),      # zamba2's shared block, two heads
    (4, 2048, 2048, 16, True),      # a card test's case
])
def test_attention_path_bar(h, sq, sk, d, causal):
    """Unit-variance q, k and v, as the models' rmsnorm'd projections give
    them: kernel 5's rounding is inside the bar, and at the ragged
    non-causal views (1,500 = 23 x 64 + 28 keys) a plain version without
    the last 28 keys is outside it on a quarter of the elements or
    more."""
    rng = np.random.default_rng(sq + sk)
    q, k, v = (torch.from_numpy(rng.standard_normal((1, h, n, d),
                                                    np.float32)).bfloat16()
               for n in (sq, sk, sk))
    ref = mha_ref(q, k, v, causal=causal)
    assert _outside_attention_bar(_kernel5_rounding(q, k, v, causal), ref,
                                  q, k, v, causal) == 0
    if not causal:
        cut = sk - sk % 64
        dropped = mha_ref(q, k[:, :, :cut], v[:, :, :cut], causal=False)
        assert _outside_attention_bar(dropped, ref, q, k, v,
                                      False) > ref.numel() // 4
