"""The port's dense-cache decode (``transformer.decode_step``,
``decode_step_v2``, ``decode_step_v3``) and ``steps.prefill_step`` /
``serve_step`` against the JAX package's, on the smoke configs of
llama3.2-3b (dense, GQA group 3), olmoe-1b-7b (MoE; capacity factor 8.0,
so that no choice drops in either path, as tests/test_models.py runs it),
chameleon-34b (VLM) and nemotron-4-15b (squared-ReLU MLP), with the JAX
weights carried across by ``state.params_from_jax``.

Tolerances: each step's logits within 5e-2 of the reference's; the
caches' layer 0 within 2e-2 and every layer within 5e-2, the bar
tests/test_torch_model.py holds prefill's KV to (bf16 rounded in other
places by XLA and torch, and a layer's k and v carry the differences of
the layers below: nemotron's squared-ReLU layer 0 moves layer 1's by up
to 0.037); the port's decode against its own
forward, and v2 and v3 against v1, within 2e-2, the reference's own bars
(tests/test_models.py:51, tests/test_perf_variants.py:19).

The MoE config runs with f32 weights, activations and caches on both
sides. Top-k routing is discontinuous: where two experts' router
probabilities nearly tie, the bf16 rounding differences between XLA and
torch pick another expert for that token and move its output by the size
of an expert's output (seen at bf16: a 0.35 % gap between the 2nd and 3rd
expert of one token, layer 1, step 5, moved its logits by 0.10). In f32
the two packages route alike; tests/test_torch_moe.py holds the bf16 MoE
layer alone, on the same inputs.
"""

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke_config as jax_smoke  # noqa: E402
from repro.configs.base import ShapeConfig  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.models import transformer as jt  # noqa: E402
from repro_torch import state  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.models import transformer as tt  # noqa: E402
from repro_torch.models.model_zoo import build_model  # noqa: E402

ARCHS = ["llama3.2-3b", "olmoe-1b-7b", "chameleon-34b", "nemotron-4-15b"]
IMPLS = {False: (jt.init_cache, jt.decode_step),
         "v2": (jt.init_cache_v2, jt.decode_step_v2),
         "v3": (jt.init_cache_v2, jt.decode_step_v3)}
B, T, MAX_LEN = 2, 8, 12


def configs(arch):
    jcfg, cfg = jax_smoke(arch), get_smoke_config(arch)
    if cfg.family == "moe":
        jcfg = jcfg.replace(moe_capacity_factor=8.0)
        cfg = cfg.replace(moe_capacity_factor=8.0)
    return jcfg, cfg


def as_f32(tree):
    if isinstance(tree, dict):
        return {k: as_f32(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [as_f32(v) for v in tree]
    return tree.float()


@pytest.fixture(scope="module", params=ARCHS)
def model(request):
    """(jcfg, cfg, JAX params, the port's copy, tokens, the cache type):
    bf16 weights, f32 for the MoE config."""
    jcfg, cfg = configs(request.param)
    params = jt.init_params(jax.random.PRNGKey(11), jcfg)
    host = jax.tree.map(lambda x: np.asarray(x, np.float32), params)
    tp = state.params_from_jax(host, cfg, "cpu")
    dtype = torch.bfloat16
    if cfg.family == "moe":
        params = jax.tree.map(lambda x: x.astype(jnp.float32), params)
        tp, dtype = as_f32(tp), torch.float32
    toks = np.random.default_rng(2).integers(0, cfg.vocab_size, (B, T))
    return jcfg, cfg, params, tp, toks, dtype


def f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def port_decode(tp, cfg, toks, optimized, dtype):
    cache = steps.init_cache(cfg, B, MAX_LEN, optimized, dtype, "cpu")
    out = []
    for t in range(toks.shape[1]):
        logits, cache = steps.serve_step(tp, cache, torch.from_numpy(
            toks[:, t]), t, cfg, optimized=optimized)
        out.append(logits)
    return out, cache


@pytest.mark.parametrize("optimized", [False, "v2", "v3"])
def test_decode_steps_match_reference(model, optimized):
    jcfg, cfg, params, tp, toks, dtype = model
    init, step = IMPLS[optimized]
    jcache = init(jcfg, B, MAX_LEN, getattr(jnp, str(dtype)[6:]))
    got, cache = port_decode(tp, cfg, toks, optimized, dtype)
    for t in range(T):
        want, jcache = step(params, jcache, jnp.asarray(toks[:, t],
                                                        jnp.int32), t, jcfg)
        assert got[t].dtype == torch.float32
        assert tuple(got[t].shape) == (B, cfg.vocab_size)
        np.testing.assert_allclose(f32(got[t]), f32(want), atol=5e-2,
                                   rtol=5e-2)
    for name in ("k", "v"):
        assert tuple(cache[name].shape) == jcache[name].shape
        assert cache[name].dtype == dtype
        caches_close(cache[name], jcache[name])


def caches_close(got, want):
    """Layer 0 within 2e-2, every layer within 5e-2."""
    np.testing.assert_allclose(f32(got[0]), f32(want[0]), atol=2e-2,
                               rtol=2e-2)
    np.testing.assert_allclose(f32(got), f32(want), atol=5e-2, rtol=5e-2)


def test_decode_matches_forward(model):
    """Teacher-forced decode step by step equals the full forward's
    logits (the reference's own check, on the port alone)."""
    _, cfg, _, tp, toks, dtype = model
    full = build_model(cfg).forward(tp, {"tokens": torch.from_numpy(toks)})
    got, _ = port_decode(tp, cfg, toks, False, dtype)
    for t in range(T):
        np.testing.assert_allclose(f32(got[t]), f32(full[:, t]), atol=2e-2,
                                   rtol=2e-2)


@pytest.mark.parametrize("optimized", ["v2", "v3", True])
def test_optimized_decodes_match_v1(model, optimized):
    _, cfg, _, tp, toks, dtype = model
    base, c1 = port_decode(tp, cfg, toks, False, dtype)
    got, c2 = port_decode(tp, cfg, toks, optimized, dtype)
    for a, b in zip(base, got):
        np.testing.assert_allclose(f32(b), f32(a), atol=2e-2, rtol=2e-2)
    # the same tokens' k and v, in the KH-major layout
    for name in ("k", "v"):
        np.testing.assert_allclose(f32(c2[name].transpose(2, 3)),
                                   f32(c1[name]), atol=2e-2, rtol=2e-2)


def test_prefill_step_returns_the_logits_the_reference_step_cuts(model):
    """steps.prefill_step returns prefill's (B, V) last-token logits and
    its (L, B, S, KH, D) cache. The reference's prefill step returns
    ``logits[:, -1]`` of those same (B, V) logits: shape (B,), each row's
    last vocabulary entry (ROADMAP Queue 3). Both are pinned here."""
    jcfg, cfg, params, tp, toks, _ = model
    logits, cache = steps.prefill_step(tp, torch.from_numpy(toks), cfg)
    assert tuple(logits.shape) == (B, cfg.vocab_size)
    want, wcache = jt.prefill(params, jnp.asarray(toks, jnp.int32), jcfg)
    np.testing.assert_allclose(f32(logits), f32(want), atol=5e-2, rtol=5e-2)
    for name in ("k", "v"):
        assert tuple(cache[name].shape) == (cfg.num_layers, B, T,
                                            cfg.num_kv_heads, cfg.hd)
        caches_close(cache[name], wcache[name])
    # the reference's step: its fault, mirrored nowhere in the port
    bundle = jsteps.build_prefill_step(
        jcfg, ShapeConfig("t", T, B, "prefill"), _rules())
    jlogits, _ = jax.jit(bundle.fn)(params, {"tokens": jnp.asarray(
        toks, jnp.int32)})
    assert jlogits.shape == (B,)
    np.testing.assert_allclose(f32(jlogits), f32(want)[:, -1], atol=1e-6)


def _rules():
    from repro.distributed.sharding import make_rules
    from repro.launch.mesh import make_smoke_mesh
    return make_rules(make_smoke_mesh((1, 1)))


def test_prefill_then_decode_continues_the_sequence(model):
    """A cache filled by prefill and copied into a longer one continues
    token by token as forward does over the whole sequence."""
    _, cfg, _, tp, toks, dtype = model
    s0 = T - 3
    _, kv = steps.prefill_step(tp, torch.from_numpy(toks[:, :s0]), cfg)
    full = build_model(cfg).forward(tp, {"tokens": torch.from_numpy(toks)})
    for optimized in (False, "v3"):
        cache = steps.init_cache(cfg, B, MAX_LEN, optimized, dtype, "cpu")
        for name in ("k", "v"):
            dst = cache[name].transpose(2, 3) if optimized else cache[name]
            dst[:, :, :s0] = kv[name]
        for t in range(s0, T):
            logits, cache = steps.serve_step(
                tp, cache, torch.from_numpy(toks[:, t]), t, cfg,
                optimized=optimized)
            np.testing.assert_allclose(f32(logits), f32(full[:, t]),
                                       atol=2e-2, rtol=2e-2)


def test_decode_refuses_a_position_past_the_cache():
    cfg = get_smoke_config("llama3.2-3b")
    tp = tt.init_params(0, cfg, device="cpu")
    tok = torch.zeros(1, dtype=torch.int64)
    for optimized in (False, "v2", "v3"):
        cache = steps.init_cache(cfg, 1, 4, optimized, device="cpu")
        with pytest.raises(ValueError, match="outside"):
            steps.serve_step(tp, cache, tok, 4, cfg, optimized=optimized)
