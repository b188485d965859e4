"""The port's partitioned steps on worlds of gloo ranks on the CPU against
its own one-rank steps, in f32: every family's train step on a model axis
of 4 (the SSM's scan carried across ranks, the encoder-decoder's memory
gathered) on 2 x 4 and 1 x 4 meshes of ranks, the prefill and decode
bundles (``launch/steps.py``) on a 2 x 4 mesh of ranks, and the SSD carry
(``kernels/ssd_scan/ref.py:carry``) on its own.

One world a mesh shape runs every job of the module at once
(``tests/torch_multi_rank_paths_cases.py:jobs_case``); the parent computes
what one rank gives for each and compares. Weights come from the JAX
package through ``state.params_from_jax`` (``torch_train_cases.carried``),
inputs from numpy seeds.

Bars: a train step's loss within 1e-5 relative and every gradient leaf
within 1e-4 of its max |g| (``test_torch_multi_rank.py``'s f32 bars); a
prefill's logits, each rank's block of its KV cache and every decode
step's logits within 1e-5 of max |logit|.
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch_multi_rank_cases as mr  # noqa: E402
import torch_multi_rank_paths_cases as pc  # noqa: E402
import torch_train_cases as tc  # noqa: E402
from repro_torch import state  # noqa: E402
from repro_torch.kernels.ssd_scan.ref import (carry, piece_state,  # noqa: E402
                                              ssd_chunked, ssd_ref)
from repro_torch.launch import steps  # noqa: E402
from repro_torch.models import encdec  # noqa: E402

MESHES = {"2x4": (2, 4), "1x4": (1, 4)}
B, S = 4, 32
STEP = {"remat": "full", "loss_chunk": 16}
LOGIT_TOL = 1e-5
TRAIN_ARCHS = ["mamba2-2.7b", "zamba2-1.2b", "seamless-m4t-medium"]
# qwen's smoke KV cache on a model axis of 4: (L, B, S, KH 4, D 16); the
# partition rules split the largest dim, the last of equals
KH_MAJOR = {"num_heads": 8, "num_kv_heads": 8, "head_dim": 4}
# name -> (arch, config changes, tokens); the rules split each cache on
PREFILL = {
    "qwen1.5-0.5b": ("qwen1.5-0.5b", {}, S),                # positions
    "qwen1.5-0.5b-s16": ("qwen1.5-0.5b", {}, 16),           # the head dim
    "llama3.2-3b": ("llama3.2-3b", {}, S),                  # gathered attn
    "mamba2-2.7b": ("mamba2-2.7b", {}, S),
    "zamba2-1.2b": ("zamba2-1.2b", {}, S),
    "seamless-m4t-medium": ("seamless-m4t-medium", {}, S),
}
# name -> (arch, config changes, cache slots, prompt, steps, optimized):
# the prompt fills the cache on one rank; the steps cross an owner's
# boundary (8 positions an owner of 32 slots)
DECODE = {
    "qwen1.5-0.5b-v1": ("qwen1.5-0.5b", {}, S, 12, 8, False),
    "qwen1.5-0.5b-v2": ("qwen1.5-0.5b", {}, S, 12, 8, "v2"),
    "qwen1.5-0.5b-v3": ("qwen1.5-0.5b", {}, S, 12, 8, "v3"),
    "llama3.2-3b-v3": ("llama3.2-3b", {}, S, 12, 8, "v3"),
    # 16 slots: the rules split the head dim (4 steps: no owner's bound)
    "qwen1.5-0.5b-head-dim-v1": ("qwen1.5-0.5b", {}, 16, 6, 4, False),
    "qwen1.5-0.5b-head-dim-v3": ("qwen1.5-0.5b", {}, 16, 6, 4, "v3"),
    # 8 KV heads of 4 dims over 8 slots: the rules split the KV heads
    "qwen1.5-0.5b-kv-heads-v1": ("qwen1.5-0.5b", KH_MAJOR, 8, 2, 4, False),
    "qwen1.5-0.5b-kv-heads-v3": ("qwen1.5-0.5b", KH_MAJOR, 8, 2, 4, "v3"),
    "olmoe-1b-7b": ("olmoe-1b-7b", {}, S, 12, 4, False),
    # the state (B, H 8, N 16, P 16) split on P; N 32 splits N; P 4, H
    "mamba2-2.7b": ("mamba2-2.7b", {}, S, 12, 8, False),
    "mamba2-2.7b-state-n": ("mamba2-2.7b", {"ssm_state": 32}, S, 12, 4,
                            False),
    "mamba2-2.7b-state-heads": ("mamba2-2.7b", {"ssm_headdim": 4}, S, 12, 4,
                                False),
    "zamba2-1.2b": ("zamba2-1.2b", {}, S, 12, 8, False),
    # its cross cache of 16 frames is split on the head dim
    "seamless-m4t-medium": ("seamless-m4t-medium", {}, S, 12, 8, False),
}
ENC_LEN = 16
SEED = 7


def world(mshape) -> int:
    return int(np.prod(mshape))


@functools.lru_cache(maxsize=None)
def _carried(arch, replace: tuple):
    _, cfg, _, tp = tc.carried(arch, seed=SEED, **dict(replace))
    return cfg, tc.as_f32(tp), state.params_to_numpy(tp, cfg)


def weights(arch, replace):
    """(port cfg, f32 port params, the reference-layout numpy tree) of one
    draw a config, shared by its jobs (none writes its parameters)."""
    return _carried(arch, tuple(sorted(replace.items())))


def train_job(arch):
    cfg, params, tree = weights(arch, {})
    cfg = cfg.replace(**STEP)
    rng = np.random.default_rng(7)
    tokens = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int64)
    batch = {"tokens": tokens, "labels": np.roll(tokens, -1, axis=1)}
    if cfg.encoder_layers:
        batch["frames"] = (0.1 * rng.standard_normal(
            (B, S, cfg.d_model))).astype(np.float32)
    job = {"kind": "train", "arch": arch, "params": tree, "batch": batch,
           "f32": True, "replace": STEP}
    return job, (cfg, params, pc.tensors(batch))


def prefill_job(arch, replace, s):
    cfg, params, tree = weights(arch, replace)
    rng = np.random.default_rng(3)
    batch = {"tokens": rng.integers(0, cfg.vocab_size,
                                    (B, s)).astype(np.int64)}
    if cfg.encoder_layers:
        batch["frames"] = (0.1 * rng.standard_normal(
            (B, s, cfg.d_model))).astype(np.float32)
    job = {"kind": "prefill", "arch": arch, "params": tree, "batch": batch,
           "f32": True, "replace": replace}
    tb = pc.tensors(batch)
    with torch.no_grad():
        want = steps.prefill_step(params, tb["tokens"], cfg,
                                  frames=tb.get("frames"))
    return job, want


def decode_job(arch, replace, slots, prompt, n, optimized):
    """The job and what one rank gives: the prompt fills an f32 cache on
    one rank (the encoder-decoder's cross cache from ``prepare_cross`` of
    ENC_LEN frames), then ``n`` steps' logits and the cache after them."""
    cfg, params, tree = weights(arch, replace)
    rng = np.random.default_rng(5)
    tokens = rng.integers(0, cfg.vocab_size,
                          (prompt + n, B)).astype(np.int64)
    cache = steps.init_cache(cfg, B, slots, optimized, dtype=torch.float32,
                             device="cpu", enc_len=ENC_LEN)
    with torch.no_grad():
        if cfg.encoder_layers:
            frames = torch.from_numpy((0.1 * rng.standard_normal(
                (B, ENC_LEN, cfg.d_model))).astype(np.float32))
            cache = encdec.prepare_cross(
                params, encdec.encode(params, frames, cfg), cfg, cache)
            cache["xk"], cache["xv"] = cache["xk"].float(), \
                cache["xv"].float()
        for t in range(prompt):
            _, cache = steps.serve_step(params, cache,
                                        torch.from_numpy(tokens[t]), t, cfg,
                                        optimized)
        start = pc.arrays(cache)
        want = []
        for t in range(prompt, prompt + n):
            logits, cache = steps.serve_step(
                params, cache, torch.from_numpy(tokens[t]), t, cfg,
                optimized)
            want.append(logits.numpy())
    job = {"kind": "decode", "arch": arch, "params": tree,
           "tokens": tokens[prompt:], "pos": prompt, "slots": slots,
           "cache": start, "f32": True, "replace": replace,
           "optimized": optimized}
    return job, (cfg, np.stack(want), pc.arrays(cache))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Each mesh's world, run once for the module: {mesh name: (the
    jobs' one-rank sides by name, the ranks' results)}."""
    done = {}

    def get(mesh_name):
        if mesh_name not in done:
            jobs, ones = {}, {}
            for arch in TRAIN_ARCHS:
                jobs["train-" + arch], ones["train-" + arch] = \
                    train_job(arch)
            if mesh_name == "2x4":
                for name, args in PREFILL.items():
                    jobs["prefill-" + name], ones["prefill-" + name] = \
                        prefill_job(*args)
                for name, args in DECODE.items():
                    jobs["decode-" + name], ones["decode-" + name] = \
                        decode_job(*args)
            mshape = MESHES[mesh_name]
            outs = mr.run_ranks(tmp_path_factory.mktemp("paths"),
                                world(mshape), pc.jobs_case, mshape, jobs,
                                timeout=300)
            done[mesh_name] = (ones, outs)
        return done[mesh_name]
    return get


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("arch", TRAIN_ARCHS)
def test_family_step_matches_one_rank_in_f32(runs, arch, mesh_name):
    """mamba2's scan carried across 4 model ranks (the conv's halo and the
    SSD's state), zamba2's mamba layers and its shared attention at the
    rank's global positions, seamless's encoder on the rank's frames with
    its memory gathered: the partitioned step's loss and gradients
    (``sharded_value_and_grad``) against ``value_and_grad`` on one rank,
    the loss within 1e-5 relative and every gradient leaf within 1e-4 of
    its max |g|. (The bundle's AdamW step over the shards is held by
    test_torch_multi_rank.py, and runs for mamba2 and zamba2 in
    test_torch_multi_rank_twins.py.)"""
    mshape = MESHES[mesh_name]
    ones, outs = runs(mesh_name)
    cfg, params, batch = ones["train-" + arch]
    loss, _, grads = steps.value_and_grad(params, batch, cfg)
    for o in outs:
        got = o["train-" + arch]
        assert got["local_tokens"] == (B // mshape[0], S // mshape[1])
        assert abs(got["loss"] - float(loss)) <= \
            tc.F32_LOSS_TOL * abs(float(loss)), (got["loss"], float(loss))
    worst, where = tc.worst_leaf_gap(outs[0]["train-" + arch]["grads"],
                                     state.params_to_numpy(grads, cfg))
    assert worst < tc.GRAD_TOL, (worst, where)
    # the SSM layers' conv reads the previous rank's positions
    assert (outs[0]["train-" + arch]["calls"]["send_recv"] > 0) == \
        (cfg.family in ("ssm", "hybrid"))


@pytest.mark.parametrize("name", sorted(PREFILL))
def test_prefill_bundle_matches_one_rank(runs, name):
    """The prefill bundle on 2 x 4 ranks against ``prefill_step`` on one:
    every rank's rows of the last position's logits and, for the
    transformer families, its block of the KV cache by the partition
    rules (its own positions, or moved to the head dim by an all-to-all
    where the rules split that: 16 positions of 16 dims)."""
    mshape = MESHES["2x4"]
    ones, outs = runs("2x4")
    want = ones["prefill-" + name]
    logits, cache = want if isinstance(want, tuple) else (want, None)
    scale = float(logits.abs().max())
    for r, o in enumerate(outs):
        got = o["prefill-" + name]
        rows = pc.block(logits.numpy(), got["logits_spec"], mshape, r)
        assert got["logits"].shape == rows.shape
        assert np.abs(got["logits"] - rows).max() <= LOGIT_TOL * scale
        if cache is None:
            assert "cache" not in got
            continue
        for k, t in cache.items():
            blk = pc.block(t.float().numpy(), got["cache_specs"][k], mshape,
                           r)
            assert got["cache"][k].shape == blk.shape, k
            assert np.abs(got["cache"][k] - blk).max() <= LOGIT_TOL * scale
    if cache is not None:
        model_dim = outs[0]["prefill-" + name]["cache_specs"]["k"].index(
            "model")
        assert model_dim == (4 if name.endswith("s16") else 2)


@pytest.mark.parametrize("name", sorted(DECODE))
def test_decode_bundle_matches_one_rank(runs, name):
    """The decode bundle on 2 x 4 ranks from a cache filled on one rank,
    against ``serve_step`` on one: every step's logits (each rank's rows)
    and the whole cache after the steps. The transformer families' v1, v2
    and v3 steps with the cache split on positions (the owner of ``pos``
    writes, the owners' partials merged), on the head dim, and on the KV
    heads; olmoe's MoE routing the gathered rows; the SSM state split on
    P, N and heads."""
    mshape = MESHES["2x4"]
    ones, outs = runs("2x4")
    cfg, want, cache = ones["decode-" + name]
    scale = float(np.abs(want).max())
    for r, o in enumerate(outs):
        got = o["decode-" + name]
        for t in range(len(want)):
            rows = pc.block(want[t], got["token_spec"] + (None,), mshape, r)
            assert np.abs(got["logits"][t] - rows).max() <= \
                LOGIT_TOL * scale, t
    whole = outs[0]["decode-" + name]["cache"]
    for (_, a), (_, b) in zip(leaf_items(whole), leaf_items(cache),
                              strict=True):
        np.testing.assert_allclose(a, b, rtol=0, atol=LOGIT_TOL * scale)


def leaf_items(tree, path=""):
    """(path, array) of every array leaf of a tree, in order."""
    if isinstance(tree, dict):
        return [i for k in sorted(tree) for i in leaf_items(tree[k],
                                                            f"{path}/{k}")]
    if isinstance(tree, list):
        return [i for j, v in enumerate(tree)
                for i in leaf_items(v, f"{path}/{j}")]
    return [(path, tree)] if isinstance(tree, np.ndarray) else []


@pytest.mark.parametrize("name", ["qwen1.5-0.5b-v1", "mamba2-2.7b",
                                  "mamba2-2.7b-state-n"])
def test_decode_moves_no_cache(runs, name):
    """What a decode step exchanges beyond the parameters' gather grows
    with the rows and the model's widths, not with the cache: for the
    positions' owners B x H x (D + 2) f32 partials a layer; for the SSM
    the conv's outputs of the rank's channels and C . h (gathered over
    P, or summed over N)."""
    ones, outs = runs("2x4")
    cfg = ones["decode-" + name][0]
    got = outs[0]["decode-" + name]
    step, params = got["step"]["nbytes"], got["params_gather"]["nbytes"]
    moved = sum(step.values()) - sum(params.values())
    rows, m = B // MESHES["2x4"][0], MESHES["2x4"][1]
    if cfg.family == "ssm":
        conv = cfg.d_inner + 2 * cfg.ssm_groups * cfg.ssm_state
        h, p = cfg.ssm_heads, cfg.ssm_headdim
        ssd = h * p // m if "state-n" not in name else h * p
        want = cfg.num_layers * rows * (conv // m + ssd) * 4
    else:
        want = cfg.num_layers * rows * cfg.num_heads * (cfg.hd + 2) * 4
    assert moved == want, (moved, want, step, params)


@pytest.mark.parametrize("pieces,dead", [(4, 1), (2, None), (8, 6)],
                         ids=["4-pieces-one-of-zero-decay", "2-pieces",
                              "8-pieces-one-of-zero-decay"])
def test_carry_matches_one_sequence(pieces, dead):
    """A sequence cut into pieces, each scanned from a zero state
    (``ssd_chunked``, the kernel's plain version), then ``carry`` with
    every piece's ``piece_state``: equal to ``ssd_ref`` over the whole
    sequence within 1e-5 of max |y|, a piece whose decay is exactly 0
    included (dt so large that exp(dt a) underflows: the pieces before it
    leave nothing); and the gradients of the pieces' sum against the
    whole's."""
    bsz, s, h, p, g, n = 2, 32, 4, 8, 2, 6
    rng = np.random.default_rng(pieces)

    def t(*shape, scale=1.0, shift=0.0):
        return torch.from_numpy((shift + scale * rng.standard_normal(
            shape)).astype(np.float32)).requires_grad_()

    x, b, c = t(bsz, s, h, p), t(bsz, s, g, n), t(bsz, s, g, n)
    dt = torch.from_numpy(rng.uniform(0.05, 0.5, (bsz, s, h)).astype(
        np.float32))
    size = s // pieces
    if dead is not None:
        dt[:, dead * size:(dead + 1) * size] = 1e4
    dt.requires_grad_()
    a, d = t(h, scale=0.3, shift=-1.0), t(h)
    whole, _ = ssd_ref(x, dt, a, b, c, d)
    cut = [slice(i * size, (i + 1) * size) for i in range(pieces)]
    made = [piece_state(x[:, sl], dt[:, sl], a, b[:, sl]) for sl in cut]
    if dead is not None:
        assert float(made[dead][1].detach().abs().max()) == 0.0
    states = torch.stack([st for st, _ in made])
    decays = torch.stack([dc for _, dc in made])
    got = torch.cat([carry(ssd_chunked(x[:, sl], dt[:, sl], a, b[:, sl],
                                       c[:, sl], d, size),
                           dt[:, sl], a, c[:, sl], states, decays, i)
                     for i, sl in enumerate(cut)], dim=1)
    scale = float(whole.detach().abs().max())
    assert float((got - whole).detach().abs().max()) <= LOGIT_TOL * scale
    w = torch.from_numpy(rng.standard_normal(whole.shape).astype(np.float32))
    ins = (x, dt, a, b, c, d)
    g_whole = torch.autograd.grad((whole * w).sum(), ins)
    g_got = torch.autograd.grad((got * w).sum(), ins)
    for name, gw, gg in zip("x dt a b c d".split(), g_whole, g_got):
        gap = float((gg - gw).abs().max()) / float(gw.abs().max())
        assert gap <= tc.GRAD_TOL, (name, gap)
