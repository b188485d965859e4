"""The port's partitioned steps on worlds of gloo ranks on the CPU against
the reference's own multi-device bundles, and its training loop on a mesh
of ranks.

The reference runs in one subprocess with 8 host devices, as
``tests/test_system.py:101`` runs its 2 x 4 step: its ``build_train_step``
for mamba2-2.7b and zamba2-1.2b, and its ``build_prefill_step`` and
``build_decode_step`` for qwen1.5-0.5b and mamba2-2.7b, each jitted with
its shardings on a (2, 4) mesh. The port runs the same bundles on 8 gloo
ranks from the same weights (``state.params_from_jax`` of the reference's
``init``), in bf16 as the reference. Bars: a step's loss within 2e-2 (the
reference's sharded-step bar, test_system.py:126), a prefill's logits
within 5e-2 and every decode step's within 2e-2 of max |logit| (the
port's bf16 bars, PERF.md §2). The reference's transformer prefill returns
``logits[:, -1]`` (B,) (ROADMAP Queue 3): the port's (B, V) logits are
compared through that cut.

The loop: twin of ``tests/test_system.py:72``, ``launch.train.train`` on
a world of 4 gloo ranks (the (2, 2) host mesh) fails after step 11 and
resumes from its checkpoint of step 10; in f32 its losses match one
process's run within 1e-5 relative, and the resumed step 11 gives the
first run's loss.
"""

import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

import torch_multi_rank_cases as mr  # noqa: E402
import torch_multi_rank_paths_cases as pc  # noqa: E402
import torch_train_cases as tc  # noqa: E402
from repro.configs import get_smoke_config as jax_smoke  # noqa: E402
from repro.models import build_model as jax_build  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402
from repro_torch.models.model_zoo import build_model  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402

SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "src")
MESH = (2, 4)
B, S, DECODE_STEPS = 4, 32, 12
STEP = {"remat": "full", "loss_chunk": 16}
STEP_LOSS_TOL, PREFILL_TOL, DECODE_TOL = 2e-2, 5e-2, 2e-2
TRAIN_ARCHS = ["mamba2-2.7b", "zamba2-1.2b"]
SERVE_ARCHS = ["qwen1.5-0.5b", "mamba2-2.7b"]
LOOP = dict(batch=2, seq=32, log_every=1)

REFERENCE = """
import sys
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import AxisType
from repro.configs import get_smoke_config
from repro.configs.base import ShapeConfig
from repro.distributed.sharding import make_rules
from repro.launch.steps import (build_decode_step, build_prefill_step,
                                build_train_step)
from repro.models import build_model
from repro.optim import init_state

d = sys.argv[1]
tokens = np.load(d + "/tokens.npy").astype(np.int32)
dec = np.load(d + "/decode.npy").astype(np.int32)
mesh = jax.make_mesh((2, 4), ("data", "model"),
                     axis_types=(AxisType.Auto,) * 2)
rules = make_rules(mesh)
out = {}
with mesh:
    for arch in %(train)r:
        cfg = get_smoke_config(arch).replace(remat="full", loss_chunk=16)
        params = build_model(cfg).init(jax.random.PRNGKey(0))
        bundle = build_train_step(cfg, ShapeConfig("t", %(s)d, %(b)d,
                                                   "train"), rules)
        fn = jax.jit(bundle.fn, in_shardings=bundle.in_shardings,
                     out_shardings=bundle.out_shardings)
        batch = {"tokens": jnp.asarray(tokens),
                 "labels": jnp.asarray(np.roll(tokens, -1, axis=1))}
        _, _, m = fn(params, init_state(params), batch)
        out["train-" + arch] = np.asarray(float(m["loss"]))
    for arch in %(serve)r:
        cfg = get_smoke_config(arch)
        model = build_model(cfg)
        params = model.init(jax.random.PRNGKey(0))
        bundle = build_prefill_step(cfg, ShapeConfig("p", %(s)d, %(b)d,
                                                     "prefill"), rules)
        fn = jax.jit(bundle.fn, in_shardings=bundle.in_shardings,
                     out_shardings=bundle.out_shardings)
        got = fn(params, {"tokens": jnp.asarray(tokens)})
        out["prefill-" + arch] = np.asarray(
            got[0] if isinstance(got, tuple) else got, np.float32)
        bundle = build_decode_step(cfg, ShapeConfig("d", %(s)d, %(b)d,
                                                    "decode"), rules)
        fn = jax.jit(bundle.fn, in_shardings=bundle.in_shardings,
                     out_shardings=bundle.out_shardings,
                     donate_argnums=bundle.donate)
        cache = jax.device_put(model.init_cache(%(b)d, %(s)d),
                               bundle.in_shardings[1])
        logits = []
        for t in range(dec.shape[0]):
            lg, cache = fn(params, cache, jnp.asarray(dec[t]),
                           jnp.asarray(t, jnp.int32))
            logits.append(np.asarray(lg, np.float32))
        out["decode-" + arch] = np.stack(logits)
np.savez(d + "/reference.npz", **out)
print("OK")
""" % {"train": TRAIN_ARCHS, "serve": SERVE_ARCHS, "s": S, "b": B}


def reference_tree(arch, **replace):
    """The reference's ``init(PRNGKey(0))`` of the smoke config as a numpy
    tree (bf16 values in float32, exact)."""
    params = jax_build(jax_smoke(arch).replace(**replace)).init(
        jax.random.PRNGKey(0))
    return jax.tree.map(lambda x: np.asarray(x, np.float32), params)


@pytest.fixture(scope="module")
def twins(tmp_path_factory):
    """(the reference's results, the port's 8 ranks' results), each run
    once for the module on the same tokens and weights."""
    d = str(tmp_path_factory.mktemp("twins"))
    rng = np.random.default_rng(3)
    tokens = rng.integers(0, 512, (B, S))
    decode = rng.integers(0, 512, (DECODE_STEPS, B))
    np.save(os.path.join(d, "tokens.npy"), tokens)
    np.save(os.path.join(d, "decode.npy"), decode)
    env = dict(os.environ, PYTHONPATH=SRC + os.pathsep +
               os.environ.get("PYTHONPATH", ""),
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    # below the parent's priority, as the ranks (torch_multi_rank_cases)
    ref = subprocess.Popen(
        ["nice", "-n", str(mr.RANK_NICE), sys.executable, "-c",
         "import repro.distributed.jax_compat\n" + REFERENCE, d], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    jobs = {}
    batch = {"tokens": tokens.astype(np.int64),
             "labels": np.roll(tokens, -1, axis=1).astype(np.int64)}
    for arch in TRAIN_ARCHS:
        jobs["train-" + arch] = {
            "kind": "train", "arch": arch, "replace": STEP, "batch": batch,
            "params": reference_tree(arch, **STEP), "step": True}
    for arch in SERVE_ARCHS:
        tree = reference_tree(arch)
        jobs["prefill-" + arch] = {
            "kind": "prefill", "arch": arch, "params": tree,
            "batch": {"tokens": batch["tokens"]}}
        cache = steps.init_cache(get_smoke_config(arch), B, S, device="cpu")
        jobs["decode-" + arch] = {
            "kind": "decode", "arch": arch, "params": tree,
            "tokens": decode.astype(np.int64), "pos": 0, "slots": S,
            "cache": pc.arrays(cache), "bf16_cache": True}
    # the ranks run while the reference compiles
    outs = mr.run_ranks(d, 8, pc.jobs_case, MESH, jobs, timeout=300)
    out, err = ref.communicate(timeout=600)
    assert ref.returncode == 0, f"reference failed:\n{out}\n{err}"
    with np.load(os.path.join(d, "reference.npz")) as f:
        return dict(f), outs


def whole_rows(outs, key, axis):
    """The whole batch's logits from each rank's rows (on ``axis``), read
    from the ranks of model coordinate 0 (a model group's are equal)."""
    return np.concatenate([outs[d * MESH[1]][key]["logits"]
                           for d in range(MESH[0])], axis=axis)


@pytest.mark.parametrize("arch", TRAIN_ARCHS)
def test_family_step_matches_the_reference_2x4(twins, arch):
    """mamba2 and zamba2 on a model axis of 4: the port's partitioned step
    (the scan carried across ranks) against the reference's jitted 2 x 4
    ``build_train_step``, within its sharded-step bar."""
    ref, outs = twins
    want = float(ref["train-" + arch])
    for o in outs:
        got = o["train-" + arch]["step"]["loss"]
        assert abs(got - want) < STEP_LOSS_TOL, (got, want)


@pytest.mark.parametrize("arch", SERVE_ARCHS)
def test_prefill_bundle_matches_the_reference_2x4(twins, arch):
    """The prefill bundle's last-position logits on 2 x 4 ranks against
    the reference's 2 x 4 bundle: mamba2's (B, V); qwen's through the
    reference's (B,) cut, ``logits[:, -1]``."""
    ref, outs = twins
    got = whole_rows(outs, "prefill-" + arch, 0)
    want = ref["prefill-" + arch]
    scale = float(np.abs(got).max())
    if want.ndim == 1:
        got = got[:, -1]
    assert got.shape == want.shape
    assert float(np.abs(got - want).max()) <= PREFILL_TOL * scale


@pytest.mark.parametrize("arch", SERVE_ARCHS)
def test_decode_bundle_matches_the_reference_2x4(twins, arch):
    """12 decode steps from a zero cache on 2 x 4 ranks (qwen's KV cache
    split on positions, 8 an owner, so the steps cross an owner's
    boundary; mamba2's state split on its head dim P) against the
    reference's 2 x 4 decode bundle, every step within 2e-2 of max
    |logit|."""
    ref, outs = twins
    got = whole_rows(outs, "decode-" + arch, 1)
    want = ref["decode-" + arch]
    assert got.shape == want.shape
    for t in range(DECODE_STEPS):
        scale = float(np.abs(want[t]).max())
        assert float(np.abs(got[t] - want[t]).max()) <= DECODE_TOL * scale, t


def test_train_loop_on_ranks_resumes(tmp_path, capsys):
    """Twin of tests/test_system.py:72 on a mesh of ranks: qwen1.5-0.5b's
    ``train(steps=12, batch=2, seq=32, fail_at=11)`` on 4 gloo ranks (the
    (2, 2) host mesh), then 2 steps resumed from its checkpoint of step
    10, in f32: every logged loss within 1e-5 relative of one process's
    run, the resumed step 11 equal to the first run's, and each rank
    holding blocks of the state."""
    outs = mr.run_ranks(tmp_path, 4, pc.loop_case, "qwen1.5-0.5b", LOOP,
                        str(tmp_path / "ranks"))
    one_dir = str(tmp_path / "one")
    _, _, first = ttrain.train("qwen1.5-0.5b", steps=12, ckpt_dir=one_dir,
                               fail_at=11, device="cpu",
                               dtype=torch.float32, **LOOP)
    capsys.readouterr()
    _, _, resumed = ttrain.train("qwen1.5-0.5b", steps=2, ckpt_dir=one_dir,
                                 resume=True, device="cpu",
                                 dtype=torch.float32, **LOOP)
    assert "[train] resumed from step 10" in capsys.readouterr().out
    assert len(first) == 11 and len(resumed) == 2
    for o in outs:
        np.testing.assert_allclose(o["first"], first, rtol=tc.F32_LOSS_TOL)
        np.testing.assert_allclose(o["resumed"], resumed,
                                   rtol=tc.F32_LOSS_TOL)
        assert o["resumed"][0] == o["first"][10]
    whole = build_model(get_smoke_config("qwen1.5-0.5b")).init(
        0, device="meta")
    assert sum(int(np.prod(s)) for s in outs[0]["shapes"]) < \
        sum(t.numel() for _, t in adamw.leaves(whole))
