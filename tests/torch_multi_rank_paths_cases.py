"""Cases of tests/test_torch_multi_rank_paths.py and
tests/test_torch_multi_rank_twins.py: what each gloo rank runs of the
port's partitioned train, prefill and decode steps and of its training
loop on a mesh of ranks.

One spawned world runs a list of jobs (``jobs_case``) and returns every
job's results at once: a world costs seconds to start, a job at smoke size
a fraction of one. Like ``torch_multi_rank_cases.py``, which spawns the
ranks (``run_ranks``), this module imports no JAX: weights come in as
numpy trees of the reference's layout (``state.params_from_jax``), batches
and caches as numpy arrays.
"""

import numpy as np
import torch

from repro_torch import state
from repro_torch.configs import get_smoke_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.distributed import collectives, sharding
from repro_torch.launch import steps
from repro_torch.launch import train as train_mod
from repro_torch.launch.mesh import Mesh, RankPlace, make_mesh
from repro_torch.optim import adamw
from torch_multi_rank_cases import AXES, f32_tree


def params_of(job) -> tuple:
    """(cfg, the job's parameters as the port's tree on the CPU, f32 where
    the job says)."""
    cfg = get_smoke_config(job["arch"]).replace(**job.get("replace", {}))
    params = state.params_from_jax(job["params"], cfg, device="cpu")
    return cfg, f32_tree(params) if job.get("f32") else params


def tensors(tree):
    """A tree of numpy arrays (and plain numbers) as tensors."""
    if isinstance(tree, dict):
        return {k: tensors(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [tensors(v) for v in tree]
    return torch.from_numpy(tree) if isinstance(tree, np.ndarray) else tree


def arrays(tree):
    """``tensors``' inverse, bf16 tensors as float32 arrays (exact)."""
    if isinstance(tree, dict):
        return {k: arrays(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [arrays(v) for v in tree]
    if isinstance(tree, torch.Tensor):
        return (tree.float() if tree.dtype == torch.bfloat16
                else tree).numpy()
    return tree


def specs(shardings):
    """The spec of every ``NamedSharding`` of a tree."""
    if isinstance(shardings, dict):
        return {k: specs(v) for k, v in shardings.items()}
    if isinstance(shardings, (list, tuple)):
        return [specs(v) for v in shardings]
    return shardings.spec


def block(whole: np.ndarray, spec: tuple, mshape, rank: int) -> np.ndarray:
    """Rank ``rank``'s block of ``whole`` by ``spec`` on an ``mshape``
    mesh (``NamedSharding.local`` on a mesh with the rank's coordinates
    and no groups)."""
    mesh = Mesh(AXES, tuple(mshape), place=RankPlace(
        tuple(int(c) for c in np.unravel_index(rank, mshape)),
        torch.device("cpu"), {}))
    return sharding.NamedSharding(mesh, tuple(spec)).local(
        torch.from_numpy(whole)).numpy()


def _counts() -> dict:
    return {"calls": dict(collectives.calls),
            "nbytes": dict(collectives.nbytes)}


# ---------------------------------------------------------------------------
# the jobs: each runs on ``mesh`` and returns plain values
# ---------------------------------------------------------------------------
def train_job(rank, mesh, job):
    """The partitioned step's loss and whole gradients
    (``sharded_value_and_grad``; the gradients on rank 0, in the
    reference's layout) and the collectives it issued; where
    ``job["step"]``, then one step of the bundle's ``fn`` and its
    metrics."""
    cfg, params = params_of(job)
    batch = tensors(job["batch"])
    b, s = batch["tokens"].shape
    rules = sharding.make_rules(mesh)
    bundle = steps.build_train_step(cfg, ShapeConfig("t", s, b, "train"),
                                    rules)
    p_sh, o_sh, b_sh = bundle.in_shardings
    p_local = sharding.place(params, p_sh)
    o_local = sharding.place(adamw.init_state(params), o_sh)
    b_local = sharding.place(batch, b_sh)
    collectives.reset_counts()
    loss, _, g_local = steps.sharded_value_and_grad(
        p_local, b_local, cfg, rules, p_sh, (b, s))
    out = {"loss": float(loss),
           "local_tokens": tuple(b_local["tokens"].shape), **_counts()}
    grads = sharding.gather_tree(g_local, p_sh)
    if rank == 0:
        out["grads"] = state.params_to_numpy(grads, cfg)
    if job.get("step"):
        _, _, m = bundle.fn(p_local, o_local, b_local)
        out["step"] = {k: float(v) for k, v in m.items()}
    return out


def prefill_job(rank, mesh, job):
    """The prefill bundle's ``fn`` on the rank's blocks: its rows of the
    logits, its blocks of the KV cache (the transformer families) with
    their specs, and the collectives of the call."""
    cfg, params = params_of(job)
    batch = tensors(job["batch"])
    b, s = batch["tokens"].shape
    bundle = steps.build_prefill_step(cfg, ShapeConfig("p", s, b, "prefill"),
                                      sharding.make_rules(mesh))
    p_sh, b_sh = bundle.in_shardings
    p_local = sharding.place(params, p_sh)
    b_local = sharding.place(batch, b_sh)
    collectives.reset_counts()
    out = bundle.fn(p_local, b_local)
    got = {**_counts(), "logits_spec": None}
    if isinstance(out, tuple):
        logits, cache = out
        got["cache"] = arrays(cache)
        got["cache_specs"] = specs(bundle.out_shardings[1])
        got["logits_spec"] = bundle.out_shardings[0].spec
    else:
        logits = out
        got["logits_spec"] = bundle.out_shardings.spec
    got["logits"] = logits.numpy()
    return got


def decode_job(rank, mesh, job):
    """``len(job["tokens"])`` steps of the decode bundle's ``fn`` from the
    whole cache ``job["cache"]`` (placed by the bundle's shardings; its
    float leaves bf16 where ``job["bf16_cache"]``) at positions
    ``job["pos"]`` on: the rank's rows of each step's logits,
    the whole cache after the steps (on rank 0), the specs, and the
    collectives of the last step and of the parameters' gather alone."""
    cfg, params = params_of(job)
    tokens = job["tokens"]                      # (T, B)
    b = tokens.shape[1]
    slots = job["slots"]
    rules = sharding.make_rules(mesh)
    bundle = steps.build_decode_step(
        cfg, ShapeConfig("d", slots, b, "decode"), rules,
        job.get("optimized", False))
    p_sh, c_sh, t_sh, _ = bundle.in_shardings
    p_local = sharding.place(params, p_sh)
    cache = tensors(job["cache"])
    if job.get("bf16_cache"):
        cache = {k: v.to(torch.bfloat16) if k != "mamba" and
                 isinstance(v, torch.Tensor) else v for k, v in cache.items()}
    c_local = sharding.place(cache, c_sh)
    logits = []
    for t, tok in enumerate(tokens):
        collectives.reset_counts()
        out, c_local = bundle.fn(p_local, c_local,
                                 t_sh.local(torch.from_numpy(tok)),
                                 job["pos"] + t)
        logits.append(out.numpy())
    step = _counts()
    collectives.reset_counts()
    with torch.no_grad():
        sharding.gather_tree(p_local, p_sh)
    params_gather = _counts()
    whole = sharding.gather_tree(c_local, c_sh)
    got = {"logits": np.stack(logits), "step": step,
           "params_gather": params_gather, "cache_specs": specs(c_sh),
           "token_spec": t_sh.spec,
           "block_shapes": [tuple(t.shape) for t in
                            sharding.tree_leaves(c_local)
                            if isinstance(t, torch.Tensor)]}
    if rank == 0:
        got["cache"] = arrays(whole)
    return got


JOBS = {"train": train_job, "prefill": prefill_job, "decode": decode_job}


def jobs_case(rank, mshape, jobs):
    """Every job of ``jobs`` (name -> job, a dict whose ``kind`` names its
    function) on one ``mshape`` mesh of ranks; their results by name."""
    mesh = make_mesh(mshape, AXES, device="cpu")
    return {name: JOBS[job["kind"]](rank, mesh, job)
            for name, job in jobs.items()}


# ---------------------------------------------------------------------------
# the training loop
# ---------------------------------------------------------------------------
def loop_case(rank, arch, run, directory):
    """``launch.train.train`` on the world's (n/2, 2) host mesh in f32:
    steps 0-11 with a failure injected after step 11 (one checkpoint, step
    10), then 2 steps resumed from it. The logged losses of both runs and
    the shapes of the rank's blocks of the state."""
    params, _, first = train_mod.train(
        arch, steps=12, ckpt_dir=directory, fail_at=11, device="cpu",
        dtype=torch.float32, **run)
    shapes = [tuple(t.shape) for _, t in adamw.leaves(params)]
    _, _, resumed = train_mod.train(
        arch, steps=2, ckpt_dir=directory, resume=True, device="cpu",
        dtype=torch.float32, **run)
    return {"first": first, "resumed": resumed, "shapes": shapes}
