"""Cases of tests/test_torch_multi_rank.py: worlds of gloo ranks on the
CPU, and what each rank runs there.

``run_ranks`` spawns the ranks with torch.multiprocessing; they meet
through a ``file://`` store in the test's own directory (no TCP port that
parallel test workers could share), each collective and each join bounded
by ``JOIN_S``. Each rank runs one ``*_case`` function of this module and
writes what it returns to a file the parent reads. Every rank imports this
module, so it imports no JAX: the tests carry the reference's weights in
as numpy arrays (``state.params_from_jax``) and hold the results against
the reference in the parent.
"""

import os
import tempfile
import time

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro_torch import state
from repro_torch.checkpoint import CheckpointStore
from repro_torch.configs import get_smoke_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.distributed import collectives, sharding
from repro_torch.distributed.act_sharding import activation_sharding
from repro_torch.launch import elastic, steps
from repro_torch.launch import train as train_mod
from repro_torch.launch.mesh import init_ranks, make_mesh
from repro_torch.models import moe
from repro_torch.models.model_zoo import build_model
from repro_torch.optim import adamw

# seconds a join, and a collective inside it, may take before the test
# fails
JOIN_S = 120
AXES = ("data", "model")


# the ranks' scheduling priority below their parent's: a world's ranks
# outnumber the cores the suite's other workers share, and the suite's time
# is its slowest worker's
RANK_NICE = 10


def _rank_main(rank, world, out_dir, fn):
    os.nice(RANK_NICE)
    torch.set_num_threads(1)
    args = torch.load(os.path.join(out_dir, "args.pt"), weights_only=False)
    init_ranks(world, rank, f"file://{os.path.join(out_dir, 'store')}",
               device="cpu", timeout=JOIN_S)
    try:
        out = fn(rank, *args)
        torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def run_ranks(tmp_path, world: int, fn, *args, timeout: float = JOIN_S):
    """``fn(rank, *args)`` on ``world`` gloo ranks spawned here; returns
    what each returned, by rank. A rank that raises fails the call with
    its traceback; ranks not done within ``timeout`` seconds are killed
    and the call raises. ``args`` go through a file: a spawn's pipe holds
    64 KiB, and a larger payload would start the ranks one by one."""
    out_dir = tempfile.mkdtemp(dir=tmp_path)
    torch.save(args, os.path.join(out_dir, "args.pt"))
    ctx = mp.start_processes(_rank_main, args=(world, out_dir, fn),
                             nprocs=world, join=False, start_method="spawn")
    deadline = time.monotonic() + timeout
    try:
        while not ctx.join(timeout=max(deadline - time.monotonic(), 0.01)):
            if time.monotonic() >= deadline:
                raise TimeoutError(f"{world} ranks of {fn.__name__} not done "
                                   f"in {timeout} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
                p.join(5)
    assert not any(p.is_alive() for p in ctx.processes)
    return [torch.load(os.path.join(out_dir, f"rank{r}.pt"),
                       weights_only=False) for r in range(world)]


# ---------------------------------------------------------------------------
# collectives
# ---------------------------------------------------------------------------
# name -> (collective, the shape of each rank's input); axes in mesh order
COLLECTIVES = {
    "all_gather": (lambda x, m: collectives.all_gather(x, 1, "model", m),
                   (3, 2, 5)),
    "all_gather_fsdp": (lambda x, m: collectives.all_gather(
        x, 0, ("data", "model"), m), (2, 3)),
    "reduce_scatter": (lambda x, m: collectives.reduce_scatter(
        x, 2, "data", m), (3, 4, 8)),
    "reduce_scatter_fsdp": (lambda x, m: collectives.reduce_scatter(
        x, 0, ("data", "model"), m), (8, 3)),
    "all_to_all": (lambda x, m: collectives.all_to_all(x, 0, 1, "model", m),
                   (8, 3, 2)),
    "psum": (lambda x, m: collectives.psum(x, "data", m), (4, 5)),
    "pmean": (lambda x, m: collectives.pmean(x, ("data", "model"), m),
              (4, 5)),
    "shift": (lambda x, m: collectives.shift(x, "model", m), (2, 3, 4)),
}
EMULATED = {   # name -> (kind, dims, axes)
    "all_gather": ("all_gather", (1,), ("model",)),
    "all_gather_fsdp": ("all_gather", (0,), ("data", "model")),
    "reduce_scatter": ("reduce_scatter", (2,), ("data",)),
    "reduce_scatter_fsdp": ("reduce_scatter", (0,), ("data", "model")),
    "all_to_all": ("all_to_all", (0, 1), ("model",)),
    "psum": ("psum", (), ("data",)),
    "pmean": ("pmean", (), ("data", "model")),
    "shift": ("shift", (), ("model",)),
}


def rank_input(seed: int, rank: int, shape) -> np.ndarray:
    return np.random.default_rng([seed, rank]).standard_normal(
        shape).astype(np.float32)


def collectives_case(rank, mshape, seed):
    """Each collective's output and the gradient of sum(w_r * y) with
    respect to the rank's input (w_r the rank's own weights), on the
    ``mshape`` mesh."""
    mesh = make_mesh(mshape, AXES, device="cpu")
    out = {}
    for name, (fn, shape) in COLLECTIVES.items():
        x = torch.from_numpy(rank_input(seed, rank, shape)).requires_grad_()
        y = fn(x, mesh)
        w = torch.from_numpy(rank_input(seed + 1, rank, tuple(y.shape)))
        (y * w).sum().backward()
        out[name] = (y.detach().numpy(), x.grad.numpy())
    return out


def group_of(rank: int, mshape, axes) -> list:
    """The ranks along ``axes`` (names of AXES) of ``rank``'s group on an
    ``mshape`` mesh, in row-major order."""
    coords = list(np.unravel_index(rank, mshape))
    idx = [AXES.index(a) for a in axes]
    out = []
    for pos in np.ndindex(*[mshape[i] for i in idx]):
        c = list(coords)
        for i, p in zip(idx, pos):
            c[i] = p
        out.append(int(np.ravel_multi_index(c, mshape)))
    return out


def emulate(name, xs, ws, mshape):
    """(outputs, input gradients) by rank of collective ``name`` on the
    inputs ``xs`` and weights ``ws`` of every rank, in one process."""
    kind, dims, axes = EMULATED[name]
    xs = [torch.from_numpy(x).requires_grad_() for x in xs]
    ys = []
    for r in range(len(xs)):
        g = group_of(r, mshape, axes)
        n, me = len(g), g.index(r)
        if kind == "all_gather":
            y = torch.cat([xs[q] for q in g], dims[0])
        elif kind == "reduce_scatter":
            y = torch.stack([xs[q] for q in g]).sum(0).chunk(n, dims[0])[me]
        elif kind == "all_to_all":
            y = torch.cat([xs[q].chunk(n, dims[0])[me] for q in g], dims[1])
        elif kind == "shift":
            y = xs[g[me - 1]] if me else 0 * xs[r]
        else:
            y = torch.stack([xs[q] for q in g]).sum(0)
            if kind == "pmean":
                y = y / n
        ys.append(y)
    total = sum((y * torch.from_numpy(w)).sum() for y, w in zip(ys, ws))
    # a shift's last rank sends its input nowhere: its gradient is 0
    grads = torch.autograd.grad(total, xs, allow_unused=True)
    grads = [torch.zeros_like(x) if g is None else g
             for x, g in zip(xs, grads)]
    return [y.detach().numpy() for y in ys], [g.numpy() for g in grads]


def norm_case(rank, mshape, seed):
    """``place`` and ``gather_tree`` of a parameter tree by its train
    specs, and ``global_norm`` of the blocks against the whole tree's."""
    mesh = make_mesh(mshape, AXES, device="cpu")
    rng = np.random.default_rng(seed)
    tree = {"embed": rng.standard_normal((64, 24)),
            "layers": [{"w": rng.standard_normal((16, 32)),
                        "b": rng.standard_normal((32,))} for _ in range(2)],
            "ln_f": rng.standard_normal((24,)),
            "odd": rng.standard_normal((3, 5))}
    tree = adamw.tree_map(lambda a: torch.from_numpy(a.astype(np.float32)),
                          tree)
    sh = sharding.param_shardings(tree, sharding.make_rules(mesh), "train")
    local = sharding.place(tree, sh)
    back = sharding.gather_tree(local, sh)
    return {"local_shapes": [tuple(t.shape) for _, t in adamw.leaves(local)],
            "shard_shapes": [s.shard_shape(t.shape) for (_, t), s in
                             zip(adamw.leaves(tree),
                                 sharding.tree_leaves(sh))],
            "round_trip": all(torch.equal(a, b) for (_, a), (_, b) in
                              zip(adamw.leaves(tree), adamw.leaves(back))),
            "norm": float(adamw.global_norm(local, sh)),
            "whole_norm": float(adamw.global_norm(tree)),
            "odd_holder": sh["odd"].first_holder(),
            "host_mesh": train_mod.make_host_mesh("cpu").sizes}


# ---------------------------------------------------------------------------
# the MoE and the train step
# ---------------------------------------------------------------------------
def moe_case(rank, mshape, p_np, x_np, capacity_factor):
    """olmoe's smoke MoE layer (``p_np``, f32) on the rank's block of x,
    through ``moe_ff`` under the policy; the rank's y."""
    mesh = make_mesh(mshape, AXES, device="cpu")
    cfg = get_smoke_config("olmoe-1b-7b")
    p = {k: torch.from_numpy(v) for k, v in p_np.items()}
    x = torch.from_numpy(x_np)
    xs = sharding.NamedSharding(mesh, ("data", "model", None))
    with activation_sharding(mesh, ("data",), "model", x.shape[:2]):
        collectives.reset_counts()
        y, aux = moe.moe_ff(p, xs.local(x), cfg,
                            capacity_factor=capacity_factor)
    return {"y": y.numpy(), "expert_load": aux["expert_load"].numpy(),
            "calls": dict(collectives.calls)}


def f32_tree(tree):
    return adamw.tree_map(lambda t: t.float(), tree)


def step_case(rank, arch, mshape, params_np, batch_np, f32, replace, steps_n):
    """The partitioned train step of ``arch``'s smoke config (``replace``d)
    from the carried ``params_np`` on the rank's blocks of ``batch_np``:
    the loss, metrics and whole gradients of ``sharded_value_and_grad``
    (the gradients on rank 0, in the reference's layout), then
    ``steps_n`` steps of the bundle's ``fn`` and their metrics, and the
    collectives each kind issued in the first of them."""
    mesh = make_mesh(mshape, AXES, device="cpu")
    cfg = get_smoke_config(arch).replace(**replace)
    params = state.params_from_jax(params_np, cfg, device="cpu")
    if f32:
        params = f32_tree(params)
    b, s = batch_np["tokens"].shape
    rules = sharding.make_rules(mesh)
    bundle = steps.build_train_step(cfg, ShapeConfig("t", s, b, "train"),
                                    rules)
    p_sh, o_sh, b_sh = bundle.in_shardings
    p_local = sharding.place(params, p_sh)
    o_local = sharding.place(adamw.init_state(params), o_sh)
    b_local = sharding.place({k: torch.from_numpy(v) for k, v in
                              batch_np.items()}, b_sh)
    loss, metrics, g_local = steps.sharded_value_and_grad(
        p_local, b_local, cfg, rules, p_sh, (b, s))
    grads = sharding.gather_tree(g_local, p_sh)
    out = {"loss": float(loss),
           "metrics": {k: float(v) for k, v in metrics.items()},
           "local_tokens": tuple(b_local["tokens"].shape)}
    if rank == 0:
        out["grads"] = state.params_to_numpy(grads, cfg)
    out["steps"] = []
    for i in range(steps_n):
        collectives.reset_counts()
        p_local, o_local, m = bundle.fn(p_local, o_local, b_local)
        out["steps"].append({k: float(v) for k, v in m.items()})
        if i == 0:
            out["calls"] = dict(collectives.calls)
            out["nbytes"] = dict(collectives.nbytes)
    return out


# ---------------------------------------------------------------------------
# save under one mesh, restore under another
# ---------------------------------------------------------------------------
def _shardings(cfg, mesh):
    """The checkpoint tree's (``state.checkpoint_template``) train
    shardings on ``mesh``."""
    params = build_model(cfg).init(0, device="meta")
    template = state.checkpoint_template(params, adamw.init_state(params),
                                         cfg)
    return template, sharding.param_shardings(
        template, sharding.make_rules(mesh), "train")


def save_case(rank, mshape, arch, params_np, directory):
    """The rank's blocks of ``params_np`` (and zero moments) placed by the
    train specs on ``mshape`` and saved as one checkpoint at step 1."""
    mesh = make_mesh(mshape, AXES, device="cpu")
    cfg = get_smoke_config(arch)
    params = state.params_from_jax(params_np, cfg, device="cpu")
    _, sh = _shardings(cfg, mesh)
    tree = state.checkpoint_tree(params, adamw.init_state(params), cfg)
    local = sharding.place(tree, sh)
    store = CheckpointStore(directory)
    store.save(1, local, extra={"mesh": list(mshape)}, shardings=sh).result()
    return {"local_shapes": [tuple(t.shape) for t in
                             sharding.tree_leaves(local)]}


def restore_case(rank, mshape, arch, directory):
    """``resize`` of the checkpoint onto the ``mshape`` mesh: the rank's
    blocks' shapes, and the whole tree gathered back (on rank 0), with
    bf16 leaves as their bits."""
    mesh = make_mesh(mshape, AXES, device="cpu")
    cfg = get_smoke_config(arch)
    template, sh = _shardings(cfg, mesh)
    local, extra, step = elastic.resize(CheckpointStore(directory), template,
                                        mesh)
    for blk, leaf, s in zip(sharding.tree_leaves(local),
                            sharding.tree_leaves(template),
                            sharding.tree_leaves(sh), strict=True):
        assert tuple(blk.shape) == s.shard_shape(leaf.shape)
        assert blk.device.type == "cpu" and blk.is_contiguous()
    whole = sharding.gather_tree(local, sh)
    out = {"step": step, "extra": extra,
           "local_shapes": [tuple(t.shape) for t in
                            sharding.tree_leaves(local)]}
    if rank == 0:
        out["whole"] = whole
    return out
