"""AdamW with its schedule and gradient compression: the port's copy of
the reference's ``optim/adamw.py``, as plain functions on tensors.

The optimizer state is f32 whatever the parameters' type: ``mu`` and
``nu`` are trees shaped like the parameters (dicts, and the per-layer
lists of ``state.STACKS``), ``step`` an int32 0-d tensor, all on the
parameters' device. ``apply_updates`` runs under ``torch.no_grad()`` in
f32 and casts each parameter back to its own type. The reference's train
step donates the parameters and the state; here they are updated in
place.

On a mesh of ranks the parameters, gradients and moments are each rank's
blocks (``distributed/sharding.py``): ``apply_updates`` stays elementwise
on them, and ``global_norm`` given their shardings sums every element once
over the mesh.

Weight decay follows the rank a leaf has in the reference's tree, where
each layer list is stacked on a leading axis (``state.reference_ndim``):
a layer's (d,) norm or bias is decayed there, as an (L, d) leaf, and so
here; ``ln_f`` and zamba2's unstacked ``shared`` norms are not.

Gradient compression (for a slow cross-pod link): symmetric int8 and
top-k sparsification, each with error feedback.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from ..distributed import collectives
from ..distributed.sharding import zip_leaves
from ..state import reference_ndim


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1


def leaves(tree, path: tuple = ()):
    """(path, leaf) of every tensor of a tree of dicts and lists, in
    insertion and index order."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from leaves(v, path + (k,))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from leaves(v, path + (i,))
    else:
        yield path, tree


def tree_map(fn, tree):
    """``fn`` of every leaf of a tree of dicts and lists, in its shape."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_map(fn, v) for v in tree]
    return fn(tree)


def schedule(cfg: AdamWConfig, step) -> torch.Tensor:
    """The learning rate at ``step`` (an int or a tensor) as an f32 0-d
    tensor on the step's device: a linear warmup over ``warmup_steps``,
    then a cosine down to ``min_lr_ratio`` x ``lr`` at ``total_steps``."""
    step = step.float() if isinstance(step, torch.Tensor) \
        else torch.tensor(float(step), dtype=torch.float32)
    warm = step / max(cfg.warmup_steps, 1)
    decay_steps = max(cfg.total_steps - cfg.warmup_steps, 1)
    t = torch.clamp((step - cfg.warmup_steps) / decay_steps, 0.0, 1.0)
    cos = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) \
        * 0.5 * (1 + torch.cos(math.pi * t))
    return cfg.lr * torch.where(step < cfg.warmup_steps, warm, cos)


def init_state(params) -> dict:
    """Zero f32 ``mu`` and ``nu`` shaped like ``params`` and step 0, on the
    parameters' device."""
    dev = next(t for _, t in leaves(params)).device
    zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                  device=p.device)
    return {"mu": tree_map(zeros, params), "nu": tree_map(zeros, params),
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def global_norm(tree, shardings=None) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in f32, summed leaf by
    leaf. With ``shardings`` (a matching tree of ``NamedSharding`` on a
    mesh of ranks) the leaves are the rank's blocks: a block held by
    several ranks (a leaf replicated over some axes) adds on the first of
    them only, and the sum is all-reduced over the mesh, so every element
    of the whole tree counts once."""
    if shardings is None:
        return torch.sqrt(sum(torch.sum(torch.square(x.float()))
                              for _, x in leaves(tree)))
    pairs = zip_leaves(tree, shardings)
    blocks = [torch.sum(torch.square(x.float())) for x, sh in pairs
              if sh.first_holder()]
    mesh = pairs[0][1].mesh
    total = sum(blocks) if blocks else torch.zeros(
        (), dtype=torch.float32, device=mesh.device)
    return torch.sqrt(collectives.psum(total, mesh.axis_names, mesh))


def apply_updates(params, grads, state: dict, cfg: AdamWConfig,
                  shardings=None):
    """One AdamW step with the gradients clipped to a global norm of
    ``grad_clip``. ``params``, ``state["mu"]``, ``state["nu"]`` and
    ``state["step"]`` are updated in place (the reference's step donates
    them) and returned: (params, state, {"grad_norm", "lr"}). On a mesh of
    ranks every tree holds the rank's blocks and ``shardings`` the
    parameters' (``global_norm``)."""
    with torch.no_grad():
        step = state["step"] + 1
        gnorm = global_norm(grads, shardings)
        scale = torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-9),
                            max=1.0)
        lr = schedule(cfg, step)
        b1c = 1 - cfg.b1 ** step.float()
        b2c = 1 - cfg.b2 ** step.float()
        flat = zip(leaves(params), (g for _, g in leaves(grads)),
                   (m for _, m in leaves(state["mu"])),
                   (n for _, n in leaves(state["nu"])), strict=True)
        for (path, p), g, mu, nu in flat:
            g = g.float() * scale
            mu.copy_(cfg.b1 * mu + (1 - cfg.b1) * g)
            nu.copy_(cfg.b2 * nu + (1 - cfg.b2) * g * g)
            delta = (mu / b1c) / (torch.sqrt(nu / b2c) + cfg.eps)
            if reference_ndim(path, p) >= 2:           # decay matrices only
                delta = delta + cfg.weight_decay * p.float()
            p.copy_((p.float() - lr * delta).to(p.dtype))
        state["step"].copy_(step)
    return params, state, {"grad_norm": gnorm, "lr": lr}


# ---------------------------------------------------------------------------
# gradient compression (cross-pod all-reduce volume reduction)
# ---------------------------------------------------------------------------
def compress_int8(g: torch.Tensor):
    """Symmetric per-tensor int8 quantization. Returns (q, scale)."""
    gf = g.float()
    scale = torch.clamp(gf.abs().max(), min=1e-12) / 127.0
    q = torch.clamp(torch.round(gf / scale), -127, 127).to(torch.int8)
    return q, scale


def decompress_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def topk_sparsify(g: torch.Tensor, frac: float = 0.05):
    """Keep the entries whose magnitude is at least the k-th largest (k =
    ``frac`` of them, at least 1; ties at the threshold all kept). Returns
    (sparse g, residual); the residual is fed back next step (error
    feedback)."""
    flat = g.reshape(-1).float()
    k = max(int(flat.shape[0] * frac), 1)
    thresh = torch.topk(flat.abs(), k).values[-1]
    mask = flat.abs() >= thresh
    kept = torch.where(mask, flat, 0.0).reshape(g.shape)
    return kept, flat.reshape(g.shape) - kept


def compressed_grad(g: torch.Tensor, residual: torch.Tensor,
                    mode: str = "int8", topk_frac: float = 0.05):
    """One step of compression with error feedback. Returns (g_hat,
    new residual); g_hat is what crosses the slow link. A mode other than
    "int8" and "topk" sends g uncompressed."""
    g = g.float() + residual
    if mode == "int8":
        g_hat = decompress_int8(*compress_int8(g))
    elif mode == "topk":
        return topk_sparsify(g, topk_frac)
    else:
        return g, torch.zeros_like(g)
    return g_hat, g - g_hat
