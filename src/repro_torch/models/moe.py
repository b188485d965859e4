"""Mixture-of-Experts feed-forward (OLMoE / Granite-MoE style).

Top-k routing with capacity buckets and gather/scatter dispatch, the
reference's single-partition path (``_moe_ff_ref``): the softmax router
in f32, ``top_k`` with the gates renormalised, each expert's bucket
positions from a stable argsort, tokens past the capacity dropped, the
SwiGLU experts batched over E, and the outputs gathered back weighted by
gate and keep. Experts are stacked on a leading axis: ``router`` (d, E)
f32, ``wi`` and ``wg`` (E, d, ff) and ``wo`` (E, ff, d) bf16.

The expert products are batched matrix products, as the reference leaves
them to XLA outside any kernel. Under an activation-sharding policy on a
mesh of ranks, ``moe_ff`` takes the reference's expert-parallel path
(``moe_ff_sharded``: the rank's tokens dispatched locally, two
all-to-alls over the model axis) on the reference's conditions, and
otherwise runs the single-partition path on the whole batch gathered to
every rank.
"""

from __future__ import annotations

import torch

from ..distributed import act_sharding, collectives
from .layers import PARAM_DTYPE, dense_init, randn


def moe_init(gen: torch.Generator, cfg) -> dict:
    """Random router and experts drawn from ``gen`` on its device."""
    d, ff, e = cfg.d_model, cfg.d_ff, cfg.num_experts
    scale = (2.0 / (d + ff)) ** 0.5

    def experts(shape):
        return (randn(shape, gen) * scale).to(PARAM_DTYPE)

    return {"router": dense_init(gen, d, e, torch.float32),
            "wi": experts((e, d, ff)), "wg": experts((e, d, ff)),
            "wo": experts((e, ff, d))}


def moe_ff(p: dict, x: torch.Tensor, cfg,
           capacity_factor: float | None = None):
    """x: (B, S, d) -> (B, S, d) in x's type, and the aux dict:
    ``load_balance`` (switch-style), ``expert_load`` (E,) (each expert's
    share of the T*k choices, dropped ones included) and ``router_z``.

    The capacity is ``max(int(T * k / E * capacity_factor), 1)`` for T
    tokens, as in the reference: at batch 4 of olmoe's decode (k 8 of 64
    experts) it is 1 a step, so most choices are dropped there too.

    On a mesh of ranks x is the rank's block (B/D, S/M, d). With more than
    one rank on the model axis and E a multiple of them (the reference's
    conditions; the layout makes the batch and the sequence divide), this
    is ``moe_ff_sharded``; otherwise the whole batch is gathered to every
    rank, routed at the whole batch's capacity as the reference routes
    it, and each rank keeps its block of the output. In a decode step (the
    rows layout) x is the rank's rows, whole on every model rank: the rows
    are gathered over the data axes and routed at the whole batch's
    capacity, and each rank keeps its rows."""
    if capacity_factor is None:
        capacity_factor = cfg.moe_capacity_factor
    pol = act_sharding.ranks()
    if pol is None:
        rows = act_sharding.rows()
        if rows is None:
            return _moe_ff_single(p, x, cfg, capacity_factor)
        # a decode step: the rows over the data axes, whole on every model
        # rank; route the whole batch, keep the rank's rows
        b = x.shape[0]
        xg = collectives.all_gather(x, 0, rows.data_axes, rows.mesh)
        y, aux = _moe_ff_single(p, xg, cfg, capacity_factor)
        return y.narrow(0, rows.mesh.index(rows.data_axes) * b, b), aux
    mesh, data_axes, model_axis = pol.mesh, pol.data_axes, pol.model_axis
    m = mesh.shape[model_axis]
    if m > 1 and cfg.num_experts % m == 0:
        return moe_ff_sharded(p, x, cfg, mesh, data_axes, model_axis,
                              capacity_factor)
    b, s = x.shape[:2]
    xg = collectives.all_gather(
        collectives.all_gather(x, 0, data_axes, mesh), 1, model_axis, mesh)
    y, aux = _moe_ff_single(p, xg, cfg, capacity_factor)
    y = y.narrow(0, mesh.index(data_axes) * b, b)
    return y.narrow(1, mesh.coord(model_axis) * s, s), aux


def _dispatch(xf: torch.Tensor, router: torch.Tensor, k: int, e: int,
              capacity: int):
    """Route the (T, d) tokens ``xf``: (logits, probs, gate, flat_idx,
    counts, slot, keep, token_of, buckets (E, C, d))."""
    t, d = xf.shape
    dev = xf.device
    logits = xf.float() @ router                               # (T, E)
    probs = torch.softmax(logits, dim=-1)
    gate, idx = torch.topk(probs, k, dim=-1)                   # (T, k)
    gate = gate / torch.clamp(gate.sum(-1, keepdim=True), min=1e-9)

    # each (token, choice)'s place in its expert's bucket, from a stable
    # sort of the choices by expert
    flat_idx = idx.reshape(-1)                                 # (T*k,)
    # bincount as a scatter, which also runs on meta (the dry run)
    counts = torch.zeros(e, dtype=torch.int64, device=dev).index_add_(
        0, flat_idx, torch.ones_like(flat_idx))                # (E,)
    starts = torch.cumsum(counts, 0) - counts
    order = torch.argsort(flat_idx, stable=True)
    rank_sorted = torch.arange(t * k, device=dev) - starts[flat_idx[order]]
    pos = torch.empty_like(rank_sorted)
    pos[order] = rank_sorted
    keep = pos < capacity

    # the tokens into (E, C, d) buckets; a dropped choice lands in an
    # extra bucket E, which is cut off (the reference's mode="drop")
    token_of = torch.arange(t, device=dev).repeat_interleave(k)
    slot = torch.clamp(pos, max=capacity - 1)
    buckets = torch.zeros((e + 1, capacity, d), dtype=xf.dtype, device=dev)
    buckets[torch.where(keep, flat_idx, e), slot] = xf[token_of]
    return (logits, probs, gate, flat_idx, counts, slot, keep, token_of,
            buckets[:e])


def _experts(buckets: torch.Tensor, wi: torch.Tensor, wg: torch.Tensor,
             wo: torch.Tensor) -> torch.Tensor:
    """The SwiGLU experts on their buckets, batched over E."""
    hid = torch.nn.functional.silu(torch.bmm(buckets, wg).float()) \
        * torch.bmm(buckets, wi).float()
    return torch.bmm(hid.to(buckets.dtype), wo)               # (E, C, d)


def _combine(out_b, flat_idx, slot, gate, keep, token_of, t: int):
    """The experts' outputs gathered back to the T tokens, weighted by
    gate and keep."""
    e = out_b.shape[0]
    contrib = out_b[torch.clamp(flat_idx, max=e - 1), slot] \
        * (gate.reshape(-1) * keep)[:, None].to(out_b.dtype)
    return torch.zeros((t, out_b.shape[2]), dtype=out_b.dtype,
                       device=out_b.device).index_add_(0, token_of, contrib)


def _moe_ff_single(p: dict, x: torch.Tensor, cfg, capacity_factor: float):
    """The reference's single-partition path (``_moe_ff_ref``)."""
    b, s, d = x.shape
    e, k = cfg.num_experts, cfg.experts_per_token
    t = b * s
    capacity = max(int(t * k / e * capacity_factor), 1)
    logits, probs, gate, flat_idx, counts, slot, keep, token_of, buckets = \
        _dispatch(x.reshape(t, d), p["router"], k, e, capacity)
    out_b = _experts(buckets, p["wi"], p["wg"], p["wo"])
    y = _combine(out_b, flat_idx, slot, gate, keep, token_of, t)
    me = probs.mean(dim=0)                                     # (E,)
    ce = counts.float() / (t * k)
    aux = {"load_balance": e * torch.sum(me * ce), "expert_load": ce,
           "router_z": torch.mean(torch.logsumexp(logits, dim=-1) ** 2)}
    return y.reshape(b, s, d), aux


def moe_ff_sharded(p: dict, x: torch.Tensor, cfg, mesh, data_axes: tuple,
                   model_axis: str, capacity_factor: float = 1.25):
    """The reference's expert-parallel path (``moe_ff_sharded``,
    src/repro/models/moe.py:155) on a mesh of ranks: x (B/D, S/M, d) is
    the rank's block of the tokens (rows over ``data_axes``, the sequence
    over ``model_axis``), ``p`` the layer's whole router and experts.

    The rank routes its t tokens at the reference's local capacity
    ``max(int(t * k / E * capacity_factor), 1)`` into (E, C, d) buckets;
    an all-to-all over the model axis sends each expert's bucket to the
    rank that owns it, (E/M, M*C, d) (``act_sharding.constrain_experts``);
    the rank runs the SwiGLU of its E/M experts (their slice of ``p``'s
    experts, a view); the inverse all-to-all brings the outputs back for
    the gate-weighted combine. ``load_balance``, ``router_z`` and
    ``expert_load`` are the rank's, averaged over the data axes and, with
    more than one rank on it, the model axis, as the reference averages
    them. Needs E a multiple of the model axis' size; at one rank there
    the all-to-alls and averages are the identity and this is ``moe_ff``
    bit for bit."""
    bl, sl, d = x.shape
    e, k = cfg.num_experts, cfg.experts_per_token
    m = mesh.shape[model_axis]
    if e % m:
        raise ValueError(f"{e} experts do not divide over the {m} ranks of "
                         f"{model_axis!r}")
    t = bl * sl
    capacity = max(int(t * k / e * capacity_factor), 1)
    logits, probs, gate, flat_idx, counts, slot, keep, token_of, buckets = \
        _dispatch(x.reshape(t, d), p["router"], k, e, capacity)
    e0, el = mesh.coord(model_axis) * (e // m), e // m
    with act_sharding.activation_sharding(mesh, data_axes, model_axis):
        recv = act_sharding.constrain_experts(buckets)        # (E/M, M*C, d)
        out_e = _experts(recv, *(p[w][e0:e0 + el] for w in ("wi", "wg",
                                                            "wo")))
        back = act_sharding.release_experts(out_e)             # (E, C, d)
    y = _combine(back, flat_idx, slot, gate, keep, token_of, t)
    me = probs.mean(dim=0)
    ce = counts.float() / (t * k)
    lb = e * torch.sum(me * ce)
    rz = torch.mean(torch.logsumexp(logits, dim=-1) ** 2)
    axes = tuple(data_axes) + ((model_axis,) if m > 1 else ())
    aux = {"load_balance": collectives.pmean(lb, axes, mesh),
           "expert_load": collectives.pmean(ce, axes, mesh),
           "router_z": collectives.pmean(rz, axes, mesh)}
    return y.reshape(bl, sl, d), aux
