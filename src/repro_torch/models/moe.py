"""Mixture-of-Experts feed-forward (OLMoE / Granite-MoE style).

Top-k routing with capacity buckets and gather/scatter dispatch, the
reference's single-partition path (``_moe_ff_ref``): the softmax router
in f32, ``top_k`` with the gates renormalised, each expert's bucket
positions from a stable argsort, tokens past the capacity dropped, the
SwiGLU experts batched over E, and the outputs gathered back weighted by
gate and keep. Experts are stacked on a leading axis: ``router`` (d, E)
f32, ``wi`` and ``wg`` (E, d, ff) and ``wo`` (E, ff, d) bf16.

The expert products are batched matrix products, as the reference leaves
them to XLA outside any kernel. The reference's sharded path
(``moe_ff_sharded``: shard_map and all-to-all under a mesh policy) is not
ported: the port has no mesh policy, so ``moe_ff`` always takes this one.
"""

from __future__ import annotations

import torch

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
    experts) it is 1 a step, so most choices are dropped there too."""
    if capacity_factor is None:
        capacity_factor = cfg.moe_capacity_factor
    b, s, d = x.shape
    e, k = cfg.num_experts, cfg.experts_per_token
    t = b * s
    xf = x.reshape(t, d)
    dev = x.device

    logits = xf.float() @ p["router"]                          # (T, E)
    probs = torch.softmax(logits, dim=-1)
    gate, idx = torch.topk(probs, k, dim=-1)                   # (T, k)
    gate = gate / torch.clamp(gate.sum(-1, keepdim=True), min=1e-9)

    capacity = max(int(t * k / e * capacity_factor), 1)
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
    buckets = buckets[:e]

    # the SwiGLU experts, batched over E
    hid = torch.nn.functional.silu(torch.bmm(buckets, p["wg"]).float()) \
        * torch.bmm(buckets, p["wi"]).float()
    out_b = torch.bmm(hid.to(xf.dtype), p["wo"])              # (E, C, d)

    # gathered back, weighted by gate and keep
    contrib = out_b[torch.clamp(flat_idx, max=e - 1), slot] \
        * (gate.reshape(-1) * keep)[:, None].to(xf.dtype)
    y = torch.zeros((t, d), dtype=xf.dtype, device=dev).index_add_(
        0, token_of, contrib)

    me = probs.mean(dim=0)                                     # (E,)
    ce = counts.float() / (t * k)
    aux = {"load_balance": e * torch.sum(me * ce), "expert_load": ce,
           "router_z": torch.mean(torch.logsumexp(logits, dim=-1) ** 2)}
    return y.reshape(b, s, d), aux
