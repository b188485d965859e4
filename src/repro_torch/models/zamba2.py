"""Zamba2-style hybrid (zamba2-1.2b, arXiv:2411.15242): a Mamba2 backbone
with one *shared* attention block -- one set of weights, applied after
every ``attn_every`` mamba layers.

Parameters are a dict: ``layers``, a list of one dict per mamba layer
(``ln``, ``mamba``: see mamba2.py); ``shared``, one dict (``ln1``,
``attn``, ``ln2``, ``mlp``) that every site uses; ``embed`` (V, d),
``ln_f`` (d,) and an untied ``head`` (d, V). The layers fall into
``groups`` of ``every`` layers, each followed by the shared block, and
``tail`` layers after the last group (``_group_shape``). The reference
scans groups and tail with ``lax.scan``; here a Python loop walks the
layers. ``loss_fn`` is the cross entropy of the untied head; under
``cfg.remat == "full"`` each mamba layer is checkpointed, in the groups and
the tail, and the shared block is not (as in the reference). Every site
reads the one ``shared`` dict, so its gradient is the sum over the sites.

Serving: the cache holds a mamba state per layer and one dense KV pair
per shared-block site, (groups, B, S, KH, D) each; ``decode_step``
writes the token's k and v into it in place.
"""

from __future__ import annotations

import torch

from ..device import resolve_device
from . import check_family
from .layers import (PARAM_DTYPE, attention_block, attention_decode,
                     attn_init, chunked_cross_entropy, cross_entropy,
                     embed_init, generator, head_init, mlp, mlp_init,
                     position_ids, remat, rmsnorm, rmsnorm_init, unembed)
from .mamba2 import mamba_block, mamba_decode, mamba_init, mamba_state_init


def _group_shape(cfg):
    """(every, groups, tail): ``attn_every`` 0 makes one group of all the
    layers."""
    every = cfg.attn_every or cfg.num_layers
    groups = cfg.num_layers // every
    return every, groups, cfg.num_layers - groups * every


def _site_after(cfg, li: int):
    """The shared-block site that follows mamba layer ``li``, or None (a
    layer inside a group, or a tail layer)."""
    every, groups, _ = _group_shape(cfg)
    if li < groups * every and (li + 1) % every == 0:
        return li // every
    return None


def init_params(seed: int, cfg, device=None) -> dict:
    """Random weights at cfg's widths from a ``torch.Generator`` seeded
    with ``seed`` on ``device`` (the card unless ``device="cpu"``). The
    draws are not the reference's; the layout, the types (f32 ``a_log``,
    ``dt_bias``, ``d_skip``) and the distributions are."""
    check_family(cfg, "zamba2")
    dev = resolve_device(device)
    gen = generator(seed, dev)
    layers = [{"ln": rmsnorm_init(cfg.d_model, dev),
               "mamba": mamba_init(gen, cfg)} for _ in range(cfg.num_layers)]
    shared = {"ln1": rmsnorm_init(cfg.d_model, dev),
              "attn": attn_init(gen, cfg),
              "ln2": rmsnorm_init(cfg.d_model, dev),
              "mlp": mlp_init(gen, cfg)}
    return {"layers": layers, "shared": shared,
            "embed": embed_init(gen, cfg),
            "ln_f": rmsnorm_init(cfg.d_model, dev),
            "head": head_init(gen, cfg)}


def _mamba_layer(lp: dict, x: torch.Tensor, cfg) -> torch.Tensor:
    return x + mamba_block(lp["mamba"], rmsnorm(lp["ln"], x, cfg.norm_eps),
                           cfg)


def _shared_attn(sp: dict, x: torch.Tensor, cfg,
                 positions: torch.Tensor) -> torch.Tensor:
    h = x + attention_block(sp["attn"], rmsnorm(sp["ln1"], x, cfg.norm_eps),
                            cfg, positions)
    return h + mlp(sp["mlp"], rmsnorm(sp["ln2"], h, cfg.norm_eps), cfg)


def hidden(params: dict, tokens: torch.Tensor, cfg) -> torch.Tensor:
    """tokens: (B, S) int -> final normed hidden (B, S, d): on the card one
    ssd_scan launch a mamba layer and one flash_attention launch (causal)
    a shared-block site; under ``cfg.remat == "full"`` the backward runs
    each mamba layer's again."""
    check_family(cfg, "zamba2")
    b, s = tokens.shape
    x = params["embed"][tokens.long()]
    positions = position_ids(b, s, x.device)
    for li, lp in enumerate(params["layers"]):
        x = remat(cfg, _mamba_layer, lp, x, cfg)
        if _site_after(cfg, li) is not None:
            x = _shared_attn(params["shared"], x, cfg, positions)
    return rmsnorm(params["ln_f"], x, cfg.norm_eps)


def forward(params: dict, tokens: torch.Tensor, cfg):
    """tokens: (B, S) int -> logits (B, S, V) f32, aux {}."""
    return unembed(params, hidden(params, tokens, cfg), cfg), {}


def loss_fn(params: dict, batch: dict, cfg):
    """The chunked cross entropy of the untied head under
    ``cfg.loss_chunk``, else the dense one (with ``batch``'s optional
    ``mask``). Returns (loss, {"loss"})."""
    x = hidden(params, batch["tokens"], cfg)
    if cfg.loss_chunk:
        loss = chunked_cross_entropy(params, x, batch["labels"], cfg,
                                     cfg.loss_chunk)
    else:
        loss = cross_entropy(unembed(params, x, cfg), batch["labels"],
                             batch.get("mask"))
    return loss, {"loss": loss}


def init_cache(cfg, batch: int, max_len: int, dtype=PARAM_DTYPE,
               device=None) -> dict:
    """Zero decode state on ``device`` (the card unless ``"cpu"``): a mamba
    state per layer, and ``k`` and ``v`` (groups, B, max_len, KH, D) of
    ``dtype``, one slice a shared-block site."""
    check_family(cfg, "zamba2")
    dev = resolve_device(device)
    _, groups, _ = _group_shape(cfg)
    shape = (groups, batch, max_len, cfg.num_kv_heads, cfg.hd)
    return {"mamba": [mamba_state_init(cfg, batch, device=dev)
                      for _ in range(cfg.num_layers)],
            "k": torch.zeros(shape, dtype=dtype, device=dev),
            "v": torch.zeros(shape, dtype=dtype, device=dev)}


def decode_step(params: dict, cache: dict, token: torch.Tensor, pos, cfg):
    """token: (B,) int; pos: the position written (an int). Returns
    (logits (B, V) f32, new cache): each layer's new mamba state, and the
    KV caches updated in place at ``pos``."""
    check_family(cfg, "zamba2")
    x = params["embed"][token.long()[:, None]]
    sp = params["shared"]
    states = []
    for li, (lp, st) in enumerate(zip(params["layers"], cache["mamba"],
                                      strict=True)):
        y, st2 = mamba_decode(lp["mamba"], rmsnorm(lp["ln"], x, cfg.norm_eps),
                              cfg, st)
        x = x + y
        states.append(st2)
        site = _site_after(cfg, li)
        if site is not None:
            y, _, _ = attention_decode(sp["attn"],
                                       rmsnorm(sp["ln1"], x, cfg.norm_eps),
                                       cfg, cache["k"][site],
                                       cache["v"][site], pos)
            h = x + y
            x = h + mlp(sp["mlp"], rmsnorm(sp["ln2"], h, cfg.norm_eps), cfg)
    x = rmsnorm(params["ln_f"], x, cfg.norm_eps)
    return unembed(params, x, cfg)[:, 0], {"mamba": states, "k": cache["k"],
                                           "v": cache["v"]}
