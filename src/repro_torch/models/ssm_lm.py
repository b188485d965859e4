"""Pure-SSM LM (mamba2-2.7b): an attention-free stack of Mamba2 blocks
with tied embeddings. Decode carries O(1) recurrent state per layer.

Parameters are a dict: ``embed`` (V, d), ``ln_f`` (d,) and ``layers``, a
list of one dict per layer (``ln``, ``mamba``: see mamba2.py). The cache
is {"mamba": a list of one {"conv", "ssm"} state per layer}. The
reference stacks both on a leading axis for ``lax.scan``; here a Python
loop walks the lists. ``loss_fn`` is the cross entropy of the tied head;
under ``cfg.remat == "full"`` each block is checkpointed.
"""

from __future__ import annotations

import torch

from ..device import resolve_device
from . import check_family
from .layers import (chunked_cross_entropy, cross_entropy, embed_init,
                     generator, remat, rmsnorm, rmsnorm_init, unembed)
from .mamba2 import mamba_block, mamba_decode, mamba_init, mamba_state_init


def init_params(seed: int, cfg, device=None) -> dict:
    """Random weights at cfg's widths from a ``torch.Generator`` seeded
    with ``seed`` on ``device`` (the card unless ``device="cpu"``). The
    draws are not the reference's; the layout, the types (f32 ``a_log``,
    ``dt_bias``, ``d_skip``) and the distributions are."""
    check_family(cfg, "ssm_lm")
    dev = resolve_device(device)
    gen = generator(seed, dev)
    layers = [{"ln": rmsnorm_init(cfg.d_model, dev),
               "mamba": mamba_init(gen, cfg)} for _ in range(cfg.num_layers)]
    return {"layers": layers, "embed": embed_init(gen, cfg),
            "ln_f": rmsnorm_init(cfg.d_model, dev)}


def hidden(params: dict, tokens: torch.Tensor, cfg) -> torch.Tensor:
    """tokens: (B, S) int -> final normed hidden (B, S, d); one ssd_scan
    launch per layer on the card (and one more in the backward under
    ``cfg.remat == "full"``, which checkpoints each block)."""
    check_family(cfg, "ssm_lm")
    x = params["embed"][tokens.long()]
    for lp in params["layers"]:
        x = remat(cfg, _layer, lp, x, cfg)
    return rmsnorm(params["ln_f"], x, cfg.norm_eps)


def _layer(lp: dict, x: torch.Tensor, cfg) -> torch.Tensor:
    return x + mamba_block(lp["mamba"], rmsnorm(lp["ln"], x, cfg.norm_eps),
                           cfg)


def _tied(cfg):
    return cfg.replace(tie_embeddings=True)    # mamba2 ties embeddings


def forward(params: dict, tokens: torch.Tensor, cfg):
    """tokens: (B, S) int -> logits (B, S, V) f32, aux {}."""
    return unembed(params, hidden(params, tokens, cfg), _tied(cfg)), {}


def loss_fn(params: dict, batch: dict, cfg):
    """The chunked cross entropy of the tied head under ``cfg.loss_chunk``,
    else the dense one (with ``batch``'s optional ``mask``). Returns
    (loss, {"loss"})."""
    x = hidden(params, batch["tokens"], cfg)
    if cfg.loss_chunk:
        loss = chunked_cross_entropy(params, x, batch["labels"], _tied(cfg),
                                     cfg.loss_chunk)
    else:
        loss = cross_entropy(unembed(params, x, _tied(cfg)), batch["labels"],
                             batch.get("mask"))
    return loss, {"loss": loss}


def init_cache(cfg, batch: int, max_len: int = 0, device=None) -> dict:
    """Zero recurrent state for every layer on ``device`` (the card unless
    ``device="cpu"``). ``max_len`` is the reference's and unused: the
    state is O(1) in the length."""
    check_family(cfg, "ssm_lm")
    dev = resolve_device(device)
    return {"mamba": [mamba_state_init(cfg, batch, device=dev)
                      for _ in range(cfg.num_layers)]}


def decode_step(params: dict, cache: dict, token: torch.Tensor, pos, cfg):
    """token: (B,) int -> (logits (B, V) f32, new cache). ``pos`` is the
    reference's and unused: the state carries the position."""
    x = params["embed"][token.long()[:, None]]
    states = []
    for lp, st in zip(params["layers"], cache["mamba"], strict=True):
        y, st2 = mamba_decode(lp["mamba"], rmsnorm(lp["ln"], x, cfg.norm_eps),
                              cfg, st)
        x = x + y
        states.append(st2)
    x = rmsnorm(params["ln_f"], x, cfg.norm_eps)
    return unembed(params, x, _tied(cfg))[:, 0], {"mamba": states}


def decode_multi(params: dict, cache: dict, tokens: torch.Tensor, pos, cfg):
    """Decode T known tokens (B, T) one after another. Returns (logits
    (B, T, V), cache)."""
    logits = []
    for t in range(tokens.shape[1]):
        step, cache = decode_step(params, cache, tokens[:, t], pos, cfg)
        logits.append(step)
    return torch.stack(logits, dim=1), cache
