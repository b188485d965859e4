"""Uniform model interface, for the families the port runs so far: the
decoder-only transformer (dense, MoE and VLM families) and the pure-SSM
LM (mamba2)."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable

import torch

from ..configs.base import ModelConfig
from ..device import resolve_device
from . import ssm_lm, transformer

# families the port does not run yet -> the ROADMAP item that brings them
_WAITING = {
    "encdec": "Queue 2 item 6 (models/encdec.py)",
    "audio": "Queue 2 item 6 (models/encdec.py)",
    "hybrid": "Queue 2 item 6 (zamba2: ssd_scan plus a shared attention "
              "block over the dense KV cache)",
}


@dataclass(frozen=True)
class Model:
    cfg: ModelConfig
    init: Callable[..., Any]        # (seed, device=None) -> params
    forward: Callable[..., Any]     # (params, batch) -> logits
    # (params, tokens) -> (last-token logits, kv); transformer families
    prefill: Callable[..., Any] | None = None
    # (batch, max_len[, device=None]) -> cache
    init_cache: Callable[..., Any] | None = None
    # (params, cache, token, pos) -> (logits, cache)
    decode_step: Callable[..., Any] | None = None


def build_model(cfg: ModelConfig) -> Model:
    if cfg.family in transformer.FAMILIES:
        return Model(
            cfg=cfg,
            init=lambda seed, device=None: transformer.init_params(
                seed, cfg, device),
            forward=lambda p, b: transformer.forward(p, b["tokens"], cfg)[0],
            prefill=lambda p, tokens: transformer.prefill(p, tokens, cfg),
            init_cache=lambda batch, max_len, device=None:
                transformer.init_cache(cfg, batch, max_len, device=device),
            decode_step=lambda p, c, t, pos: transformer.decode_step(
                p, c, t, pos, cfg),
        )
    if cfg.family == "ssm":
        return Model(
            cfg=cfg,
            init=lambda seed, device=None: ssm_lm.init_params(
                seed, cfg, device),
            forward=lambda p, b: ssm_lm.forward(p, b["tokens"], cfg)[0],
            init_cache=lambda batch, max_len=0, device=None:
                ssm_lm.init_cache(cfg, batch, max_len, device=device),
            decode_step=lambda p, c, t, pos: ssm_lm.decode_step(
                p, c, t, pos, cfg),
        )
    if cfg.family in _WAITING:
        raise NotImplementedError(
            f"family {cfg.family!r} is not ported yet: ROADMAP "
            f"{_WAITING[cfg.family]}")
    raise ValueError(f"unknown family {cfg.family!r}")


def make_batch(cfg: ModelConfig, batch: int, seq: int,
               gen: torch.Generator | None = None, device=None) -> dict:
    """A random batch (smoke runs, examples): ``tokens`` (B, S) int64
    drawn from ``gen`` on its device (a generator seeded 0 on ``device``,
    the card unless ``"cpu"``, when none is given) and ``labels``, the
    tokens shifted left by one. The encoder families' ``frames`` wait with
    them (ROADMAP Queue 2 item 6)."""
    if cfg.encoder_layers:
        raise NotImplementedError(
            f"family {cfg.family!r} is not ported yet: ROADMAP "
            f"{_WAITING['encdec']}")
    if gen is None:
        gen = torch.Generator(device=resolve_device(device)).manual_seed(0)
    tokens = torch.randint(0, cfg.vocab_size, (batch, seq), generator=gen,
                           device=gen.device)
    return {"tokens": tokens, "labels": torch.roll(tokens, -1, dims=1)}
