"""Uniform model interface, for the families the port runs so far: the
dense decoder-only transformer and the pure-SSM LM (mamba2)."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable

from ..configs.base import ModelConfig
from . import ssm_lm, transformer

# families the port does not run yet -> the ROADMAP item that brings them
_WAITING = {
    "moe": "Queue 2 item 6 (models/moe.py)",
    "vlm": "Queue 2 item 6 (the early-fusion VLM family)",
    "encdec": "Queue 2 item 6 (models/encdec.py)",
    "audio": "Queue 2 item 6 (models/encdec.py)",
    "hybrid": "Queue 2 item 6 (zamba2: ssd_scan plus a shared attention "
              "block over a dense KV cache)",
}


@dataclass(frozen=True)
class Model:
    cfg: ModelConfig
    init: Callable[..., Any]        # (seed, device=None) -> params
    forward: Callable[..., Any]     # (params, batch) -> logits
    # (params, tokens) -> (last-token logits, kv); dense family only
    prefill: Callable[..., Any] | None = None
    # (batch, max_len=0, device=None) -> cache; ssm family only
    init_cache: Callable[..., Any] | None = None
    # (params, cache, token, pos) -> (logits, cache); ssm family only
    decode_step: Callable[..., Any] | None = None


def build_model(cfg: ModelConfig) -> Model:
    if cfg.family == "dense":
        return Model(
            cfg=cfg,
            init=lambda seed, device=None: transformer.init_params(
                seed, cfg, device),
            forward=lambda p, b: transformer.forward(p, b["tokens"], cfg)[0],
            prefill=lambda p, tokens: transformer.prefill(p, tokens, cfg),
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
