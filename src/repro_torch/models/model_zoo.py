"""Uniform model interface, for the families the port runs so far (the
dense decoder-only transformer)."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable

from ..configs.base import ModelConfig
from . import transformer

# families the port does not run yet -> the ROADMAP item that brings them
_WAITING = {
    "moe": "Queue 2 item 6 (models/moe.py)",
    "vlm": "Queue 2 item 6 (the early-fusion VLM family)",
    "encdec": "Queue 2 item 6 (models/encdec.py)",
    "audio": "Queue 2 item 6 (models/encdec.py)",
    "ssm": "Queue 1 item 4 (ssd_scan and the SSM families)",
    "hybrid": "Queue 1 item 4 (ssd_scan and the SSM families)",
}


@dataclass(frozen=True)
class Model:
    cfg: ModelConfig
    init: Callable[..., Any]        # (seed, device=None) -> params
    forward: Callable[..., Any]     # (params, batch) -> logits
    prefill: Callable[..., Any]     # (params, tokens) -> (logits, kv)


def build_model(cfg: ModelConfig) -> Model:
    if cfg.family == "dense":
        return Model(
            cfg=cfg,
            init=lambda seed, device=None: transformer.init_params(
                seed, cfg, device),
            forward=lambda p, b: transformer.forward(p, b["tokens"], cfg)[0],
            prefill=lambda p, tokens: transformer.prefill(p, tokens, cfg),
        )
    if cfg.family in _WAITING:
        raise NotImplementedError(
            f"family {cfg.family!r} is not ported yet: ROADMAP "
            f"{_WAITING[cfg.family]}")
    raise ValueError(f"unknown family {cfg.family!r}")
