"""Uniform model interface over every family of the port: the
decoder-only transformer (dense, MoE and VLM families), the pure-SSM LM
(mamba2), the Mamba2 hybrid (zamba2) and the encoder-decoder (encdec and
audio)."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable

import torch

from ..configs.base import ModelConfig
from ..device import resolve_device
from . import encdec, families_run_by, ssm_lm, transformer, zamba2


@dataclass(frozen=True)
class Model:
    cfg: ModelConfig
    init: Callable[..., Any]        # (seed, device=None) -> params
    loss: Callable[..., Any]        # (params, batch) -> (loss, metrics)
    forward: Callable[..., Any]     # (params, batch) -> logits
    # (params, tokens) -> (last-token logits, kv); transformer families
    prefill: Callable[..., Any] | None = None
    # (batch, max_len[, enc_len for encdec][, device=None]) -> cache
    init_cache: Callable[..., Any] | None = None
    # (params, cache, token, pos) -> (logits, cache)
    decode_step: Callable[..., Any] | None = None


def build_model(cfg: ModelConfig) -> Model:
    if cfg.family in transformer.FAMILIES:
        return Model(
            cfg=cfg,
            init=lambda seed, device=None: transformer.init_params(
                seed, cfg, device),
            loss=lambda p, b: transformer.loss_fn(p, b, cfg),
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
            loss=lambda p, b: ssm_lm.loss_fn(p, b, cfg),
            forward=lambda p, b: ssm_lm.forward(p, b["tokens"], cfg)[0],
            init_cache=lambda batch, max_len=0, device=None:
                ssm_lm.init_cache(cfg, batch, max_len, device=device),
            decode_step=lambda p, c, t, pos: ssm_lm.decode_step(
                p, c, t, pos, cfg),
        )
    if cfg.family == "hybrid":
        return Model(
            cfg=cfg,
            init=lambda seed, device=None: zamba2.init_params(
                seed, cfg, device),
            loss=lambda p, b: zamba2.loss_fn(p, b, cfg),
            forward=lambda p, b: zamba2.forward(p, b["tokens"], cfg)[0],
            init_cache=lambda batch, max_len, device=None:
                zamba2.init_cache(cfg, batch, max_len, device=device),
            decode_step=lambda p, c, t, pos: zamba2.decode_step(
                p, c, t, pos, cfg),
        )
    if cfg.family in families_run_by("encdec"):
        return Model(
            cfg=cfg,
            init=lambda seed, device=None: encdec.init_params(
                seed, cfg, device),
            loss=lambda p, b: encdec.loss_fn(p, b, cfg),
            forward=lambda p, b: encdec.forward(p, b["frames"], b["tokens"],
                                                cfg)[0],
            init_cache=lambda batch, max_len, enc_len=1024, device=None:
                encdec.init_cache(cfg, batch, max_len, enc_len,
                                  device=device),
            decode_step=lambda p, c, t, pos: encdec.decode_step(
                p, c, t, pos, cfg),
        )
    raise ValueError(f"unknown family {cfg.family!r}")


def make_batch(cfg: ModelConfig, batch: int, seq: int,
               gen: torch.Generator | None = None, device=None) -> dict:
    """A random batch (smoke runs, examples): ``tokens`` (B, S) int64
    drawn from ``gen`` on its device (a generator seeded 0 on ``device``,
    the card unless ``"cpu"``, when none is given) and ``labels``, the
    tokens shifted left by one; with an encoder, also ``frames`` (B, S, d)
    f32, normal draws times 0.02 (one ``seq`` for both, as the
    reference's)."""
    if gen is None:
        gen = torch.Generator(device=resolve_device(device)).manual_seed(0)
    tokens = torch.randint(0, cfg.vocab_size, (batch, seq), generator=gen,
                           device=gen.device)
    out = {"tokens": tokens, "labels": torch.roll(tokens, -1, dims=1)}
    if cfg.encoder_layers:
        out["frames"] = torch.randn((batch, seq, cfg.d_model), generator=gen,
                                    device=gen.device,
                                    dtype=torch.float32) * 0.02
    return out
