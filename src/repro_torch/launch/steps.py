"""Single-card step functions of the serving path (the bodies of the
reference's ``launch/steps.py`` prefill and decode steps, without a
mesh, shardings or a ``StepBundle``), for the SSM family."""

from __future__ import annotations

import torch

from ..models import ssm_lm
from ..models.layers import unembed


def _check_family(cfg) -> None:
    if cfg.family != "ssm":
        raise NotImplementedError(
            f"family {cfg.family!r}: the step functions run the ssm family "
            "(the dense family serves through launch/serve.py; the others "
            "wait for ROADMAP Queue 2 item 6)")


def prefill_step(params: dict, tokens: torch.Tensor, cfg) -> torch.Tensor:
    """tokens: (B, S) -> last-token logits (B, V) f32: ``ssm_lm.hidden``
    and the tied unembed of the last position only (the (B, S, V) logits
    never materialise)."""
    _check_family(cfg)
    x = ssm_lm.hidden(params, tokens, cfg)
    return unembed(params, x[:, -1:], cfg.replace(tie_embeddings=True))[:, 0]


def serve_step(params: dict, cache: dict, token: torch.Tensor, pos, cfg):
    """One recurrent decode step: token (B,) -> (logits (B, V) f32,
    cache)."""
    _check_family(cfg)
    return ssm_lm.decode_step(params, cache, token, pos, cfg)
