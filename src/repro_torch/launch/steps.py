"""Single-card step functions of the serving path: the bodies of the
reference's ``launch/steps.py:build_prefill_step`` and
``build_decode_step``, without a mesh, shardings or a ``StepBundle``, for
the transformer families (dense, moe, vlm) and the SSM family."""

from __future__ import annotations

import torch

from ..models import ssm_lm, transformer
from ..models.layers import PARAM_DTYPE, unembed


def _check_family(cfg) -> None:
    if cfg.family not in transformer.FAMILIES + ("ssm",):
        raise NotImplementedError(
            f"family {cfg.family!r}: the step functions run the dense, moe, "
            "vlm and ssm families (hybrid and encdec wait for ROADMAP "
            "Queue 2 item 6)")


def prefill_step(params: dict, tokens: torch.Tensor, cfg):
    """tokens: (B, S). The SSM family returns the last-token logits
    (B, V) f32: ``ssm_lm.hidden`` and the tied unembed of the last
    position only. The transformer families return ``prefill``'s
    last-token logits (B, V) and its KV cache (L, B, S, KH, D).

    The reference's transformer step returns ``logits[:, -1]`` of those
    (B, V) logits, the last vocabulary entry of each row, shape (B,)
    (ROADMAP Queue 3); the port returns the logits themselves."""
    _check_family(cfg)
    if cfg.family == "ssm":
        x = ssm_lm.hidden(params, tokens, cfg)
        return unembed(params, x[:, -1:],
                       cfg.replace(tie_embeddings=True))[:, 0]
    return transformer.prefill(params, tokens, cfg)


def init_cache(cfg, batch: int, max_len: int, optimized: bool | str = False,
               dtype=PARAM_DTYPE, device=None) -> dict:
    """The cache ``serve_step`` takes with ``optimized``: for the
    transformer families (L, B, S, KH, D) of ``dtype`` with
    ``optimized=False``, the KH-major (L, B, KH, S, D) otherwise; the SSM
    family's recurrent state whatever ``optimized`` says."""
    _check_family(cfg)
    if cfg.family == "ssm":
        return ssm_lm.init_cache(cfg, batch, max_len, device=device)
    init = transformer.init_cache_v2 if optimized else transformer.init_cache
    return init(cfg, batch, max_len, dtype, device)


def serve_step(params: dict, cache: dict, token: torch.Tensor, pos, cfg,
               optimized: bool | str = False):
    """One decode step: token (B,) -> (logits (B, V) f32, cache), the
    cache updated in place. For the transformer families ``optimized``
    picks the implementation as the reference's ``build_decode_step``:
    False ``decode_step``, "v2" ``decode_step_v2``, True or "v3"
    ``decode_step_v3`` (the latter two over ``init_cache_v2`` caches).
    The SSM family runs its recurrent step whatever it says."""
    _check_family(cfg)
    if cfg.family == "ssm":
        return ssm_lm.decode_step(params, cache, token, pos, cfg)
    if not optimized:
        return transformer.decode_step(params, cache, token, pos, cfg)
    step = transformer.decode_step_v2 if optimized == "v2" \
        else transformer.decode_step_v3
    return step(params, cache, token, pos, cfg)
