"""Single-card step functions: the bodies of the reference's
``launch/steps.py:build_train_step``, ``build_prefill_step`` and
``build_decode_step``, without a mesh, shardings or a ``StepBundle``, for
every family: the transformer families (dense, moe, vlm), the SSM, the
hybrid (zamba2) and the encoder-decoder (encdec, audio)."""

from __future__ import annotations

import torch

from ..models import (RUNS, encdec, families_run_by, ssm_lm, transformer,
                      zamba2)
from ..models.layers import PARAM_DTYPE, unembed
from ..models.model_zoo import build_model
from ..optim.adamw import AdamWConfig, apply_updates, leaves, tree_map

_ENCDEC = families_run_by("encdec")


def _check_family(cfg) -> None:
    if cfg.family not in RUNS:
        raise ValueError(f"unknown family {cfg.family!r}")


def value_and_grad(params: dict, batch: dict, cfg):
    """(loss, metrics, grads) of ``build_model(cfg).loss(params, batch)``:
    the gradients with respect to every parameter by
    ``torch.autograd.grad``, a tree shaped like ``params`` (zeros for a
    parameter the loss does not read, as under ``jax.grad``), computed on
    aliases of the parameters so that theirs stay untouched. The metrics
    come detached."""
    # leaves of the graph: aliases of the parameters, which an update may
    # then write in place once the graph is freed
    live = tree_map(lambda p: p.detach().requires_grad_(), params)
    loss, metrics = build_model(cfg).loss(live, batch)
    flat = [t for _, t in leaves(live)]
    grads = torch.autograd.grad(loss, flat, allow_unused=True)
    it = iter([torch.zeros_like(t) if g is None else g
               for t, g in zip(flat, grads)])
    del live, flat
    grads = tree_map(lambda _: next(it), params)
    return loss.detach(), {k: v.detach() for k, v in metrics.items()}, grads


def train_step(params: dict, opt_state: dict, batch: dict, cfg,
               opt: AdamWConfig | None = None):
    """One training step: the loss of ``batch`` (``tokens``, ``labels``
    and, for the encoder families, ``frames``), its gradients with respect
    to every parameter (``value_and_grad``), and one AdamW step (``opt``,
    the default ``AdamWConfig()`` when None). As the reference's step, the
    model runs with ``remat="full"`` where cfg says "none" and
    ``loss_chunk`` 512 where cfg says 0. ``params`` and ``opt_state`` are
    updated in place (the reference's step donates them). Returns
    (params, opt_state, {**the loss's metrics, "grad_norm", "lr"}).

    On the card the forward runs kernels 5 and 7, once in the forward and
    once more in the backward's recompute of each checkpointed block; the
    backward differentiates their plain versions."""
    _check_family(cfg)
    cfg = cfg.replace(remat="full" if cfg.remat == "none" else cfg.remat,
                      loss_chunk=cfg.loss_chunk or 512)
    _, metrics, grads = value_and_grad(params, batch, cfg)
    params, opt_state, opt_metrics = apply_updates(params, grads, opt_state,
                                                   opt or AdamWConfig())
    return params, opt_state, {**metrics, **opt_metrics}


def prefill_step(params: dict, tokens: torch.Tensor, cfg,
                 frames: torch.Tensor | None = None):
    """tokens: (B, S). The SSM, hybrid and encoder-decoder families return
    the last-token logits (B, V) f32: the family's ``hidden`` and the
    unembed of the last position only (tied for the SSM); the
    encoder-decoder family takes the encoder's ``frames`` (B, S_enc, d)
    and raises without them. The transformer families return
    ``prefill``'s last-token logits (B, V) and its KV cache
    (L, B, S, KH, D).

    The reference's transformer step returns ``logits[:, -1]`` of those
    (B, V) logits, the last vocabulary entry of each row, shape (B,)
    (ROADMAP Queue 3); the port returns the logits themselves."""
    _check_family(cfg)
    if (frames is not None) != (cfg.family in _ENCDEC):
        raise ValueError(f"family {cfg.family!r}: the encoder-decoder "
                         "families take frames, and only they")
    if cfg.family in transformer.FAMILIES:
        return transformer.prefill(params, tokens, cfg)
    if cfg.family == "ssm":
        x = ssm_lm.hidden(params, tokens, cfg)
        cfg = cfg.replace(tie_embeddings=True)
    elif cfg.family == "hybrid":
        x = zamba2.hidden(params, tokens, cfg)
    else:
        x = encdec.hidden(params, frames, tokens, cfg)
    return unembed(params, x[:, -1:], cfg)[:, 0]


def init_cache(cfg, batch: int, max_len: int, optimized: bool | str = False,
               dtype=PARAM_DTYPE, device=None, enc_len: int = 1024) -> dict:
    """The cache ``serve_step`` takes with ``optimized``: for the
    transformer families (L, B, S, KH, D) of ``dtype`` with
    ``optimized=False``, the KH-major (L, B, KH, S, D) otherwise; the
    other families' caches whatever ``optimized`` says: the SSM's
    recurrent state, the hybrid's states and shared-block KV, the
    encoder-decoder's self-attention KV and ``enc_len`` positions of
    cross KV."""
    _check_family(cfg)
    if cfg.family == "ssm":
        return ssm_lm.init_cache(cfg, batch, max_len, device=device)
    if cfg.family == "hybrid":
        return zamba2.init_cache(cfg, batch, max_len, dtype, device)
    if cfg.family in _ENCDEC:
        return encdec.init_cache(cfg, batch, max_len, enc_len, dtype, device)
    init = transformer.init_cache_v2 if optimized else transformer.init_cache
    return init(cfg, batch, max_len, dtype, device)


def serve_step(params: dict, cache: dict, token: torch.Tensor, pos, cfg,
               optimized: bool | str = False):
    """One decode step: token (B,) -> (logits (B, V) f32, cache), the
    cache updated in place. For the transformer families ``optimized``
    picks the implementation as the reference's ``build_decode_step``:
    False ``decode_step``, "v2" ``decode_step_v2``, True or "v3"
    ``decode_step_v3`` (the latter two over ``init_cache_v2`` caches).
    The other families run their own step whatever it says."""
    _check_family(cfg)
    if cfg.family == "ssm":
        return ssm_lm.decode_step(params, cache, token, pos, cfg)
    if cfg.family == "hybrid":
        return zamba2.decode_step(params, cache, token, pos, cfg)
    if cfg.family in _ENCDEC:
        return encdec.decode_step(params, cache, token, pos, cfg)
    if not optimized:
        return transformer.decode_step(params, cache, token, pos, cfg)
    step = transformer.decode_step_v2 if optimized == "v2" \
        else transformer.decode_step_v3
    return step(params, cache, token, pos, cfg)
