"""Decoder-only transformer LM, dense family (GQA, rotary, QKV bias,
SwiGLU or squared-ReLU MLP, tied or untied head).

Parameters are a dict: ``embed`` (V, d), ``ln_f`` (d,), ``head``
(d, V) unless tied, and ``layers``, a list of one dict per layer
(``ln1``, ``attn`` {wq, wk, wv, wo[, bq, bk, bv]}, ``ln2``, ``mlp``
{wi[, wg], wo}), weights (d_in, d_out) in bf16. The reference stacks the
layers on a leading axis for ``lax.scan``; here a Python loop walks the
list (``state.params_from_jax`` converts one layout into the other).
"""

from __future__ import annotations

import torch

from ..device import resolve_device
from ..kernels.flash_attention.ops import attention
from .layers import (PARAM_DTYPE, attention_block, attn_init, embed_init,
                     mlp, mlp_init, qkv_proj, rmsnorm, rmsnorm_init, unembed)


def _check_family(cfg) -> None:
    if cfg.family != "dense":
        raise NotImplementedError(
            f"family {cfg.family!r}: transformer runs the dense family "
            "only (ssm: models/ssm_lm.py; the others wait for ROADMAP "
            "Queue 2 item 6)")


def init_params(seed: int, cfg, device=None) -> dict:
    """Random weights at cfg's widths from a ``torch.Generator`` seeded
    with ``seed`` on ``device`` (the card unless ``device="cpu"``). The
    draws are not the reference's (JAX's PRNG bits are not reproduced);
    the layout and the distributions are."""
    _check_family(cfg)
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    layers = [{"ln1": rmsnorm_init(cfg.d_model, dev),
               "attn": attn_init(gen, cfg),
               "ln2": rmsnorm_init(cfg.d_model, dev),
               "mlp": mlp_init(gen, cfg)} for _ in range(cfg.num_layers)]
    params = {"layers": layers, "embed": embed_init(gen, cfg),
              "ln_f": rmsnorm_init(cfg.d_model, dev)}
    if not cfg.tie_embeddings:
        params["head"] = (torch.randn(
            (cfg.d_model, cfg.vocab_size), generator=gen, device=dev,
            dtype=torch.float32) * 0.02).to(PARAM_DTYPE)
    return params


def _positions(b: int, s: int, device) -> torch.Tensor:
    return torch.arange(s, dtype=torch.int32,
                        device=device)[None, :].expand(b, s)


def _block(lp: dict, x: torch.Tensor, cfg, positions) -> torch.Tensor:
    h = x + attention_block(lp["attn"], rmsnorm(lp["ln1"], x, cfg.norm_eps),
                            cfg, positions)
    return h + mlp(lp["mlp"], rmsnorm(lp["ln2"], h, cfg.norm_eps), cfg)


def hidden(params: dict, tokens: torch.Tensor, cfg):
    """tokens: (B, S) int -> final normed hidden (B, S, d), aux (the
    dense family's auxiliary losses are 0)."""
    _check_family(cfg)
    b, s = tokens.shape
    x = params["embed"][tokens.long()]
    positions = _positions(b, s, x.device)
    for lp in params["layers"]:
        x = _block(lp, x, cfg, positions)
    x = rmsnorm(params["ln_f"], x, cfg.norm_eps)
    zero = torch.zeros((), dtype=torch.float32, device=x.device)
    return x, {"load_balance": zero, "router_z": zero}


def forward(params: dict, tokens: torch.Tensor, cfg):
    """tokens: (B, S) int -> logits (B, S, V) f32, aux."""
    x, aux = hidden(params, tokens, cfg)
    return unembed(params, x, cfg), aux


def prefill(params: dict, tokens: torch.Tensor, cfg):
    """Full-sequence forward returning the *last-token* logits (B, V) f32
    and the KV of every layer, {"k", "v"}: (L, B, S, KH, D) bf16 (the
    (B, S, V) logits never materialise)."""
    _check_family(cfg)
    b, s = tokens.shape
    x = params["embed"][tokens.long()]
    positions = _positions(b, s, x.device)
    ks, vs = [], []
    for lp in params["layers"]:
        q, k, v = qkv_proj(lp["attn"], rmsnorm(lp["ln1"], x, cfg.norm_eps),
                           cfg, positions)
        o = attention(q, k, v, causal=True)
        h = x + o.reshape(b, s, -1) @ lp["attn"]["wo"]
        x = h + mlp(lp["mlp"], rmsnorm(lp["ln2"], h, cfg.norm_eps), cfg)
        ks.append(k.to(PARAM_DTYPE))
        vs.append(v.to(PARAM_DTYPE))
    x = rmsnorm(params["ln_f"], x[:, -1:], cfg.norm_eps)
    logits = unembed(params, x, cfg)[:, 0]
    return logits, {"k": torch.stack(ks), "v": torch.stack(vs)}
