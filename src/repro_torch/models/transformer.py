"""Decoder-only transformer LM: the dense, MoE and VLM families (GQA,
rotary, QKV bias, SwiGLU or squared-ReLU MLP or an MoE feed-forward,
tied or untied head; the VLM family is the dense path over the frontend
stub's token ids, VQ image tokens sharing the text vocabulary).

Parameters are a dict: ``embed`` (V, d), ``ln_f`` (d,), ``head``
(d, V) unless tied, and ``layers``, a list of one dict per layer
(``ln1``, ``attn`` {wq, wk, wv, wo[, bq, bk, bv]}, ``ln2``, and ``mlp``
{wi[, wg], wo} or, in the MoE family, ``moe`` {router, wi, wg, wo}),
weights (d_in, d_out) in bf16 (the router f32). The reference stacks the
layers on a leading axis for ``lax.scan``; here a Python loop walks the
list (``state.params_from_jax`` converts one layout into the other).

Training: ``loss_fn`` is the chunked or dense cross entropy of
``hidden`` plus the MoE's aux terms; under ``cfg.remat == "full"`` each
block is checkpointed, as the reference's scan body.

Serving: ``prefill`` fills a dense KV cache; three decode steps continue
from one, as the reference's: ``decode_step`` over (L, B, S, KH, D)
caches, ``decode_step_v2`` and ``decode_step_v3`` over (L, B, KH, S, D)
caches (v3 attends over the cache as a read-only pool plus the token's
own partial, and appends every layer's k and v once at the end). Each
updates the cache it is given in place, where the reference's are
functional with the cache donated, and returns it.
"""

from __future__ import annotations

import torch

from ..device import resolve_device
from ..distributed.act_sharding import constrain, last_position
from . import check_family, families_run_by
from .layers import (PARAM_DTYPE, attend, attention_block, attention_decode,
                     attn_init, cache_attend, cache_slots, check_pos,
                     chunked_cross_entropy, cross_entropy, embed_init,
                     generator, head_init, mlp, mlp_init, position_ids,
                     qkv_proj, remat, rmsnorm, rmsnorm_init, unembed,
                     write_token)
from .moe import moe_ff, moe_init

FAMILIES = families_run_by("transformer")


def _layer_init(gen: torch.Generator, cfg, dev) -> dict:
    p = {"ln1": rmsnorm_init(cfg.d_model, dev), "attn": attn_init(gen, cfg),
         "ln2": rmsnorm_init(cfg.d_model, dev)}
    if cfg.family == "moe":
        p["moe"] = moe_init(gen, cfg)
    else:
        p["mlp"] = mlp_init(gen, cfg)
    return p


def init_params(seed: int, cfg, device=None) -> dict:
    """Random weights at cfg's widths from a ``torch.Generator`` seeded
    with ``seed`` on ``device`` (the card unless ``device="cpu"``). The
    draws are not the reference's (JAX's PRNG bits are not reproduced);
    the layout and the distributions are."""
    check_family(cfg, "transformer")
    dev = resolve_device(device)
    gen = generator(seed, dev)
    layers = [_layer_init(gen, cfg, dev) for _ in range(cfg.num_layers)]
    params = {"layers": layers, "embed": embed_init(gen, cfg),
              "ln_f": rmsnorm_init(cfg.d_model, dev)}
    if not cfg.tie_embeddings:
        params["head"] = head_init(gen, cfg)
    return params


def feed_forward(lp: dict, h: torch.Tensor, cfg):
    """The block's feed-forward on ``h`` normed by ``ln2``: the MLP, or
    the MoE's (y, aux); the MLP's aux is None."""
    hin = rmsnorm(lp["ln2"], h, cfg.norm_eps)
    if cfg.family == "moe":
        return moe_ff(lp["moe"], hin, cfg)
    return mlp(lp["mlp"], hin, cfg), None


def _block(lp: dict, x: torch.Tensor, cfg, positions: torch.Tensor):
    """One layer: (x out, the MoE's aux or None)."""
    h = x + attention_block(lp["attn"], rmsnorm(lp["ln1"], x, cfg.norm_eps),
                            cfg, positions)
    y, aux = feed_forward(lp, h, cfg)
    return h + y, aux


def hidden(params: dict, tokens: torch.Tensor, cfg):
    """tokens: (B, S) int -> final normed hidden (B, S, d), aux: the
    layers' mean ``load_balance`` and ``router_z`` (0 outside the MoE
    family). Each block is checkpointed under ``cfg.remat == "full"``. On
    a mesh of ranks, tokens are the rank's block (``act_sharding``), and
    so is every layer's output (``constrain`` checks it)."""
    check_family(cfg, "transformer")
    b, s = tokens.shape
    x = constrain(params["embed"][tokens.long()])
    positions = position_ids(b, s, x.device)
    lb, rz = [], []
    for lp in params["layers"]:
        x, aux = remat(cfg, _block, lp, x, cfg, positions)
        x = constrain(x)
        if aux is not None:
            lb.append(aux["load_balance"])
            rz.append(aux["router_z"])
    x = rmsnorm(params["ln_f"], x, cfg.norm_eps)
    if not lb:
        zero = torch.zeros((), dtype=torch.float32, device=x.device)
        return x, {"load_balance": zero, "router_z": zero}
    return x, {"load_balance": torch.stack(lb).mean(),
               "router_z": torch.stack(rz).mean()}


def forward(params: dict, tokens: torch.Tensor, cfg):
    """tokens: (B, S) int -> logits (B, S, V) f32, aux."""
    x, aux = hidden(params, tokens, cfg)
    return unembed(params, x, cfg), aux


def loss_fn(params: dict, batch: dict, cfg, aux_weight: float = 0.01):
    """batch: ``tokens`` and ``labels`` (B, S) int, optional ``mask``
    (B, S) (read by the dense loss only, as the reference's). The chunked
    cross entropy under ``cfg.loss_chunk``, else the dense one, plus
    ``aux_weight`` x ``load_balance`` + 1e-3 x ``router_z``. Returns
    (loss, {"loss", "load_balance", "router_z"})."""
    x, aux = hidden(params, batch["tokens"], cfg)
    if cfg.loss_chunk:
        loss = chunked_cross_entropy(params, x, batch["labels"], cfg,
                                     cfg.loss_chunk)
    else:
        loss = cross_entropy(unembed(params, x, cfg), batch["labels"],
                             batch.get("mask"))
    loss = loss + aux_weight * aux["load_balance"] + 1e-3 * aux["router_z"]
    return loss, {"loss": loss, **aux}


def prefill(params: dict, tokens: torch.Tensor, cfg):
    """Full-sequence forward returning the *last-token* logits (B, V) f32
    and the KV of every layer, {"k", "v"}: (L, B, S, KH, D) bf16 (the
    (B, S, V) logits never materialise). On a mesh of ranks tokens are the
    rank's block (B/D, S/M): the KV is its positions', and the logits the
    sequence's last position's on every rank."""
    check_family(cfg, "transformer")
    b, s = tokens.shape
    x = params["embed"][tokens.long()]
    positions = position_ids(b, s, x.device)
    ks, vs = [], []
    for lp in params["layers"]:
        q, k, v = qkv_proj(lp["attn"], rmsnorm(lp["ln1"], x, cfg.norm_eps),
                           cfg, positions)
        o = attend(q, k, v, cfg)
        h = x + o.reshape(b, s, -1) @ lp["attn"]["wo"]
        x = h + feed_forward(lp, h, cfg)[0]
        ks.append(k.to(PARAM_DTYPE))
        vs.append(v.to(PARAM_DTYPE))
    x = rmsnorm(params["ln_f"], last_position(x), cfg.norm_eps)
    logits = unembed(params, x, cfg)[:, 0]
    return logits, {"k": torch.stack(ks), "v": torch.stack(vs)}


# ---------------------------------------------------------------------------
# decode over a dense KV cache
# ---------------------------------------------------------------------------
def _zeros_cache(shape, dtype, device) -> dict:
    dev = resolve_device(device)
    return {"k": torch.zeros(shape, dtype=dtype, device=dev),
            "v": torch.zeros(shape, dtype=dtype, device=dev)}


def init_cache(cfg, batch: int, max_len: int, dtype=PARAM_DTYPE,
               device=None) -> dict:
    """Stacked per-layer dense KV cache (L, B, S, KH, D), zeros."""
    return _zeros_cache((cfg.num_layers, batch, max_len, cfg.num_kv_heads,
                         cfg.hd), dtype, device)


def _embed_token(params: dict, token: torch.Tensor) -> torch.Tensor:
    return params["embed"][token.long()[:, None]]          # (B, 1, d)


def _head(params: dict, x: torch.Tensor, cfg) -> torch.Tensor:
    return unembed(params, rmsnorm(params["ln_f"], x, cfg.norm_eps),
                   cfg)[:, 0]


def decode_step(params: dict, cache: dict, token: torch.Tensor, pos, cfg):
    """token: (B,) int; pos: the position written (an int). Returns
    (logits (B, V) f32, cache), the cache updated in place."""
    check_family(cfg, "transformer")
    x = _embed_token(params, token)
    for li, lp in enumerate(params["layers"]):
        xin = rmsnorm(lp["ln1"], x, cfg.norm_eps)
        y, _, _ = attention_decode(lp["attn"], xin, cfg, cache["k"][li],
                                   cache["v"][li], pos)
        h = x + y
        x = h + feed_forward(lp, h, cfg)[0]
    return _head(params, x, cfg), cache


def init_cache_v2(cfg, batch: int, max_len: int, dtype=PARAM_DTYPE,
                  device=None) -> dict:
    """The KH-major dense cache (L, B, KH, S, D) of decode_step_v2 and
    decode_step_v3, zeros."""
    return _zeros_cache((cfg.num_layers, batch, cfg.num_kv_heads, max_len,
                         cfg.hd), dtype, device)


def _token_qkv(lp: dict, x: torch.Tensor, cfg, pos: int):
    """The rotated q, k, v (B, 1, *, D) of the layer's input x (B, 1, d)
    at position ``pos``."""
    b = x.shape[0]
    positions = torch.full((b, 1), pos, dtype=torch.int32, device=x.device)
    return qkv_proj(lp["attn"], rmsnorm(lp["ln1"], x, cfg.norm_eps), cfg,
                    positions)


def decode_step_v2(params: dict, cache: dict, token: torch.Tensor, pos,
                   cfg):
    """decode_step's contract over init_cache_v2 caches: each layer writes
    its token's (B, KH, D) slice in place, then attends over 0..pos."""
    check_family(cfg, "transformer")
    ck_all, cv_all = cache["k"], cache["v"]
    pos = check_pos(pos, cache_slots(ck_all[0], "bksd"))
    b = token.shape[0]
    x = _embed_token(params, token)
    for li, lp in enumerate(params["layers"]):
        q, k, v = _token_qkv(lp, x, cfg, pos)
        write_token(ck_all[li], k[:, 0], pos, "bksd")
        write_token(cv_all[li], v[:, 0], pos, "bksd")
        o = cache_attend(q[:, 0], ck_all[li], cv_all[li], pos + 1, "bksd")
        h = x + o.reshape(b, 1, -1) @ lp["attn"]["wo"]
        x = h + feed_forward(lp, h, cfg)[0]
    return _head(params, x, cfg), cache


def decode_step_v3(params: dict, cache: dict, token: torch.Tensor, pos,
                   cfg):
    """The pool-invariant decode over init_cache_v2 caches: the cache is
    read-only inside the layer loop (each layer's positions below pos,
    merged with the token's own partial), and every layer's k and v are
    appended at pos once, after the loop."""
    check_family(cfg, "transformer")
    ck_all, cv_all = cache["k"], cache["v"]
    pos = check_pos(pos, cache_slots(ck_all[0], "bksd"))
    b = token.shape[0]
    x = _embed_token(params, token)
    ks, vs = [], []
    for li, lp in enumerate(params["layers"]):
        q, k, v = _token_qkv(lp, x, cfg, pos)
        k0, v0 = k[:, 0], v[:, 0]                              # (B, KH, D)
        o = cache_attend(q[:, 0], ck_all[li], cv_all[li], pos, "bksd",
                         own=(k0, v0)).to(x.dtype)
        h = x + o.reshape(b, 1, -1) @ lp["attn"]["wo"]
        x = h + feed_forward(lp, h, cfg)[0]
        ks.append(k0)
        vs.append(v0)
    # one append for all layers
    write_token(ck_all, torch.stack(ks), pos, "bksd")
    write_token(cv_all, torch.stack(vs), pos, "bksd")
    return _head(params, x, cfg), cache
