"""Encoder-decoder transformer (the seamless-m4t-medium backbone,
arXiv:2308.11596). The audio frontend is a stub, as in the reference: the
encoder takes precomputed frame embeddings (B, S_enc, d); the decoder
takes token ids. A decoder layer is causal self-attention, cross-attention
over the encoder's memory, and an MLP.

Parameters are a dict: ``enc_layers``, a list of ``encoder_layers``
dicts (``ln1``, ``attn``, ``ln2``, ``mlp``); ``dec_layers``, a list of
``num_layers`` dicts (``ln1``, ``self``, ``lnx``, ``cross``, ``ln2``,
``mlp``); ``embed`` (V, d) for the decoder's tokens, ``ln_enc``, ``ln_f``
and an untied ``head`` (d, V). The reference stacks each list on a leading
axis for ``lax.scan``; here Python loops walk them. ``loss_fn`` is the
decoder's cross entropy; under ``cfg.remat == "full"`` each encoder and
each decoder layer is checkpointed, as the reference's scan bodies.

Serving: the cache holds the decoder's self-attention KV, (L, B, S, KH, D)
each, written in place a token at a time, and the cross-attention KV of
the memory, (L, B, S_enc, KH, D) each, which ``prepare_cross`` fills once.

On a mesh of ranks (``distributed/act_sharding.py``) the frames come whole
to every rank of the model axis (rows over the data axes only). The
encoder runs on the rank's S_enc/M frames in the sequence layout, as the
decoder runs on its S/M tokens, its attention in the heads layout; the
memory is then gathered whole to every rank (one all_gather of (B, S_enc,
d) a step), and each rank's decoder positions attend over all of it. The
encoder's work is not repeated on the M ranks, and the gather's backward
sums each rank's share of the memory's gradient back to its frames. A
decode step reads its self and cross caches by their partition rules
(``layers.cache_attend``).
"""

from __future__ import annotations

import torch

from ..device import resolve_device
from ..distributed import act_sharding
from . import check_family
from .layers import (PARAM_DTYPE, attention_block, attention_decode,
                     attn_init, cache_attend, cache_slots,
                     chunked_cross_entropy, cross_attention_block,
                     cross_entropy, embed_init, generator, head_init, mlp,
                     mlp_init, position_ids, remat, rmsnorm, rmsnorm_init,
                     unembed)


def _enc_layer_init(gen: torch.Generator, cfg, dev) -> dict:
    return {"ln1": rmsnorm_init(cfg.d_model, dev), "attn": attn_init(gen, cfg),
            "ln2": rmsnorm_init(cfg.d_model, dev), "mlp": mlp_init(gen, cfg)}


def _dec_layer_init(gen: torch.Generator, cfg, dev) -> dict:
    return {"ln1": rmsnorm_init(cfg.d_model, dev), "self": attn_init(gen, cfg),
            "lnx": rmsnorm_init(cfg.d_model, dev),
            "cross": attn_init(gen, cfg),
            "ln2": rmsnorm_init(cfg.d_model, dev), "mlp": mlp_init(gen, cfg)}


def init_params(seed: int, cfg, device=None) -> dict:
    """Random weights at cfg's widths from a ``torch.Generator`` seeded
    with ``seed`` on ``device`` (the card unless ``device="cpu"``). The
    draws are not the reference's; the layout and the distributions
    are."""
    check_family(cfg, "encdec")
    dev = resolve_device(device)
    gen = generator(seed, dev)
    return {
        "enc_layers": [_enc_layer_init(gen, cfg, dev)
                       for _ in range(cfg.encoder_layers)],
        "dec_layers": [_dec_layer_init(gen, cfg, dev)
                       for _ in range(cfg.num_layers)],
        "embed": embed_init(gen, cfg),
        "ln_enc": rmsnorm_init(cfg.d_model, dev),
        "ln_f": rmsnorm_init(cfg.d_model, dev),
        "head": head_init(gen, cfg, PARAM_DTYPE),
    }


def encode(params: dict, frames: torch.Tensor, cfg) -> torch.Tensor:
    """frames: (B, S_enc, d) precomputed frontend embeddings, cast to bf16
    before layer 0 -> the normed memory (B, S_enc, d). Self-attention is
    non-causal: on the card one flash_attention launch a layer with
    Sq = Sk = S_enc. On a mesh of ranks each rank encodes its S_enc/M
    frames and the memory is gathered whole."""
    check_family(cfg, "encdec")
    frames = act_sharding.local_sequence(frames)
    b, s, _ = frames.shape
    positions = position_ids(b, s, frames.device)
    x = frames.to(PARAM_DTYPE)
    for lp in params["enc_layers"]:
        x = remat(cfg, _enc_layer, lp, x, cfg, positions)
    return act_sharding.gather_sequence(
        rmsnorm(params["ln_enc"], x, cfg.norm_eps))


def _enc_layer(lp: dict, x: torch.Tensor, cfg,
               positions: torch.Tensor) -> torch.Tensor:
    h = x + attention_block(lp["attn"], rmsnorm(lp["ln1"], x, cfg.norm_eps),
                            cfg, positions, causal=False)
    return h + mlp(lp["mlp"], rmsnorm(lp["ln2"], h, cfg.norm_eps), cfg)


def _cross_kv(lp: dict, memory: torch.Tensor, cfg):
    """The layer's cross-attention K and V of the memory, (B, S_enc, KH, D)
    views of ``memory @ w``, with no rotation."""
    b, s, _ = memory.shape
    kh, hd = cfg.num_kv_heads, cfg.hd
    return ((memory @ lp["cross"]["wk"]).view(b, s, kh, hd),
            (memory @ lp["cross"]["wv"]).view(b, s, kh, hd))


def hidden(params: dict, frames: torch.Tensor, tokens: torch.Tensor,
           cfg) -> torch.Tensor:
    """frames: (B, S_enc, d); tokens: (B, S_dec) int -> the decoder's final
    normed hidden (B, S_dec, d). On the card each decoder layer launches
    flash_attention twice: causal over its tokens (rotated), then
    non-causal with Sq = S_dec against Sk = S_enc over the memory."""
    memory = encode(params, frames, cfg)
    b, s = tokens.shape
    x = params["embed"][tokens.long()]
    positions = position_ids(b, s, x.device)
    for lp in params["dec_layers"]:
        x = remat(cfg, _dec_layer, lp, x, memory, cfg, positions)
    return rmsnorm(params["ln_f"], x, cfg.norm_eps)


def _dec_layer(lp: dict, x: torch.Tensor, memory: torch.Tensor, cfg,
               positions: torch.Tensor) -> torch.Tensor:
    h = x + attention_block(lp["self"], rmsnorm(lp["ln1"], x, cfg.norm_eps),
                            cfg, positions, causal=True)
    mk, mv = _cross_kv(lp, memory, cfg)
    h = h + cross_attention_block(
        lp["cross"], rmsnorm(lp["lnx"], h, cfg.norm_eps), mk, mv, cfg)
    return h + mlp(lp["mlp"], rmsnorm(lp["ln2"], h, cfg.norm_eps), cfg)


def forward(params: dict, frames: torch.Tensor, tokens: torch.Tensor, cfg):
    """frames: (B, S_enc, d); tokens: (B, S_dec) -> logits (B, S_dec, V)
    f32, aux {}."""
    return unembed(params, hidden(params, frames, tokens, cfg), cfg), {}


def loss_fn(params: dict, batch: dict, cfg):
    """batch: ``frames`` (B, S_enc, d), ``tokens`` and ``labels`` (B, S)
    int, optional ``mask``. The decoder's chunked cross entropy under
    ``cfg.loss_chunk``, else the dense one. Returns (loss, {"loss"})."""
    x = hidden(params, batch["frames"], batch["tokens"], cfg)
    if cfg.loss_chunk:
        loss = chunked_cross_entropy(params, x, batch["labels"], cfg,
                                     cfg.loss_chunk)
    else:
        loss = cross_entropy(unembed(params, x, cfg), batch["labels"],
                             batch.get("mask"))
    return loss, {"loss": loss}


def init_cache(cfg, batch: int, max_len: int, enc_len: int,
               dtype=PARAM_DTYPE, device=None) -> dict:
    """Zero caches on ``device`` (the card unless ``"cpu"``) of ``dtype``:
    ``k``, ``v`` (L, B, max_len, KH, D) for the decoder's tokens and
    ``xk``, ``xv`` (L, B, enc_len, KH, D) for the memory."""
    check_family(cfg, "encdec")
    dev = resolve_device(device)

    def zeros(length):
        return torch.zeros((cfg.num_layers, batch, length, cfg.num_kv_heads,
                            cfg.hd), dtype=dtype, device=dev)

    return {"k": zeros(max_len), "v": zeros(max_len), "xk": zeros(enc_len),
            "xv": zeros(enc_len), "enc_len": enc_len}


def prepare_cross(params: dict, memory: torch.Tensor, cfg,
                  cache: dict) -> dict:
    """The cache with ``xk`` and ``xv`` replaced by every decoder layer's
    cross K and V of ``memory`` (B, S_enc, d), stacked (L, B, S_enc, KH, D)
    and cast to the cache's type, as the reference's: their length is the
    memory's."""
    ks, vs = zip(*(_cross_kv(lp, memory, cfg) for lp in params["dec_layers"]))
    cache = dict(cache)
    cache["xk"] = torch.stack(ks).to(cache["xk"].dtype)
    cache["xv"] = torch.stack(vs).to(cache["xv"].dtype)
    return cache


def decode_step(params: dict, cache: dict, token: torch.Tensor, pos, cfg):
    """token: (B,) int; pos: the position written (an int). Each layer's
    self-attention writes its k and v at ``pos`` in place and attends over
    0..pos; its cross-attention attends over the whole cross cache.
    Returns (logits (B, V) f32, cache)."""
    check_family(cfg, "encdec")
    b = token.shape[0]
    x = params["embed"][token.long()[:, None]]
    xlen = cache_slots(cache["xk"][0], "bskd", "xk")
    for li, lp in enumerate(params["dec_layers"]):
        y, _, _ = attention_decode(lp["self"],
                                   rmsnorm(lp["ln1"], x, cfg.norm_eps), cfg,
                                   cache["k"][li], cache["v"][li], pos)
        h = x + y
        hq = rmsnorm(lp["lnx"], h, cfg.norm_eps)
        q = (hq @ lp["cross"]["wq"]).view(b, cfg.num_heads, cfg.hd)
        o = cache_attend(q, cache["xk"][li], cache["xv"][li], xlen, "bskd",
                         "xk")
        h = h + o.reshape(b, 1, -1) @ lp["cross"]["wo"]
        x = h + mlp(lp["mlp"], rmsnorm(lp["ln2"], h, cfg.norm_eps), cfg)
    x = rmsnorm(params["ln_f"], x, cfg.norm_eps)
    return unembed(params, x, cfg)[:, 0], cache
