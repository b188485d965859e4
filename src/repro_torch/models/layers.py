"""Shared model layers: norms, rotary embeddings, attention (full
sequence, cross-attention over an encoder's memory, and one decode token
against a dense KV cache), MLPs, the head and the losses.

Functional, as in the reference: parameters are plain dicts of tensors,
weights stored (d_in, d_out) so a layer is ``x @ w``; every layer is
``f(params, x, ...) -> y``. Parameters are bf16; norms, softmax and
rotary math run in f32, with the reference's casts in the same places.

Under an activation-sharding policy on a mesh of ranks
(``distributed/act_sharding.py``) each rank holds its rows and its chunk
of the sequence: positions start at the chunk's first, attention moves
its inputs to the heads layout or gathers the sequence
(``attention_block``), and the losses are the means over the whole
batch.
"""

from __future__ import annotations

import torch
import torch.utils.checkpoint

from ..distributed import act_sharding
from ..kernels.flash_attention.ops import attention

PARAM_DTYPE = torch.bfloat16
NEG_INF = -1e30             # the reference's mask value


class NoDraws:
    """What the inits take for a generator on meta, which has none: its
    ``device`` only. ``randn`` of it draws nothing."""

    def __init__(self, device: torch.device):
        self.device = device


def generator(seed: int, dev: torch.device):
    """A ``torch.Generator`` on ``dev`` seeded with ``seed``; on meta a
    ``NoDraws``, so that the inits make leaves of the same shapes and
    types through the same code and draw nothing."""
    if dev.type == "meta":
        return NoDraws(dev)
    return torch.Generator(device=dev).manual_seed(seed)


def randn(shape, gen) -> torch.Tensor:
    """Standard normal f32 draws of ``shape`` from ``gen`` on its device;
    an empty meta tensor of that shape from a ``NoDraws``."""
    if isinstance(gen, NoDraws):
        return torch.empty(shape, dtype=torch.float32, device=gen.device)
    return torch.randn(shape, generator=gen, device=gen.device,
                       dtype=torch.float32)


def dense_init(gen: torch.Generator, d_in: int, d_out: int,
               dtype=PARAM_DTYPE) -> torch.Tensor:
    """Glorot-normal (d_in, d_out) weight drawn from ``gen`` on its
    device, in f32, then cast."""
    scale = (2.0 / (d_in + d_out)) ** 0.5
    return (randn((d_in, d_out), gen) * scale).to(dtype)


def rmsnorm_init(d: int, device, dtype=PARAM_DTYPE) -> torch.Tensor:
    return torch.ones((d,), dtype=dtype, device=device)


def rmsnorm(w: torch.Tensor, x: torch.Tensor, eps: float = 1e-5):
    """Normalised in f32, cast back to x's type, then scaled by w."""
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(x.dtype) * w


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 1e4) -> torch.Tensor:
    """x: (..., S, H, D); positions broadcastable to (..., S). Rotates
    the two halves of D (not interleaved pairs), in f32."""
    d = x.shape[-1]
    freqs = rope_freqs(d, theta, x.device)                    # (D/2,)
    angles = positions[..., None].float() * freqs             # (..., S, D/2)
    cos = torch.cos(angles)[..., None, :]                     # (..., S, 1, D/2)
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def position_ids(b: int, s: int, device) -> torch.Tensor:
    """The positions 0..s-1 of each of b rows, (B, S) int32; on a mesh of
    ranks those of the rank's chunk of s positions
    (``act_sharding.seq_start``)."""
    p0 = act_sharding.seq_start(s)
    return torch.arange(p0, p0 + s, dtype=torch.int32,
                        device=device)[None, :].expand(b, s)


def attn_init(gen: torch.Generator, cfg) -> dict:
    h, kh, hd, d = cfg.num_heads, cfg.num_kv_heads, cfg.hd, cfg.d_model
    p = {"wq": dense_init(gen, d, h * hd), "wk": dense_init(gen, d, kh * hd),
         "wv": dense_init(gen, d, kh * hd), "wo": dense_init(gen, h * hd, d)}
    if cfg.qkv_bias:
        for name, n in (("bq", h * hd), ("bk", kh * hd), ("bv", kh * hd)):
            p[name] = torch.zeros((n,), dtype=PARAM_DTYPE, device=gen.device)
    return p


def qkv_proj(p: dict, x: torch.Tensor, cfg, positions: torch.Tensor):
    """x: (B, S, d) -> rotated q (B, S, H, D), k (B, S, KH, D), v."""
    b, s, _ = x.shape
    h, kh, hd = cfg.num_heads, cfg.num_kv_heads, cfg.hd
    q = x @ p["wq"]
    k = x @ p["wk"]
    v = x @ p["wv"]
    if cfg.qkv_bias:
        q = q + p["bq"]
        k = k + p["bk"]
        v = v + p["bv"]
    q = apply_rope(q.reshape(b, s, h, hd), positions, cfg.rope_theta)
    k = apply_rope(k.reshape(b, s, kh, hd), positions, cfg.rope_theta)
    return q, k, v.reshape(b, s, kh, hd)


def attention_block(p: dict, x: torch.Tensor, cfg, positions: torch.Tensor,
                    causal: bool = True) -> torch.Tensor:
    """Full-sequence attention (prefill): the flash_attention kernel on
    the card.

    On a mesh of ranks x holds the rank's S/M positions. Where the heads
    and the KV heads divide the model axis, q, k and v go to the heads
    layout (``act_sharding.constrain_heads``, an all-to-all) and the
    kernel attends over the whole sequence for the rank's H/M heads, Sq ==
    Sk as on one card; the output comes back by the inverse all-to-all.
    Otherwise q, k and v are gathered over the model axis and every rank
    attends over the whole sequence for every head, keeping its own
    positions of the output: M times the attention work of the heads
    layout, and its backward sums the ranks' shares of the gathered
    inputs (llama3.2-3b's smoke config, 6 heads and 2 KV heads on M = 4,
    takes this path)."""
    q, k, v = qkv_proj(p, x, cfg, positions)
    b, s = x.shape[:2]
    if act_sharding.head_sharding_active(cfg.num_heads) and \
            act_sharding.head_sharding_active(cfg.num_kv_heads):
        out = act_sharding.release_heads(attention(
            *(act_sharding.constrain_heads(t) for t in (q, k, v)),
            causal=causal))
    else:
        out = act_sharding.local_sequence(attention(
            *(act_sharding.gather_sequence(t) for t in (q, k, v)),
            causal=causal))
    return out.reshape(b, s, -1) @ p["wo"]


def cross_attention_block(p: dict, x: torch.Tensor, mem_k: torch.Tensor,
                          mem_v: torch.Tensor, cfg) -> torch.Tensor:
    """Decoder cross-attention of x (B, S, d) over precomputed memory K/V
    (B, S_mem, KH, D): q projected with no rotation, the flash_attention
    kernel non-causal with Sq = S against Sk = S_mem on the card."""
    b, s, _ = x.shape
    q = (x @ p["wq"]).view(b, s, cfg.num_heads, cfg.hd)
    out = attention(q, mem_k, mem_v, causal=False)
    return out.reshape(b, s, -1) @ p["wo"]


def remat(cfg, fn, *args):
    """``fn(*args)``, checkpointed when ``cfg.remat == "full"`` (the
    reference's ``jax.checkpoint`` of a block): its activations are not
    kept but recomputed in the backward, kernel launches included. The
    blocks draw no random numbers, so no RNG state is kept for the
    recompute."""
    if cfg.remat == "full":
        return torch.utils.checkpoint.checkpoint(
            fn, *args, use_reentrant=False, preserve_rng_state=False)
    return fn(*args)


def check_pos(pos, slots: int) -> int:
    """``pos`` as an int inside a cache of ``slots`` positions: the
    reference's ``dynamic_update_slice`` clamps a write past the end, the
    port raises."""
    pos = int(pos)
    if not 0 <= pos < slots:
        raise ValueError(f"position {pos} outside the cache's {slots} "
                         "slots")
    return pos


def decode_scores(q: torch.Tensor, k_cache: torch.Tensor, length):
    """q: (B, H, D); k_cache: (B, KH, S, D); length: an int, () or (B,)
    tensor. The scaled scores (B, KH, G, S) in f32 with the positions at
    or past ``length`` set to NEG_INF, and that mask (B, S).

    The reference's einsums run over the cache's type with f32
    accumulation (``preferred_element_type``): here both operands go to
    f32 (bf16 products are exact there), q first rounded to the cache's
    type, as in the reference."""
    b, h, d = q.shape
    kh = k_cache.shape[1]
    qr = q.to(k_cache.dtype).float().reshape(b, kh, h // kh, d)
    s = torch.einsum("bkgd,bksd->bkgs", qr, k_cache.float()) * d ** -0.5
    pos = torch.arange(k_cache.shape[2], device=q.device)
    valid = pos[None, :] < torch.as_tensor(length,
                                           device=q.device).reshape(-1, 1)
    return torch.where(valid[:, None, None, :], s, NEG_INF), valid


def decode_attention_khmajor(q: torch.Tensor, k_cache: torch.Tensor,
                             v_cache: torch.Tensor, length) -> torch.Tensor:
    """One-token decode against a KH-major dense cache (B, KH, S, D) over
    the positions below ``length``. Returns (B, H, D) in q's type; the
    softmax weights are rounded to the values' type for P.V, as in the
    reference."""
    b, h, d = q.shape
    s, _ = decode_scores(q, k_cache, length)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgs,bksd->bkgd", p.to(v_cache.dtype).float(),
                       v_cache.float())
    return out.reshape(b, h, d).to(q.dtype)


def decode_attention_dense(q: torch.Tensor, k_cache: torch.Tensor,
                           v_cache: torch.Tensor, length) -> torch.Tensor:
    """One-token decode against a dense KV cache. q: (B, H, D); caches:
    (B, Smax, KH, D), read through their (B, KH, S, D) views, no copy;
    length: an int, () or (B,) tensor."""
    return decode_attention_khmajor(q, k_cache.transpose(1, 2),
                                    v_cache.transpose(1, 2), length)


def attention_decode(p: dict, x: torch.Tensor, cfg, cache_k: torch.Tensor,
                     cache_v: torch.Tensor, pos):
    """x: (B, 1, d); caches (B, Smax, KH, D). Writes the token's k and v
    at ``pos`` into the caches (in place: the reference's update is
    functional and its caches donated) and attends over positions
    0..pos. Returns (y (B, 1, d), cache_k, cache_v)."""
    b = x.shape[0]
    pos = check_pos(pos, cache_k.shape[1])
    positions = torch.full((b, 1), pos, dtype=torch.int32, device=x.device)
    q, k, v = qkv_proj(p, x, cfg, positions)
    cache_k[:, pos] = k[:, 0].to(cache_k.dtype)
    cache_v[:, pos] = v[:, 0].to(cache_v.dtype)
    out = decode_attention_dense(q[:, 0], cache_k, cache_v, pos + 1)
    return out.reshape(b, 1, -1) @ p["wo"], cache_k, cache_v


def mlp_init(gen: torch.Generator, cfg, d_ff: int | None = None) -> dict:
    d, ff = cfg.d_model, d_ff or cfg.d_ff
    if cfg.mlp == "swiglu":
        return {"wi": dense_init(gen, d, ff), "wg": dense_init(gen, d, ff),
                "wo": dense_init(gen, ff, d)}
    return {"wi": dense_init(gen, d, ff), "wo": dense_init(gen, ff, d)}


def mlp(p: dict, x: torch.Tensor, cfg) -> torch.Tensor:
    """The activation runs in f32 on the bf16 products, then casts back
    to x's type before the down projection."""
    if cfg.mlp == "swiglu":
        hidden = torch.nn.functional.silu((x @ p["wg"]).float()) \
            * (x @ p["wi"]).float()
    elif cfg.mlp == "squared_relu":
        hidden = torch.square(torch.relu((x @ p["wi"]).float()))
    else:
        hidden = torch.nn.functional.gelu((x @ p["wi"]).float(),
                                          approximate="tanh")
    return hidden.to(x.dtype) @ p["wo"]


def embed_init(gen: torch.Generator, cfg) -> torch.Tensor:
    return (randn((cfg.vocab_size, cfg.d_model), gen) * 0.02).to(PARAM_DTYPE)


def head_init(gen: torch.Generator, cfg,
              dtype=PARAM_DTYPE) -> torch.Tensor:
    """The untied head (d, V)."""
    return (randn((cfg.d_model, cfg.vocab_size), gen) * 0.02).to(dtype)


def unembed(params: dict, x: torch.Tensor, cfg) -> torch.Tensor:
    """Logits in f32."""
    if cfg.tie_embeddings:
        return (x @ params["embed"].T).float()
    return (x @ params["head"]).float()


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  mask: torch.Tensor | None = None) -> torch.Tensor:
    """logits: (B, S, V) f32; labels: (B, S) int. The mean negative
    log-likelihood of the labels under an f32 log-softmax; with ``mask``
    (B, S), the masked sum over ``max(mask.sum(), 1)``. On a mesh of ranks
    the sums and counts are the whole batch's."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -torch.gather(logp, -1, labels.long()[..., None])[..., 0]
    if mask is not None:
        nll = nll * mask
        return act_sharding.mesh_sum(nll.sum()) / torch.clamp(
            act_sharding.mesh_sum(mask.sum()), min=1.0)
    if act_sharding.ranks() is None:
        return nll.mean()
    return act_sharding.token_mean(nll.sum(), nll.numel())


def chunked_cross_entropy(params: dict, x: torch.Tensor, labels: torch.Tensor,
                          cfg, chunk: int) -> torch.Tensor:
    """The loss of ``unembed(params, x, cfg)`` against labels (B, S) over
    sequence chunks of ``chunk`` (cut to S), so that only one chunk's
    (B, chunk, V) logits are made at a time: the chunks' summed NLL over
    B * S, added chunk by chunk in order, as the reference's scan. When S
    is not a multiple of the chunk, the dense ``cross_entropy`` of the
    whole logits, with no mask, as the reference's. On a mesh of ranks
    x holds the rank's tokens, and their summed NLL over the mesh is
    divided by the whole batch's count (``act_sharding.token_mean``)."""
    b, s, _ = x.shape
    chunk = min(chunk, s)
    if s % chunk:
        return cross_entropy(unembed(params, x, cfg), labels)
    total = torch.zeros((), dtype=torch.float32, device=x.device)
    for c0 in range(0, s, chunk):
        logp = torch.log_softmax(unembed(params, x[:, c0:c0 + chunk], cfg),
                                 dim=-1)
        nll = -torch.gather(logp, -1,
                            labels[:, c0:c0 + chunk].long()[..., None])
        total = total + nll.sum()
    return act_sharding.token_mean(total, b * s)
