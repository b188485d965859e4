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
batch. A decode step holds the rows layout there: the token whole on
every model rank, each dense KV cache split by its partition rules, on
its positions (each rank an owner of a range of them, whose partials are
merged across the model axis: DINOMO's ownership partitioning, as the
paged server's page owners on one card), its KV heads or its head dim
(``cache_attend``, ``write_token``).
"""

from __future__ import annotations

import torch
import torch.utils.checkpoint

from ..distributed import act_sharding
from ..kernels.decode_attention.ops import merge_partials
from ..kernels.decode_attention.ref import normalize
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
    return attend(q, k, v, cfg, causal).reshape(b, s, -1) @ p["wo"]


def attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, cfg,
           causal: bool = True) -> torch.Tensor:
    """The flash_attention kernel over q (B, S, H, D), k, v (B, S, KH, D);
    on a mesh of ranks over the rank's S/M positions, in the heads layout
    or over the gathered sequence (``attention_block``)."""
    if act_sharding.head_sharding_active(cfg.num_heads) and \
            act_sharding.head_sharding_active(cfg.num_kv_heads):
        return act_sharding.release_heads(attention(
            *(act_sharding.constrain_heads(t) for t in (q, k, v)),
            causal=causal))
    return act_sharding.local_sequence(attention(
        *(act_sharding.gather_sequence(t) for t in (q, k, v)),
        causal=causal))


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


def decode_partial(q: torch.Tensor, k_cache: torch.Tensor,
                   v_cache: torch.Tensor, length):
    """The un-normalised flash partial (acc (B, H, D), m (B, H), l (B, H))
    over a (B, KH, S, D) cache's positions below ``length``; a partial of
    no position is (0, NEG_INF, 0), which a merge weighs 0."""
    b, h, d = q.shape
    s, valid = decode_scores(q, k_cache, length)
    m = s.amax(dim=3)
    p = torch.exp(s - m[..., None])
    p = torch.where(valid[:, None, None, :], p, 0.0)
    l = p.sum(dim=3)
    acc = torch.einsum("bkgs,bksd->bkgd", p.to(v_cache.dtype).float(),
                       v_cache.float())
    return acc.reshape(b, h, d), m.reshape(b, h), l.reshape(b, h)


def self_partial(q: torch.Tensor, k_new: torch.Tensor,
                 v_new: torch.Tensor):
    """The flash partial (acc, m, l) of the token's own just-computed KV,
    to merge with the cache's (decode_step_v3, the paged server).
    q: (B, H, D); k_new, v_new: (B, KH, D)."""
    b, h, d = q.shape
    kh = k_new.shape[1]
    group = h // kh
    qr = q.float().reshape(b, kh, group, d)
    s = torch.einsum("bkgd,bkd->bkg", qr, k_new.float()) * d ** -0.5
    acc = v_new.float()[:, :, None, :].expand(b, kh, group, d)
    return (acc.reshape(b, h, d), s.reshape(b, h),
            torch.ones((b, h), dtype=torch.float32, device=q.device))


def _split_role(layout: str, name: str):
    """(the role of the dim that the model axis splits in a cache block of
    ``layout``: "s" positions, "k" KV heads, "d" the head dim, or None;
    this rank's model coordinate)."""
    dim = act_sharding.cache_split(name)
    index, _ = act_sharding.model_coord()
    return (None if dim is None else layout[dim]), index


def cache_slots(cache: torch.Tensor, layout: str, name: str = "k") -> int:
    """The positions of the whole cache whose block (or whole) is
    ``cache``, a KV cache (B, ...) of ``layout``: "bskd" dense (B, S, KH,
    D) or "bksd" KH-major (B, KH, S, D)."""
    role, _ = _split_role(layout, name)
    slots = cache.shape[layout.index("s")]
    return slots * act_sharding.model_coord()[1] if role == "s" else slots


def write_token(cache: torch.Tensor, tok: torch.Tensor, pos: int,
                layout: str, name: str = "k") -> None:
    """Write the token's ``tok`` (..., KH, D) at position ``pos`` of
    ``cache`` (..., then a block of ``layout``, leading dims such as the
    layers' matching tok's), in place, in the cache's type. On a mesh of
    ranks only this rank's part: on positions, the owner of ``pos`` alone
    writes; on KV heads or the head dim, each rank its slice of tok."""
    role, index = _split_role(layout, name)
    s_dim = layout.index("s") - len(layout)
    if role == "s":
        size = cache.shape[s_dim]
        if pos // size != index:
            return
        pos -= index * size
    elif role is not None:
        t_dim = -2 if role == "k" else -1
        size = cache.shape[layout.index(role) - len(layout)]
        tok = tok.narrow(t_dim, index * size, size)
    cache.select(s_dim, pos).copy_(tok.to(cache.dtype))


def cache_attend(q: torch.Tensor, k_cache: torch.Tensor,
                 v_cache: torch.Tensor, length, layout: str,
                 name: str = "k", own=None) -> torch.Tensor:
    """One-token decode attention of q (B, H, D) over the positions below
    ``length`` (an int) of a KV cache of ``layout`` ("bskd" or "bksd"),
    and, with ``own`` (the token's k, v (B, KH, D)), over the token itself
    merged as its own partial (``decode_step_v3``). Returns (B, H, D) in
    q's type.

    On a mesh of ranks (the rows layout) the caches are this rank's
    blocks of cache leaf ``name`` (``act_sharding.cache_split``):
      * on positions, each rank is the owner of S/M of them: its partial
        over those below ``length``, the M partials stacked over the model
        axis (B x H x (D + 2) floats a rank) and merged;
      * on KV heads, each rank attends for its H/M query heads, and the
        outputs are gathered (B x H x D / M a rank);
      * on the head dim, the scores are a sum over the model axis (B x H x
        S floats a rank, the one exchange that grows with the cache: the
        rules pick the head dim only where a rank's positions number
        fewer than the head's dims), each rank weighs its slice of the
        values, and the slices are gathered.
    """
    if layout == "bskd":
        k_cache, v_cache = k_cache.transpose(1, 2), v_cache.transpose(1, 2)
    role, index = _split_role(layout, name)
    if role == "k":
        # the rank's KV heads' query heads: GQA groups are contiguous
        kh = k_cache.shape[1]
        hq = q.shape[1] // act_sharding.model_coord()[1]
        q = q.narrow(1, index * hq, hq)
        if own is not None:
            own = tuple(t.narrow(1, index * kh, kh) for t in own)
        return act_sharding.model_gather(
            _attend_whole(q, k_cache, v_cache, length, own), 1)
    if role == "s":
        part = owner_partial(q, k_cache, v_cache, length,
                             index * k_cache.shape[2])
        stacked = [act_sharding.gather_model(t) for t in part]
        return merge_owners(list(zip(*(t.unbind(0) for t in stacked))), q,
                            own)
    if role == "d":
        return _attend_head_dim(q, k_cache, v_cache, length, own, index)
    return _attend_whole(q, k_cache, v_cache, length, own)


def owner_partial(q: torch.Tensor, k_block: torch.Tensor,
                  v_block: torch.Tensor, length: int, start: int):
    """The partial (acc, m, l) of the owner of positions start.. of a
    KH-major cache (its block (B, KH, S_o, D)) over those below
    ``length``."""
    local = min(max(length - start, 0), k_block.shape[2])
    return decode_partial(q, k_block, v_block, local)


def merge_owners(parts, q: torch.Tensor, own=None) -> torch.Tensor:
    """The attention output (B, H, D) in q's type from every owner's
    partial, in the owners' order, merged with the token's own (``own``:
    its k, v (B, KH, D)) where given."""
    parts = list(parts)
    if own is not None:
        parts.append(self_partial(q, *own))
    return normalize(*merge_partials(parts)).to(q.dtype)


def _attend_whole(q, k_cache, v_cache, length, own):
    """The one-card decode attention over KH-major caches: softmax of the
    scores, or with ``own`` the cache's partial merged with the token's."""
    if own is None:
        return decode_attention_khmajor(q, k_cache, v_cache, length)
    return merge_owners([decode_partial(q, k_cache, v_cache, length)], q,
                        own)


def _attend_head_dim(q, k_cache, v_cache, length, own, index):
    """``cache_attend`` over KH-major blocks split on the head dim."""
    b, h, d = q.shape
    kh, slots, dr = k_cache.shape[1:]
    qr = q.to(k_cache.dtype).float().reshape(b, kh, h // kh, d)
    qr = qr.narrow(3, index * dr, dr)
    s = act_sharding.model_sum(torch.einsum("bkgd,bksd->bkgs", qr,
                                            k_cache.float())) * d ** -0.5
    valid = torch.arange(slots, device=q.device)[None, :] < length
    s = torch.where(valid[:, None, None, :], s, NEG_INF)
    if own is None:
        p = torch.softmax(s, dim=-1)
        out = torch.einsum("bkgs,bksd->bkgd", p.to(v_cache.dtype).float(),
                           v_cache.float()).reshape(b, h, dr).to(q.dtype)
        return act_sharding.model_gather(out, 2)
    m = s.amax(dim=3)
    p = torch.where(valid[:, None, None, :], torch.exp(s - m[..., None]),
                    0.0)
    acc = torch.einsum("bkgs,bksd->bkgd", p.to(v_cache.dtype).float(),
                       v_cache.float())
    acc_own, m_own, l_own = self_partial(q, *own)
    acc_own = acc_own.narrow(2, index * dr, dr)
    parts = [(acc.reshape(b, h, dr), m.reshape(b, h),
              p.sum(dim=3).reshape(b, h)), (acc_own, m_own, l_own)]
    return act_sharding.model_gather(
        normalize(*merge_partials(parts)).to(q.dtype), 2)


def attention_decode(p: dict, x: torch.Tensor, cfg, cache_k: torch.Tensor,
                     cache_v: torch.Tensor, pos, name: str = "k"):
    """x: (B, 1, d); caches (B, Smax, KH, D). Writes the token's k and v
    at ``pos`` into the caches (in place: the reference's update is
    functional and its caches donated) and attends over positions
    0..pos. Returns (y (B, 1, d), cache_k, cache_v). On a mesh of ranks
    the caches are this rank's blocks of cache leaf ``name``
    (``write_token``, ``cache_attend``)."""
    b = x.shape[0]
    pos = check_pos(pos, cache_slots(cache_k, "bskd", name))
    positions = torch.full((b, 1), pos, dtype=torch.int32, device=x.device)
    q, k, v = qkv_proj(p, x, cfg, positions)
    write_token(cache_k, k[:, 0], pos, "bskd", name)
    write_token(cache_v, v[:, 0], pos, "bskd", name)
    out = cache_attend(q[:, 0], cache_k, cache_v, pos + 1, "bskd", name)
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
