"""Plain torch versions of the flash_attention kernel (the port's copies of
the reference's dense oracle ``mha_ref`` and of its blocked online-softmax
versions ``blocked_mha_jnp`` and ``blocked_mha_heads``). The wrapper in
flash_attention.py runs one of them on CPU and meta tensors, as the
reference's ``attention`` does off the TPU (``plain_attention``); on the
card they are what the kernel is held against."""

from __future__ import annotations

import torch

NEG_INF = -1e30


def mha_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
            causal: bool = True) -> torch.Tensor:
    """q: (B, H, Sq, D); k, v: (B, KH, Sk, D). Returns (B, H, Sq, D) in
    q's type. Dense softmax in f32; the causal mask is the reference
    oracle's bottom-right one (``tril(k=Sk-Sq)``), which equals the
    kernel's top-left mask only when Sq == Sk."""
    b, h, sq, d = q.shape
    kh, sk = k.shape[1], k.shape[2]
    group = h // kh
    kx = torch.repeat_interleave(k, group, dim=1).float()
    vx = torch.repeat_interleave(v, group, dim=1).float()
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), kx) * d ** -0.5
    if causal:
        mask = torch.tril(torch.ones((sq, sk), dtype=torch.bool,
                                     device=q.device), diagonal=sk - sq)
        s = torch.where(mask, s, NEG_INF)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    p = p / p.sum(dim=-1, keepdim=True)
    return torch.einsum("bhqk,bhkd->bhqd", p, vx).to(q.dtype)


def _online_block(carry, s, vc):
    """One kv block of the online softmax: fold the scaled scores ``s``
    (..., Sq, bk) f32 and values ``vc`` (..., bk, D) into the running
    (m, l, acc); P is rounded to v's type for P.V, as in the reference."""
    m, l, acc = carry
    m_new = torch.maximum(m, s.amax(dim=-1))
    p = torch.exp(s - m_new[..., None])
    alpha = torch.exp(m - m_new)
    l = l * alpha + p.sum(dim=-1)
    acc = acc * alpha[..., None] + torch.einsum(
        "...qc,...cd->...qd", p.to(vc.dtype).float(), vc.float())
    return m_new, l, acc


def _blocked(qf, k, v, causal: bool, scale: float, bk: int, lead: tuple):
    """The scan over kv blocks of ``bk`` keys shared by the two blocked
    versions: qf (*lead, Sq, D) against k, v (*lead[:2], bk blocks, D)
    broadcast over ``lead``'s trailing dims. Returns acc / l in f32."""
    sq, d = qf.shape[-2:]
    sk = k.shape[2]
    if sk % bk:
        raise ValueError(f"{sk} keys are not a multiple of blocks of {bk}")
    expand = (slice(None), slice(None)) + (None,) * (len(lead) - 2)
    qpos = torch.arange(sq, device=qf.device) + (sk - sq)
    m = torch.full(lead + (sq,), NEG_INF, dtype=torch.float32,
                   device=qf.device)
    l = torch.zeros(lead + (sq,), dtype=torch.float32, device=qf.device)
    acc = torch.zeros(lead + (sq, d), dtype=torch.float32, device=qf.device)
    qf = qf.float()
    for i in range(sk // bk):
        kc = k[:, :, i * bk:(i + 1) * bk][expand]
        vc = v[:, :, i * bk:(i + 1) * bk][expand]
        s = torch.einsum("...qd,...cd->...qc", qf, kc.float()) * scale
        if causal:
            kpos = i * bk + torch.arange(bk, device=qf.device)
            s = torch.where(qpos[:, None] >= kpos[None, :], s, NEG_INF)
        m, l, acc = _online_block((m, l, acc), s, vc)
    return acc / torch.clamp(l, min=1e-30)[..., None]


def blocked_mha(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                causal: bool = True, scale: float | None = None,
                bk: int = 1024) -> torch.Tensor:
    """Online-softmax attention in plain torch (the port's copy of the
    reference's ``blocked_mha_jnp``): a loop over kv blocks of ``bk`` keys
    carrying (m, l, acc) in f32 -- mathematically the flash kernel, with
    O(S * bk) score buffers instead of O(S^2). The products take both
    operands in f32 (bf16 products are exact there, as under the
    reference's ``preferred_element_type``); the causal mask is on the
    last Sq positions (bottom-right); P is rounded to v's type for P.V.

    q: (B, H, Sq, D); k, v: (B, KH, Sk, D) with Sk a multiple of
    min(bk, Sk). Returns (B, H, Sq, D) in q's type."""
    b, h, sq, d = q.shape
    kh = k.shape[1]
    group = h // kh
    out = _blocked(q.reshape(b, kh, group, sq, d), k, v, causal,
                   d ** -0.5 if scale is None else scale,
                   min(bk, k.shape[2]), (b, kh, group))
    return out.reshape(b, h, sq, d).to(q.dtype)


def blocked_mha_heads(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      causal: bool = True, scale: float | None = None,
                      bk: int = 1024) -> torch.Tensor:
    """Head-major blocked attention (the port's copy of the reference's
    ``blocked_mha_heads``): GQA K/V are expanded to all H heads once, and
    every tensor keeps its (B, H, S, D) layout, which the reference picks
    so that a head-sharding constraint needs no resharding. The math is
    ``blocked_mha``'s."""
    b, h, sq, d = q.shape
    group = h // k.shape[1]
    if group > 1:
        k = torch.repeat_interleave(k, group, dim=1)
        v = torch.repeat_interleave(v, group, dim=1)
    out = _blocked(q, k, v, causal, d ** -0.5 if scale is None else scale,
                   min(bk, k.shape[2]), (b, h))
    return out.to(q.dtype)
