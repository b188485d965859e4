"""Plain torch version of the flash_attention kernel (the port's copy of
the reference's dense oracle). The wrapper in flash_attention.py runs it
on CPU tensors; on the card it is what the kernel is held against."""

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
