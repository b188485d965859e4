"""Plain torch version of the paged_decode_attention kernel (the port's
copy of the reference's oracle), and ``normalize``. The wrapper in
decode_attention.py runs it on CPU tensors; on the card it is what the
kernel is held against."""

from __future__ import annotations

import torch

NEG_INF = -1e30


def paged_decode_ref(q, k_pages, v_pages, page_table, page_pos, lengths):
    """Same contract as the kernel: un-normalised (acc (B,H,D), m (B,H),
    l (B,H)), all f32. A slot with page id -1, or whose position is at or
    past the length, contributes nothing."""
    b, h, d = q.shape
    _, ps, kh, _ = k_pages.shape
    group = h // kh
    p = page_table.shape[1]
    safe = page_table.long().clamp(min=0)
    k = k_pages[safe].reshape(b, p * ps, kh, d)          # (B, P*PS, KH, D)
    v = v_pages[safe].reshape(b, p * ps, kh, d)
    pos = page_pos[:, :, None].long() + torch.arange(ps, device=q.device)
    pos = torch.where(page_table[:, :, None] >= 0, pos, 1 << 30)
    valid = pos.reshape(b, p * ps) < lengths[:, None].long()

    qr = q.float().reshape(b, kh, group, d)
    kt = k.float().transpose(1, 2)                        # (B, KH, S, D)
    vt = v.float().transpose(1, 2)
    s = torch.einsum("bkgd,bksd->bkgs", qr, kt) * d ** -0.5
    s = torch.where(valid[:, None, None, :], s, NEG_INF)
    m = s.amax(dim=3)                                     # (B, KH, G)
    w = torch.exp(s - m[..., None])
    w = torch.where(valid[:, None, None, :], w, 0.0)
    l = w.sum(dim=3)
    acc = torch.einsum("bkgs,bksd->bkgd", w, vt)
    return acc.reshape(b, h, d), m.reshape(b, h), l.reshape(b, h)


def normalize(acc, m, l):
    return acc / torch.clamp(l, min=1e-30)[..., None]
