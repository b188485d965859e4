"""Public paged-decode ops and the associative partial merge.

``merge_partials`` is the log-sum-exp combine that joins the partials
computed by different page owners: any grouping of pages, computed by
any owner, merges to the same answer, which is what makes ownership
re-partitioning free for the math. Both ops dispatch by device: the
kernel for CUDA tensors, its plain version for CPU tensors (the
reference's ``use_kernel`` switch has no counterpart).
"""

from __future__ import annotations

import torch

from .decode_attention import paged_decode_attention
from .ref import normalize


def merge_partials(parts):
    """parts: iterable of (acc (B,H,D), m (B,H), l (B,H)) partials.
    Returns the merged (acc, m, l)."""
    parts = list(parts)
    acc, m, l = parts[0]
    for acc2, m2, l2 in parts[1:]:
        m_new = torch.maximum(m, m2)
        a1 = torch.exp(m - m_new)
        a2 = torch.exp(m2 - m_new)
        acc = acc * a1[..., None] + acc2 * a2[..., None]
        l = l * a1 + l2 * a2
        m = m_new
    return acc, m, l


def paged_decode(q, k_pages, v_pages, page_table, page_pos, lengths):
    """Normalised paged decode attention: (B, H, D) in q's type."""
    acc, m, l = paged_decode_attention(q, k_pages, v_pages, page_table,
                                       page_pos, lengths)
    return normalize(acc, m, l).to(q.dtype)


def paged_decode_partial(q, k_pages, v_pages, page_table, page_pos,
                         lengths):
    """Un-normalised partials for cross-owner merging."""
    return paged_decode_attention(q, k_pages, v_pages, page_table, page_pos,
                                  lengths)
