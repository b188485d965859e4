"""Kernel 6, paged decode attention: one decode query per sequence over
the KV pages its page table names, returning the un-normalised partials
(acc, m, l) that ``ops.merge_partials`` combines across page owners
(``csrc/paged_decode_attention.cu``).

CPU tensors run the plain version in ref.py; CUDA tensors run the
kernel. The kernel computes in f32: the wrapper converts q (bf16 on the
server) to f32, and the kernel reads f32 or bf16 pages as they are.
"""

from __future__ import annotations

import torch

from ...device import on_cuda
from .. import _build
from .ref import paged_decode_ref

_PAGE_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (16, 32, 64, 128)


def paged_decode_attention(q, k_pages, v_pages, page_table, page_pos,
                           lengths):
    """q: (B, H, D); k_pages, v_pages: (NP, PS, KH, D), one type;
    page_table: (B, P) int32 page ids (-1 = no page; ids must be < NP);
    page_pos: (B, P) int32 token position of each slot's first row;
    lengths: (B,) int32 kv length of each sequence.

    Returns (acc (B, H, D), m (B, H), l (B, H)) in f32, so that
    attention = acc / l once the partials of all owners are merged."""
    if not on_cuda(q, k_pages, v_pages, page_table, page_pos, lengths):
        return paged_decode_ref(q, k_pages, v_pages, page_table, page_pos,
                                lengths)
    b, h, d = q.shape
    num_pages, ps, kh, _ = k_pages.shape
    if v_pages.shape != k_pages.shape or k_pages.shape[3] != d or h % kh:
        raise ValueError("pages must be (NP, PS, KH, D) with q's D, and H a "
                         "multiple of KH")
    if k_pages.dtype not in _PAGE_DTYPES or v_pages.dtype != k_pages.dtype:
        raise TypeError(f"pages: expected float32 or bfloat16, got "
                        f"{k_pages.dtype}, {v_pages.dtype}")
    if d not in HEAD_DIMS:
        raise ValueError(f"head dim {d} not in {HEAD_DIMS}")
    for name, t in (("k_pages", k_pages), ("v_pages", v_pages)):
        _build.require(t, name, k_pages.dtype, 4, align=16)
    slots = page_table.shape[1]
    for name, t, shape in (("page_table", page_table, (b, slots)),
                           ("page_pos", page_pos, (b, slots)),
                           ("lengths", lengths, (b,))):
        _build.require(t, name, torch.int32, len(shape))
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: expected {shape}, got "
                             f"{tuple(t.shape)}")
    qf = q.float().contiguous()
    acc = torch.empty((b, h, d), dtype=torch.float32, device=q.device)
    m = torch.empty((b, h), dtype=torch.float32, device=q.device)
    l = torch.empty((b, h), dtype=torch.float32, device=q.device)
    _build.launch("paged_decode_attention", "paged_decode_attention_launch",
                  b, _PAGE_DTYPES[k_pages.dtype], qf.data_ptr(),
                  k_pages.data_ptr(), v_pages.data_ptr(),
                  page_table.data_ptr(), page_pos.data_ptr(),
                  lengths.data_ptr(), b, h, kh, num_pages, ps, slots, d,
                  d ** -0.5, acc.data_ptr(), m.data_ptr(), l.data_ptr(),
                  _build.stream(q))
    return acc, m, l
