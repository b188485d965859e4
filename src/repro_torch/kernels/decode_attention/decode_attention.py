"""Kernel 6, paged decode attention: one decode query per row over the KV
pages its page table names, returning the un-normalised partials
(acc, m, l) that ``ops.merge_partials`` combines across page owners
(``csrc/paged_decode_attention.cu``).

CPU tensors run the plain version in ref.py; CUDA tensors run the
kernel. The kernel reads q in its own type (f32 or bf16, rows through a
stride that may be 0) and f32 or bf16 pages as they are, and computes in
f32. Each row's slots are split across blocks (``split_count``) and the
splits merged inside the same launch: one launch per call.

The kernel's outputs carry no autograd graph, and no path trains through
the paged decode: on the card an input that requires grad raises.
"""

from __future__ import annotations

import torch

from ...device import on_cuda
from .. import _build
from .ref import paged_decode_ref

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (16, 32, 64, 128)
TILE = 64           # tokens: no split is shorter, unless it is the only one
H100_SMS = 132

# per (device, stream): the kernel's split counters, zeros between launches.
# Launches on one stream run in order, so they may share counters; two
# streams never do, so split launches in flight at once never mix tickets.
_tickets: dict[tuple[int, int], torch.Tensor] = {}


def split_count(blocks: int, slots: int, page_size: int,
                sms: int = H100_SMS) -> int:
    """How many runs of slots each row is split into, for ``blocks``
    blocks before splitting (rows x kv heads x head groups): about two
    waves of ``sms`` SMs, every run at least one TILE of tokens, and no
    split when the blocks already fill two waves."""
    waves = 2 * sms
    if blocks >= waves:
        return 1
    tile_slots = -(-TILE // page_size)
    return max(1, min(-(-waves // blocks), slots // tile_slots))


def split_bounds(nsplit: int, slots: int) -> list[int]:
    """The slot boundaries of the runs, as the kernel cuts them: run s
    covers slots [bounds[s], bounds[s + 1])."""
    return [s * slots // nsplit for s in range(nsplit + 1)]


def head_block(group: int) -> int:
    """Query heads of one kv head that share a block: the largest of 8, 4,
    2, 1 dividing the group."""
    return next(g for g in (8, 4, 2, 1) if group % g == 0)


def _tickets_for(device: torch.device, stream: int, n: int) -> torch.Tensor:
    """At least ``n`` zeroed int32 counters for launches on ``stream`` of
    ``device``, allocated once (again only to grow); each launch leaves
    them zero. ``stream`` is the current stream, on which the buffer is
    allocated and zeroed, so the caching allocator orders its reuse
    after the stream's launches."""
    idx = device.index if device.index is not None else \
        torch.cuda.current_device()
    t = _tickets.get((idx, stream))
    if t is None or t.numel() < n:
        t = torch.zeros(max(n, 4096), dtype=torch.int32, device=device)
        _tickets[(idx, stream)] = t
    return t


def paged_decode_attention(q, k_pages, v_pages, page_table, page_pos,
                           lengths):
    """q: (B, H, D); k_pages, v_pages: (NP, PS, KH, D), one type;
    page_table: (B, P) int32 page ids (-1 = no page; ids must be < NP);
    page_pos: (B, P) int32 token position of each slot's first row;
    lengths: (B,) int32 kv length of each row.

    Rows are independent: the page owners of one sequence go as rows of
    one call, with q the same row for each (``q.expand``, stride 0).
    Returns (acc (B, H, D), m (B, H), l (B, H)) in f32, so that
    attention = acc / l once the partials of all owners are merged. On
    the card an input that requires grad (with grad enabled) raises: the
    kernel's outputs carry no graph."""
    if not on_cuda(q, k_pages, v_pages, page_table, page_pos, lengths):
        return paged_decode_ref(q, k_pages, v_pages, page_table, page_pos,
                                lengths)
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (q, k_pages, v_pages)):
        raise RuntimeError("paged_decode_attention records no autograd "
                           "graph on the card; no path trains through it")
    b, h, d = q.shape
    num_pages, ps, kh, _ = k_pages.shape
    if v_pages.shape != k_pages.shape or k_pages.shape[3] != d or h % kh:
        raise ValueError("pages must be (NP, PS, KH, D) with q's D, and H a "
                         "multiple of KH")
    if k_pages.dtype not in _DTYPES or v_pages.dtype != k_pages.dtype:
        raise TypeError(f"pages: expected float32 or bfloat16, got "
                        f"{k_pages.dtype}, {v_pages.dtype}")
    if q.dtype not in _DTYPES:
        raise TypeError(f"q: expected float32 or bfloat16, got {q.dtype}")
    if d not in HEAD_DIMS:
        raise ValueError(f"head dim {d} not in {HEAD_DIMS}")
    if q.stride(2) != 1 or (h > 1 and q.stride(1) != d):
        raise ValueError("q: each row's (H, D) must be contiguous")
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
    gb = head_block(h // kh)
    blocks = b * kh * (h // kh // gb)
    nsplit = split_count(blocks, slots, ps,
                         torch.cuda.get_device_properties(
                             q.device).multi_processor_count)
    acc = torch.empty((b, h, d), dtype=torch.float32, device=q.device)
    m = torch.empty((b, h), dtype=torch.float32, device=q.device)
    l = torch.empty((b, h), dtype=torch.float32, device=q.device)
    partials = tickets = None
    if nsplit > 1:
        partials = torch.empty(b * h * nsplit * (d + 2), dtype=torch.float32,
                               device=q.device)
        tickets = _tickets_for(q.device, _build.stream(q), blocks)
    _build.launch("paged_decode_attention", "paged_decode_attention_launch",
                  b, _DTYPES[k_pages.dtype], _DTYPES[q.dtype], q.data_ptr(),
                  q.stride(0), k_pages.data_ptr(), v_pages.data_ptr(),
                  page_table.data_ptr(), page_pos.data_ptr(),
                  lengths.data_ptr(), b, h, kh, num_pages, ps, slots, d, gb,
                  nsplit, d ** -0.5, acc.data_ptr(), m.data_ptr(),
                  l.data_ptr(), partials.data_ptr() if nsplit > 1 else 0,
                  tickets.data_ptr() if nsplit > 1 else 0, _build.stream(q))
    return acc, m, l
