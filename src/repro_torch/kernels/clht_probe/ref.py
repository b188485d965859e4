"""Plain torch versions of the clht_probe kernels, and the un-fused
oracle of kvs_lookup. The wrappers in clht_probe.py run these on CPU
tensors; on the card they are what the kernels are held against."""

from __future__ import annotations

import torch

from ...core.clht import LINK, SLOTS, clht_lookup


def clht_probe_ref(lines: torch.Tensor, bucket_ids: torch.Tensor,
                   keys: torch.Tensor):
    """Kernel A's function: the primary bucket line of each key only.
    Returns (ptrs, found) as int32, ptr -1 where absent."""
    rows = lines[bucket_ids.long().clamp(0, lines.shape[0] - 1)]
    keys = keys.to(torch.int32)
    hit = (rows[:, :SLOTS] == keys[:, None]) & (keys[:, None] >= 0)
    found = hit.any(dim=1)
    ptr = torch.where(hit, rows[:, SLOTS:LINK], 0).sum(dim=1)
    ptr = torch.where(found, ptr, -1)
    return ptr.to(torch.int32), found.to(torch.int32)


def kvs_lookup_fused_ref(lines: torch.Tensor, heap: torch.Tensor,
                         bucket_ids: torch.Tensor, keys: torch.Tensor):
    """Kernel B's function: kernel A's probe plus the heap row gather,
    zero rows where the pointer is negative, a pointer past the heap
    clamped to its last row. Returns (vals, ptrs, found) int32."""
    ptr, found = clht_probe_ref(lines, bucket_ids, keys)
    rows = heap[ptr.long().clamp(0, heap.shape[0] - 1)]
    vals = torch.where((ptr >= 0)[:, None], rows, 0).to(torch.int32)
    return vals, ptr, found


def kvs_lookup_ref(table, heap, keys: torch.Tensor):
    """Oracle of the fused kvs_lookup: full chain-walk lookup followed by
    a heap gather -- the un-fused two-round-trip path."""
    ptrs, found, _ = clht_lookup(table, keys)
    rows = heap.data[ptrs.long().clamp(0, heap.data.shape[0] - 1)]
    vals = torch.where(found[:, None], rows, 0).to(torch.int32)
    return vals, ptrs, found
