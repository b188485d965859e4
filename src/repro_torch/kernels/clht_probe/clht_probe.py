"""Kernels A and B of the read path: the batched P-CLHT bucket probe
(the paper's index lookup) and the probe fused with the value gather.

Each bucket is one packed 8-int32 line (``core.clht``), so a probe reads
one 32-byte sector, the paper's one cache line per lookup. Keys that miss
their primary bucket while it has a chain go to the chain walk in ops.py,
the paper's common-case/slow-path split.

CPU tensors run the plain versions in ref.py; CUDA tensors run the
kernels of ``csrc/clht_probe.cu``.
"""

from __future__ import annotations

import torch

from ...core.clht import LINE, LINK, SLOTS
from ...device import on_cuda
from .. import _build
from .ref import clht_probe_ref, kvs_lookup_fused_ref


def pack_table(keys: torch.Tensor, ptrs: torch.Tensor,
               nxt: torch.Tensor) -> torch.Tensor:
    """(TB, S) keys + (TB, S) ptrs + (TB,) next -> (TB, 8) lines."""
    tb, slots = keys.shape
    assert slots == SLOTS, "a bucket line holds 3 slots"
    lines = torch.full((tb, LINE), -1, dtype=torch.int32, device=keys.device)
    lines[:, :SLOTS] = keys
    lines[:, SLOTS:LINK] = ptrs
    lines[:, LINK] = nxt
    return lines


def _check_probe_args(lines, bucket_ids, keys):
    _build.require(lines, "lines", torch.int32, 2, align=16)
    if lines.shape[1] != LINE:
        raise ValueError(f"lines: expected {LINE} lanes, got {lines.shape}")
    _build.require(bucket_ids, "bucket_ids", torch.int32, 1)
    _build.require(keys, "keys", torch.int32, 1)
    if bucket_ids.shape != keys.shape:
        raise ValueError("bucket_ids and keys differ in shape")


def clht_probe(lines: torch.Tensor, bucket_ids: torch.Tensor,
               keys: torch.Tensor):
    """Probe the primary bucket of each key.

    lines:      (TB, 8) packed bucket lines
    bucket_ids: (B,) int32 primary bucket of each key
    keys:       (B,) int32 probe keys (negative keys never match)
    returns (ptrs, found): (B,) int32 pointer (-1 if absent from the
    primary bucket) and (B,) int32 {0,1} hit flag.
    """
    if not on_cuda(lines, bucket_ids, keys):
        return clht_probe_ref(lines, bucket_ids, keys)
    _check_probe_args(lines, bucket_ids, keys)
    n = keys.shape[0]
    ptrs = torch.empty(n, dtype=torch.int32, device=keys.device)
    found = torch.empty(n, dtype=torch.int32, device=keys.device)
    if n:
        _build.launch("clht_probe", "clht_probe_launch", n,
                      lines.data_ptr(), lines.shape[0], bucket_ids.data_ptr(),
                      keys.data_ptr(), n, ptrs.data_ptr(), found.data_ptr(),
                      _build.stream(keys))
    return ptrs, found


def kvs_lookup_fused(lines: torch.Tensor, heap: torch.Tensor,
                     bucket_ids: torch.Tensor, keys: torch.Tensor):
    """Fused KVS lookup: probe each key's primary bucket AND gather its
    value row from the heap in one kernel.

    lines:      (TB, 8) packed bucket lines
    heap:       (H, D) int32 value rows (core.log.ValueHeap.data)
    bucket_ids: (B,) int32 primary buckets
    keys:       (B,) int32 probe keys (any B)

    Returns (values, ptrs, found): (B, D) gathered rows (zeros where
    absent), (B,) int32 pointers (-1 if absent from the primary bucket),
    (B,) int32 {0,1} hit flags.
    """
    if not on_cuda(lines, heap, bucket_ids, keys):
        return kvs_lookup_fused_ref(lines, heap, bucket_ids, keys)
    _check_probe_args(lines, bucket_ids, keys)
    _build.require(heap, "heap", torch.int32, 2)
    n = keys.shape[0]
    h, d = heap.shape
    vals = torch.empty((n, d), dtype=torch.int32, device=keys.device)
    ptrs = torch.empty(n, dtype=torch.int32, device=keys.device)
    found = torch.empty(n, dtype=torch.int32, device=keys.device)
    if n:
        _build.launch("kvs_lookup_fused", "kvs_lookup_fused_launch", n,
                      lines.data_ptr(), lines.shape[0], heap.data_ptr(), h, d,
                      bucket_ids.data_ptr(), keys.data_ptr(), n,
                      vals.data_ptr(), ptrs.data_ptr(), found.data_ptr(),
                      _build.stream(keys))
    return vals, ptrs, found
