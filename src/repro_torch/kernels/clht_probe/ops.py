"""Public read path: full CLHT lookup = the probe kernel (primary bucket,
one line per key) + the torch chain walk for keys that missed a chained
primary bucket -- the common-case/slow-path split P-CLHT gets from its
cache-line buckets. The chain walk runs only on the keys that need it
(the reference walks every key and selects; the results are the same)."""

from __future__ import annotations

import torch

from ...core.clht import CLHT, bucket_of, clht_lookup
from ...core.log import ValueHeap
from .clht_probe import clht_probe, kvs_lookup_fused


def _needs_chain_walk(table: CLHT, bucket_ids, found_fast) -> torch.Tensor:
    """Indices of keys not found in the primary bucket AND whose primary
    bucket has a chain link (otherwise a true miss)."""
    has_chain = table.nxt[bucket_ids.long()] >= 0
    return ((found_fast == 0) & has_chain).nonzero().flatten()


def lookup(table: CLHT, keys: torch.Tensor):
    """Batched CLHT lookup through the probe kernel. Returns (ptrs int32,
    found bool) like core.clht.clht_lookup (minus the probe counter)."""
    keys = keys.to(torch.int32).contiguous()
    bucket_ids = bucket_of(keys, table.num_buckets)
    ptrs, found = clht_probe(table.lines, bucket_ids, keys)
    found = found.to(torch.bool)
    slow = _needs_chain_walk(table, bucket_ids, found)
    if slow.numel():
        ptr_slow, found_slow, _ = clht_lookup(table, keys[slow])
        ptrs[slow] = ptr_slow
        found[slow] = found_slow
    return ptrs, found


def kvs_lookup(table: CLHT, heap: ValueHeap, keys: torch.Tensor):
    """Batched KVS lookup: the fused probe+gather kernel, with the chain
    walk + gather as the slow path for keys that overflow their primary
    bucket.

    Returns (values, ptrs, found): (B, D) int32 value rows (zeros where
    absent), (B,) int32 heap pointers (-1 absent), (B,) bool flags.
    Matches ``kvs_lookup_ref`` exactly."""
    keys = keys.to(torch.int32).contiguous()
    bucket_ids = bucket_of(keys, table.num_buckets)
    vals, ptrs, found = kvs_lookup_fused(table.lines, heap.data, bucket_ids,
                                         keys)
    found = found.to(torch.bool)
    slow = _needs_chain_walk(table, bucket_ids, found)
    if slow.numel():
        ptr_slow, found_slow, _ = clht_lookup(table, keys[slow])
        rows = heap.data[ptr_slow.long().clamp(0, heap.data.shape[0] - 1)]
        ptrs[slow] = ptr_slow
        found[slow] = found_slow
        vals[slow] = torch.where(found_slow[:, None], rows, 0)
    return vals, ptrs, found
