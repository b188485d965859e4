"""Public read path: full CLHT lookup = the probe kernel (primary bucket,
one line per key) + the torch chain walk for keys that missed a chained
primary bucket -- the common-case/slow-path split P-CLHT gets from its
cache-line buckets. The chain walk runs only on the keys that need it
(the reference walks every key and selects; the results are the same)."""

from __future__ import annotations

import torch

from ...core.clht import CLHT, EMPTY, bucket_of, clht_lookup
from ...core.log import ValueHeap
from .clht_probe import clht_probe, kvs_lookup_fused


def _needs_chain_walk(table: CLHT, bucket_ids, found_fast) -> torch.Tensor:
    """Indices of keys not found in the primary bucket AND whose primary
    bucket has a chain link (otherwise a true miss)."""
    has_chain = table.nxt[bucket_ids.long()] >= 0
    return ((found_fast == 0) & has_chain).nonzero().flatten()


def _probe_and_walk(table: CLHT, keys: torch.Tensor):
    """The probe kernel over the primary lines, then the chain walk for
    the keys that missed a chained line. Returns (keys int32, ptrs int32,
    found bool, lines walked int32)."""
    keys = keys.to(torch.int32).contiguous()
    bucket_ids = bucket_of(keys, table.num_buckets)
    ptrs, found = clht_probe(table.lines, bucket_ids, keys)
    found = found.to(torch.bool)
    walked = torch.ones_like(ptrs)
    slow = _needs_chain_walk(table, bucket_ids, found)
    if slow.numel():
        ptrs[slow], found[slow], walked[slow] = clht_lookup(table,
                                                            keys[slow])
    return keys, ptrs, found, walked


def lookup(table: CLHT, keys: torch.Tensor):
    """Batched CLHT lookup through the probe kernel. Returns (ptrs int32,
    found bool) like core.clht.clht_lookup (minus the probe counter)."""
    _, ptrs, found, _ = _probe_and_walk(table, keys)
    return ptrs, found


def lookup_walk(table: CLHT, keys: torch.Tensor):
    """Batched index reads as the DPM pool's ``index_lookup_batch`` makes
    them. Returns (ptrs, walked), int32: the pointer (-1 where absent, and
    for every negative key, since the only negative key a table holds is
    the empty mark, whose pointer is -1) and the lines walked, equal to
    ``NumpyCLHT.lookup_batch``'s (ptrs, probes) on the same table."""
    keys, ptrs, found, walked = _probe_and_walk(table, keys)
    return torch.where(found & (keys >= 0), ptrs, EMPTY), walked


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
