"""Public DPM write path:

* merge_segment_fast -- merge a LogSegment's pending window into a CLHT:
  the log_merge kernel for entries whose primary bucket takes them, and
  the sequential clht_insert (kernel D on the card) for the entries whose
  bucket was full;
* log_append_merge -- the fused batched KVS *write* op, the write-side
  analog of clht_probe.kvs_lookup: one out-of-place heap append, one
  sealed log append, and the merge of exactly the pending window.
"""

from __future__ import annotations

import torch

from ...core.clht import CLHT, EMPTY, bucket_of, clht_insert
from ...core.log import SEALED, LogSegment, ValueHeap, heap_append, log_append
from .log_merge import log_merge


def unpack_table(lines: torch.Tensor, table: CLHT) -> CLHT:
    """The table whose packed lines are ``lines`` (the lines are the
    port's canonical table, so this only wraps them)."""
    return CLHT(lines=lines, overflow_head=table.overflow_head,
                num_buckets=table.num_buckets)


def merge_segment_fast(table: CLHT, seg: LogSegment):
    """Merge the sealed entries of ``seg``'s pending window
    ``[seg.merged, seg.count)`` into ``table``, in place.

    Fast path: the log_merge kernel (primary bucket, in place). Slow
    path: entries whose bucket was full go through clht_insert in log
    order (a failed key's later duplicates also failed the fast path, so
    relative order is intact). Returns (table, old_ptrs, ok) for the
    window's entries. The reference works over the whole segment with
    entries outside the window masked; those change nothing and report
    old=-1, ok=False, so the window's results are the same."""
    lo, hi = seg.merged, seg.count
    wkeys = seg.keys[lo:hi]
    wptrs = seg.ptrs[lo:hi]
    todo = seg.seal[lo:hi] == SEALED
    # masked-out entries probe bucket 0 with key -3 (never matches, never
    # claims a slot)
    keys = torch.where(todo, wkeys, -3)
    safe_keys = torch.where(keys < 0, 0, keys)
    bids = torch.where(todo, bucket_of(safe_keys, table.num_buckets), 0)
    _, old, ok = log_merge(table.lines, bids, keys, wptrs)
    ok = (ok == 1) & todo
    slow = (todo & ~ok).nonzero().flatten()
    if slow.numel():
        _, old_slow, ok_slow, _ = clht_insert(table, wkeys[slow], wptrs[slow])
        old[slow] = old_slow
        ok[slow] = ok_slow
    return table, old, ok


def log_append_merge(table: CLHT, seg: LogSegment, heap: ValueHeap,
                     keys: torch.Tensor, values: torch.Tensor):
    """Fused batched write path (paper Secs. 3.2 + 3.6): append the value
    rows to the heap out of place, append the sealed (key, ptr) entries
    to the exclusive log segment, and merge the segment's pending window
    into the CLHT. Updates table, segment and heap in place, and only
    once it knows the batch fits in the segment.

    Returns (table, seg, heap, ptrs, old_ptrs, ok):
      ptrs      (B,) int32 heap rows assigned to the batch (-1 if no room)
      old_ptrs  (B,) int32 value rows superseded per entry (-1 fresh)
      ok        (B,) bool. All-False (with table/seg/heap unchanged and
                ptrs -1) when the batch did not fit in the segment;
                otherwise ok[i] is False only for entries whose CLHT
                insert failed (table full even via the overflow chain)
    Matches ``log_append_merge_ref`` exactly."""
    n = keys.shape[0]
    dev = keys.device
    if seg.count + n > seg.capacity:
        none = torch.full((n,), EMPTY, dtype=torch.int32, device=dev)
        return (table, seg, heap, none, none.clone(),
                torch.zeros(n, dtype=torch.bool, device=dev))
    start = seg.count
    heap, ptrs = heap_append(heap, values)
    seg, _ = log_append(seg, keys, ptrs)
    lo = seg.merged
    table, old, ok = merge_segment_fast(table, seg)
    seg.merged = seg.count
    return table, seg, heap, ptrs, old[start - lo:], ok[start - lo:]
