"""Public DPM write path:

* merge_segment_fast -- merge a LogSegment's pending window into a CLHT:
  the log_merge kernel for entries whose primary bucket takes them, and
  the sequential clht_insert (kernel D on the card) for the entries whose
  bucket was full;
* log_append_merge -- the fused batched KVS *write* op, the write-side
  analog of clht_probe.kvs_lookup: one out-of-place heap append, one
  sealed log append, and the merge of exactly the pending window;
* merge_segment_planned -- the same merge through the DPM pool's host
  planner (core.transition.plan_merge_window): each planned window lands
  on the card as bulk row scatters, and the entries past the plans (a
  bucket whose chain must grow) go through clht_insert (kernel D).
"""

from __future__ import annotations

import numpy as np
import torch

from ...core import spans
from ...core.clht import (CLHT, EMPTY, LINK, SLOTS, bucket_of,
                          clht_insert)
from ...core.log import SEALED, LogSegment, ValueHeap, heap_append, log_append
from ...core.transition import plan_merge_window
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
    with spans.span("dinomo.log_append_merge.merge"):
        _, old, ok = log_merge(table.lines, bids, keys, wptrs)
    ok = (ok == 1) & todo
    with spans.span("dinomo.log_append_merge.slow_test", wait=True):
        slow = (todo & ~ok).nonzero().flatten()
    if slow.numel():
        with spans.span("dinomo.log_append_merge.slow_path"):
            _, old_slow, ok_slow, _ = clht_insert(table, wkeys[slow],
                                                  wptrs[slow])
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
    Matches ``log_append_merge_ref`` exactly. Its stages are
    ``core.spans``' ``dinomo.log_append_merge.*`` and
    ``dinomo.log_merge.*`` spans."""
    with spans.span("dinomo.log_append_merge"):
        n = keys.shape[0]
        dev = keys.device
        if seg.count + n > seg.capacity:
            none = torch.full((n,), EMPTY, dtype=torch.int32, device=dev)
            return (table, seg, heap, none, none.clone(),
                    torch.zeros(n, dtype=torch.bool, device=dev))
        start = seg.count
        with spans.span("dinomo.log_append_merge.append"):
            heap, ptrs = heap_append(heap, values)
            seg, _ = log_append(seg, keys, ptrs)
        lo = seg.merged
        table, old, ok = merge_segment_fast(table, seg)
        seg.merged = seg.count
        return table, seg, heap, ptrs, old[start - lo:], ok[start - lo:]


class _HostTableView:
    """Host-side numpy view of a CLHT for the merge planner (the same
    planner the DPM pool's NumpyCLHT plane uses): the lines come to the
    host once, as int64, and ``apply`` keeps the view level with the
    card's table after each plan."""

    __slots__ = ("keys", "ptrs", "nxt", "num_buckets")

    def __init__(self, table: CLHT):
        lines = table.lines.cpu().numpy().astype(np.int64)
        self.keys = lines[:, :SLOTS]
        self.ptrs = lines[:, SLOTS:LINK]
        self.nxt = lines[:, LINK]
        self.num_buckets = table.num_buckets

    def apply(self, plan) -> None:
        if plan.upd_rows.size:
            self.ptrs[plan.upd_rows, plan.upd_slots] = plan.upd_ptrs
        if plan.n_new:
            self.keys[plan.new_rows, plan.new_slots] = plan.new_keys
            self.ptrs[plan.new_rows, plan.new_slots] = plan.new_ptrs


def apply_merge_plan_tables(table: CLHT, plan) -> CLHT:
    """Apply one MergeWindowPlan to the table, in place: the planned
    layout lands as bulk scatters into the lines on the table's device
    (in-place final-pointer updates, then slot claims)."""
    lines, dev = table.lines, table.lines.device

    def put(rows, lanes, vals):
        lines[torch.from_numpy(rows).to(dev),
              torch.from_numpy(lanes).to(dev)] = \
            torch.from_numpy(vals.astype(np.int32)).to(dev)

    if plan.upd_rows.size:
        put(plan.upd_rows, plan.upd_slots + SLOTS, plan.upd_ptrs)
    if plan.n_new:
        put(plan.new_rows, plan.new_slots, plan.new_keys)
        put(plan.new_rows, plan.new_slots + SLOTS, plan.new_ptrs)
    return table


def merge_segment_planned(table: CLHT, seg: LogSegment):
    """Planned-layout merge of the sealed entries of ``seg``'s pending
    window ``[seg.merged, seg.count)`` into ``table``, in place: the
    host planner (core.transition.plan_merge_window, the exact engine
    behind the DPM pool's merge) resolves grouped bucket targets,
    per-bucket slot claims and per-entry superseded pointers in one
    vectorized sweep per window, and the card applies each plan as bulk
    scatters. Entries past a plan's self-truncation point (a bucket
    whose chain must grow, or a sub-plan-sized tail) go to the
    sequential ``clht_insert`` (kernel D on the card), in log order.
    Returns (table, old_ptrs, ok) for the window's entries, with
    merge_segment_fast's types and values."""
    lo, hi = seg.merged, seg.count
    dev = seg.keys.device
    tpos = np.flatnonzero(seg.seal[lo:hi].cpu().numpy() == SEALED)
    old = np.full(hi - lo, EMPTY, np.int64)
    ok = np.zeros(hi - lo, bool)
    view = _HostTableView(table)
    wkeys = seg.keys[lo:hi].cpu().numpy().astype(np.int64)[tpos]
    wptrs = seg.ptrs[lo:hi].cpu().numpy().astype(np.int64)[tpos]
    done = 0
    while done < tpos.size:
        plan = plan_merge_window(view, wkeys[done:], wptrs[done:],
                                 tombstones=False)
        if plan is None:
            break
        apply_merge_plan_tables(table, plan)
        view.apply(plan)              # keep the host view current
        sl = tpos[done:done + plan.ops]
        old[sl] = plan.old
        ok[sl] = True
        done += plan.ops
    if done < tpos.size:
        rest = tpos[done:]
        at = torch.from_numpy(rest + lo).to(dev)
        _, old_s, ok_s, _ = clht_insert(table, seg.keys[at], seg.ptrs[at])
        old[rest] = old_s.cpu().numpy()
        ok[rest] = ok_s.cpu().numpy()
    return (table, torch.from_numpy(old.astype(np.int32)).to(dev),
            torch.from_numpy(ok).to(dev))
