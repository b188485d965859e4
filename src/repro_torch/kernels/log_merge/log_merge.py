"""Kernel C of the write path: merge sealed log entries into CLHT bucket
lines (the DPM-processor hot spot, paper Sec. 3.6 'asynchronous post
processing of writes').

Entries are merged *in order* per bucket: ``log_merge`` stable-sorts them
by bucket -- legal because distinct buckets are independent and a stable
sort keeps log order within a bucket, the only order CLHT state depends
on -- finds where each bucket group starts, and hands the groups to
``log_merge_sorted``: on the card ``csrc/log_merge.cu`` walks each small
group on one thread and each group of more than ``WALK_MAX`` entries on a
block of threads, in parallel (its header says why that is exact); on the
CPU the plain torch version runs. Superseded pointers are
returned per entry so the caller can keep the per-segment GC counters of
paper Sec. 4.
"""

from __future__ import annotations

import torch

from ...core import spans
from ...core.clht import LINE
from ...device import on_cuda
from .. import _build
from .ref import log_merge_sorted_ref

# groups of at most this many entries are walked by one thread; larger ones
# by a block of 1024 threads
WALK_MAX = 32


def log_merge_sorted(lines: torch.Tensor, starts: torch.Tensor,
                     bucket_ids: torch.Tensor, keys: torch.Tensor,
                     ptrs: torch.Tensor):
    """Merge *bucket-sorted* entries into ``lines`` in place.

    lines:      (TB, 8) packed bucket lines, updated in place
    starts:     (G+1,) int32 first entry of each bucket group, then E
    bucket_ids: (E,) sorted bucket per entry
    keys, ptrs: (E,) int32 entries, log order within each group
    returns (old_ptrs, ok): (E,) int32 superseded pointer (-1 if none)
    and (E,) int32 {0,1} (0: bucket full or padding key).

    On the card nothing is read back to the host."""
    if not on_cuda(lines, starts, bucket_ids, keys, ptrs):
        return log_merge_sorted_ref(lines, starts, bucket_ids, keys, ptrs)
    _build.require(lines, "lines", torch.int32, 2, align=16)
    if lines.shape[1] != LINE:
        raise ValueError(f"lines: expected {LINE} lanes, got {lines.shape}")
    for t, name in ((starts, "starts"), (bucket_ids, "bucket_ids"),
                    (keys, "keys"), (ptrs, "ptrs")):
        _build.require(t, name, torch.int32, 1)
    e = keys.shape[0]
    if not bucket_ids.shape == ptrs.shape == keys.shape:
        raise ValueError("bucket_ids, keys and ptrs differ in shape")
    old = torch.empty(e, dtype=torch.int32, device=keys.device)
    ok = torch.empty(e, dtype=torch.int32, device=keys.device)
    groups = starts.shape[0] - 1
    if groups > 0:
        # two counters (groups listed, groups drawn), then the large groups
        big = torch.empty(groups + 2, dtype=torch.int32, device=keys.device)
        big[:2].zero_()
        _build.launch("log_merge_sorted", "log_merge_sorted_launch", e,
                      lines.data_ptr(), lines.shape[0], starts.data_ptr(),
                      groups, bucket_ids.data_ptr(), keys.data_ptr(),
                      ptrs.data_ptr(), old.data_ptr(), ok.data_ptr(),
                      big.data_ptr(), WALK_MAX, _build.stream(keys))
    return old, ok


def sort_by_bucket(bucket_ids: torch.Tensor):
    """Stable sort of entries by bucket: (sorted bucket ids, order, group
    starts) with ``starts`` (G+1,) int32 the first entry of each bucket
    group, then E."""
    bids_s, order = torch.sort(bucket_ids.to(torch.int32), stable=True)
    first = torch.ones(bids_s.shape[0], dtype=torch.bool,
                       device=bids_s.device)
    first[1:] = bids_s[1:] != bids_s[:-1]
    with spans.span("dinomo.log_merge.group_starts", wait=True):
        heads = first.nonzero().flatten()
    with spans.span("dinomo.log_merge.group_end", wait=True):
        end = torch.tensor([bids_s.shape[0]], device=bids_s.device)
    starts = torch.cat([heads, end])
    return bids_s, order, starts.to(torch.int32)


def log_merge(lines: torch.Tensor, bucket_ids: torch.Tensor,
              keys: torch.Tensor, ptrs: torch.Tensor):
    """Merge entries (given in log order) into packed bucket lines.

    Stable-sorts by bucket, finds the group starts, runs
    ``log_merge_sorted`` and un-permutes the per-entry results. Updates
    ``lines`` in place; returns (lines, old_ptrs, ok) with int32 old/ok in
    log order."""
    bids_s, order, starts = sort_by_bucket(bucket_ids)
    old_s, ok_s = log_merge_sorted(
        lines, starts, bids_s, keys.to(torch.int32)[order].contiguous(),
        ptrs.to(torch.int32)[order].contiguous())
    old = torch.empty_like(old_s)
    ok = torch.empty_like(ok_s)
    old[order] = old_s
    ok[order] = ok_s
    return lines, old, ok
