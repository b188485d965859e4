"""Log-structured DPM writes + merge (paper Secs. 3.2, 3.6, 4), in torch.

KNs write key-value log entries into *exclusive* DPM log segments with a
single one-sided write; a seal byte (commit marker) makes each entry
crash-atomic. DPM processors later merge sealed entries *in order* into
the CLHT index.

A segment is a fixed-capacity array of (key, ptr, seal) records; values
live in an append-only ValueHeap. The entry count and merge cursor of a
segment and the heap's head are Python ints on the host: they follow from
the shapes of the batches appended, so keeping them there costs no device
sync. Functions update the segment and heap in place and return them.

``PySegment`` is the DPM pool's segment on the host (``core.dpm_pool``):
Python lists of entries, seal bytes, request IDs and fence generations,
the port's copy of the reference's.
"""

from __future__ import annotations

import dataclasses

import torch

from ..device import resolve_device
from .clht import CLHT, EMPTY, clht_insert

SEALED = 1
TORN = 0


@dataclasses.dataclass
class LogSegment:
    """An exclusive per-KN DPM log segment (fixed-capacity records + a
    value heap)."""
    keys: torch.Tensor   # (capacity,) int32
    ptrs: torch.Tensor   # (capacity,) int32
    seal: torch.Tensor   # (capacity,) int32 -- commit marker per entry
    count: int           # number of appended entries
    merged: int          # number of entries already merged

    @property
    def capacity(self) -> int:
        return self.keys.shape[0]


def segment_init(capacity: int, *, device=None) -> LogSegment:
    dev = resolve_device(device)
    return LogSegment(
        keys=torch.full((capacity,), EMPTY, dtype=torch.int32, device=dev),
        ptrs=torch.full((capacity,), EMPTY, dtype=torch.int32, device=dev),
        seal=torch.zeros(capacity, dtype=torch.int32, device=dev),
        count=0, merged=0)


@dataclasses.dataclass
class ValueHeap:
    """Append-only value storage; a 'pointer' is a row index."""
    data: torch.Tensor   # (capacity, width) int32
    head: int            # next free row


def heap_init(capacity: int, width: int, *, device=None) -> ValueHeap:
    dev = resolve_device(device)
    return ValueHeap(data=torch.zeros((capacity, width), dtype=torch.int32,
                                      device=dev), head=0)


def heap_append(heap: ValueHeap, values: torch.Tensor):
    """Append a batch of rows in place; returns (heap, ptrs). Out-of-place
    value writes -- updates never overwrite committed data (paper Sec. 4).

    Mirrors the reference exactly, including its overflow: the write
    start is clamped so the batch fits (JAX ``dynamic_update_slice``),
    which overwrites the last committed rows, while the returned pointers
    and the head run on past the end."""
    n = values.shape[0]
    cap = heap.data.shape[0]
    ptrs = torch.arange(heap.head, heap.head + n, dtype=torch.int32,
                        device=heap.data.device)
    start = max(0, min(heap.head, cap - n))
    heap.data[start:start + n] = values.to(torch.int32)
    heap.head += n
    return heap, ptrs


def heap_read(heap: ValueHeap, ptrs: torch.Tensor) -> torch.Tensor:
    """Rows at ``ptrs`` with the reference's indexing: a negative pointer
    counts from the end, and the result is clamped into the heap as the
    JAX gather clamps."""
    cap = heap.data.shape[0]
    idx = ptrs.long()
    return heap.data[torch.where(idx < 0, idx + cap, idx).clamp(0, cap - 1)]


def log_append(seg: LogSegment, keys: torch.Tensor, ptrs: torch.Tensor):
    """Append a batch of entries and seal them, in place, if they fit.
    One one-sided RDMA write in the paper. Returns (seg, ok)."""
    n = keys.shape[0]
    ok = seg.count + n <= seg.capacity
    if ok:
        at = slice(seg.count, seg.count + n)
        seg.keys[at] = keys.to(torch.int32)
        seg.ptrs[at] = ptrs.to(torch.int32)
        seg.seal[at] = SEALED
        seg.count += n
    return seg, ok


def recover_segment(seg: LogSegment) -> LogSegment:
    """Crash recovery, in place: keep the longest sealed prefix, discard
    the rest (a torn entry invalidates itself and everything after it,
    because merge order must match request order)."""
    torn = (seg.seal[:seg.count] != SEALED).nonzero()
    first_bad = int(torn[0, 0]) if torn.numel() else seg.count
    seg.keys[first_bad:] = EMPTY
    seg.ptrs[first_bad:] = EMPTY
    seg.seal[first_bad:] = 0
    seg.count = first_bad
    seg.merged = min(seg.merged, first_bad)
    return seg


def merge_segment(table: CLHT, seg: LogSegment):
    """DPM processors merge the sealed, un-merged entries in order into
    the index (in place). Returns (table, seg, old_ptrs, invalidated):
    ``old_ptrs`` (capacity,) are the value-heap rows superseded by each
    entry (-1 outside the merged window), ``invalidated`` (0-d int32)
    their count."""
    lo, hi = seg.merged, seg.count
    old_ptrs = torch.full((seg.capacity,), EMPTY, dtype=torch.int32,
                          device=seg.keys.device)
    table, old, _, _ = clht_insert(table, seg.keys[lo:hi], seg.ptrs[lo:hi],
                                   seg.seal[lo:hi] == SEALED)
    old_ptrs[lo:hi] = old
    invalidated = (old_ptrs != EMPTY).sum().to(torch.int32)
    seg.merged = seg.count
    return table, seg, old_ptrs, invalidated


# --------------------------------------------------------------------------
# The host segment of the DPM pool (core.dpm_pool).
# --------------------------------------------------------------------------
class PySegment:
    """Per-KN log segment in the simulator: entries + seal + GC counters.

    Entries optionally carry a client *request ID* (``reqs``, -1 when
    absent): the exactly-once retry contract embeds the ID in the
    durable log entry, so 'was this request applied?' is answered by the
    log itself -- a retry deduplicates against sealed entries, and a
    crash-discarded torn entry takes its request ID with it (the retry
    then applies fresh, still exactly once overall).

    Entries also carry the writer's *fence generation* (``gens``): the
    ownership epoch the writing KN held when it appended.  When the
    pool publishes a new generation for a KN (ownership handoff), every
    segment records a watermark in ``gen_marks`` -- ``(entry_index,
    min_gen)`` meaning entries at or after ``entry_index`` must carry a
    generation >= ``min_gen``.  A sealed entry below its watermark is a
    zombie write that slipped past the fence; ``verify_integrity``
    flags it."""

    __slots__ = ("entries", "sealed", "reqs", "gens", "gen_marks",
                 "capacity", "valid", "kn", "merged_upto")

    def __init__(self, capacity: int, kn: str):
        self.entries: list[tuple[int, int]] = []   # (key, ptr)
        self.sealed: list[bool] = []
        self.reqs: list[int] = []                  # request IDs (-1 = none)
        self.gens: list[int] = []                  # writer fence generations
        self.gen_marks: list[tuple[int, int]] = []  # (entry_index, min_gen)
        self.capacity = capacity
        self.valid = 0          # live values still pointed to by the index
        self.kn = kn
        self.merged_upto = 0    # merge cursor (entries before it are in the index)

    def full(self) -> bool:
        return len(self.entries) >= self.capacity

    def append(self, key: int, ptr: int, sealed: bool = True,
               req: int = -1, gen: int = 0) -> None:
        assert not self.full()
        self.entries.append((key, ptr))
        self.sealed.append(sealed)
        self.reqs.append(req)
        self.gens.append(gen)
        self.valid += 1

    def sealed_entries(self) -> list[tuple[int, int]]:
        """Longest sealed prefix (crash-consistent view). Fully sealed
        segments (the overwhelmingly common case) return the entry list
        itself -- callers only slice (copies) or take len()."""
        if False not in self.sealed:
            return self.entries
        out = []
        for (k, p), s in zip(self.entries, self.sealed):
            if not s:
                break
            out.append((k, p))
        return out

    def recover_torn(self) -> list[tuple[int, int, int]]:
        """Crash recovery: truncate to the longest sealed prefix,
        exactly ``recover_segment``'s semantics on the tensor plane (a torn
        entry invalidates itself and everything after it; the merge
        cursor rewinds if it had run past the prefix -- it cannot in
        healthy operation, but recovery trusts nothing). Returns the
        discarded (key, ptr, req) entries so the pool can null their
        heap rows and unregister their request IDs (a discarded entry
        was never applied: its retry must go through)."""
        if False not in self.sealed:
            return []
        cut = self.sealed.index(False)
        dropped = [(k, p, r) for (k, p), r in zip(self.entries[cut:],
                                                  self.reqs[cut:])]
        del self.entries[cut:]
        del self.sealed[cut:]
        del self.reqs[cut:]
        del self.gens[cut:]
        self.valid -= len(dropped)
        if self.merged_upto > cut:
            self.merged_upto = cut
        return dropped
