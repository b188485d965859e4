"""The least bytes that a batch's inputs need to move through device
memory, whatever implements the store, and the card's published peak.

A roofline share is (least bytes / peak rate) over the device time the
call took. The counts follow what the inputs need: each input read once,
each output the user sees written once, each distinct row read once. No
index lines are counted: a store with a perfect index would still move
these bytes, so a correct count never puts a share above 1.
"""

from __future__ import annotations

import torch

# NVIDIA H100 SXM (80 GB HBM3) data sheet: 3.35 TB/s, at its 700 W limit
HBM_BYTES_PER_S = 3.35e12

KEY_BYTES = 4        # int32 keys
FLAG_BYTES = 1       # a bool flag (found, ok)
ENTRY_BYTES = 8      # a (key, pointer) pair of int32


def distinct(keys: torch.Tensor) -> int:
    return int(torch.unique(keys).numel())


def lookup_bytes(keys: torch.Tensor, present: torch.Tensor,
                 row_bytes: int) -> int:
    """A batch of reads: each key read once, each distinct present key's
    value row read once, each read's row and found flag written once."""
    n = keys.numel()
    rows_read = distinct(keys[present.to(torch.bool)])
    return n * KEY_BYTES + rows_read * row_bytes + n * (row_bytes + FLAG_BYTES)


def merge_bytes(keys: torch.Tensor, row_bytes: int) -> int:
    """A batch of writes appended to the heap and the log and merged into
    the index: each key and value row read once, each row written once to
    the heap (writes are out of place), one log entry a write, one index
    entry a distinct key (the last write of a key wins), one ok flag a
    write."""
    n = keys.numel()
    return (n * (KEY_BYTES + 2 * row_bytes + ENTRY_BYTES + FLAG_BYTES)
            + distinct(keys) * ENTRY_BYTES)


def roofline_share(run, kind: str):
    """Percent: the least bytes of the traced calls of one ``kind`` at
    ``HBM_BYTES_PER_S``, over the device time of every operation those
    calls launched; None where the trace holds no such call."""
    if run.trace is None:
        return None
    calls = run.trace.calls_of(kind)
    nbytes = run.traced_bytes.get(kind, [])
    device_s = sum(c.device_s for c in calls)
    if not calls or len(nbytes) != len(calls) or device_s <= 0:
        return None
    return 100.0 * sum(nbytes) / HBM_BYTES_PER_S / device_s
