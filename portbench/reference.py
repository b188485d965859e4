"""The plain reference of the key-value store, and the value rule.

A value row is a fixed integer hash of (seed, slot, lane): the benchmark
makes its inputs with ``value_rows`` and the reference works every
expected row out again with it, so no stored copy of 32 GB is needed.
The reference is a last-write-wins map over the dense keyspace ``[0, n)``
(YCSB's keys are the numbers of the records): for each key, the slot of
its last acknowledged write, or -1. It uses plain torch only and nothing
of the program.
"""

from __future__ import annotations

import torch

_M32 = 0xFFFFFFFF


def _mix32(x: torch.Tensor) -> torch.Tensor:
    """A 32-bit finalizer over int64 (every product masked to 32 bits)."""
    x = x & _M32
    x = ((x ^ (x >> 16)) * 0x7FEB352D) & _M32
    x = ((x ^ (x >> 15)) * 0x846CA68B) & _M32
    return x ^ (x >> 16)


def value_rows(seed: int, slots: torch.Tensor, lanes: int,
               block: int = 1 << 16) -> torch.Tensor:
    """(len(slots), lanes) int32 rows, non-negative, one per value slot
    (worked out ``block`` rows at a time, to bound the temporaries)."""
    s = torch.tensor(int(seed) % (1 << 62))
    salt = (int(_mix32(s ^ _mix32(s >> 32))) * 0x9E3779B1) & _M32
    lane = torch.arange(lanes, dtype=torch.int64, device=slots.device)
    out = torch.empty((slots.numel(), lanes), dtype=torch.int32,
                      device=slots.device)
    for lo in range(0, slots.numel(), block):
        base = slots[lo:lo + block].to(torch.int64)[:, None] * lanes
        h = _mix32(base + lane[None] + salt)
        out[lo:lo + block] = h & 0x7FFFFFFF
    return out


class KVReference:
    """Last-write-wins map of the dense keyspace ``[0, n)`` to value
    slots."""

    def __init__(self, n: int, device):
        self.slot = torch.full((n,), -1, dtype=torch.int64, device=device)

    def write(self, keys: torch.Tensor, slots: torch.Tensor) -> None:
        """Acknowledged writes of distinct keys, in one batch."""
        self.slot[keys.long()] = slots.to(torch.int64)

    def mismatches(self, seed: int, lanes: int, keys: torch.Tensor,
                   found: torch.Tensor, rows: torch.Tensor | None,
                   block: int = 1 << 16) -> int:
        """How many of these reads disagree with the map: a key present
        must be found with its row bit for bit, an absent key must not be
        found. ``rows`` None checks presence alone."""
        want = self.slot[keys.long()]
        bad = found.to(torch.bool) != (want >= 0)
        if rows is not None:
            for lo in range(0, keys.numel(), block):
                w = want[lo:lo + block]
                exp = value_rows(seed, w.clamp(min=0), lanes)
                diff = (rows[lo:lo + block] != exp).any(dim=1) & (w >= 0)
                bad[lo:lo + block] |= diff
        return int(bad.sum())
