"""Consistent hashing (the port's copy of what it needs from the
reference's ring module): the splitmix64 mixers used by the YCSB key
scramble, ``stable_hash``, and the virtual-node ``HashRing`` that maps
KV pages to serving workers. Owners are bit-identical to the
reference's."""

from __future__ import annotations

import bisect
from typing import Hashable, Iterable

import numpy as np

_MASK64 = (1 << 64) - 1


def mix64(x: int) -> int:
    """splitmix64 finalizer: deterministic 64-bit hash of an int."""
    x = (x + 0x9E3779B97F4A7C15) & _MASK64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _MASK64
    return (x ^ (x >> 31)) & _MASK64


def mix64_batch(x: np.ndarray) -> np.ndarray:
    """Vectorized splitmix64: bit-identical to ``mix64`` per element."""
    x = x.astype(np.uint64, copy=True)
    x += np.uint64(0x9E3779B97F4A7C15)
    x = (x ^ (x >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
    x = (x ^ (x >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
    return x ^ (x >> np.uint64(31))


def stable_hash(key: Hashable) -> int:
    """Process-independent 64-bit hash: ints through splitmix64, bytes
    through FNV-1a then splitmix64, anything else through its repr."""
    if isinstance(key, int):
        return mix64(key)
    if isinstance(key, bytes):
        h = 0xCBF29CE484222325
        for b in key:
            h = ((h ^ b) * 0x100000001B3) & _MASK64
        return mix64(h)
    if isinstance(key, str):
        return stable_hash(key.encode())
    return stable_hash(repr(key).encode())


class HashRing:
    """Consistent-hash ring with virtual nodes. Adding or removing a
    member remaps only the key ranges next to its virtual nodes: only
    ownership moves, never data."""

    def __init__(self, members: Iterable[str] = (), vnodes: int = 64):
        self.vnodes = vnodes
        self._points: list[int] = []     # sorted vnode positions
        self._owners: list[str] = []     # owner of each vnode position
        self._members: set[str] = set()
        for m in members:
            self.add(m)

    def add(self, member: str) -> None:
        if member in self._members:
            return
        self._members.add(member)
        for v in range(self.vnodes):
            pos = stable_hash(f"{member}#{v}")
            i = bisect.bisect_left(self._points, pos)
            self._points.insert(i, pos)
            self._owners.insert(i, member)

    def remove(self, member: str) -> None:
        if member not in self._members:
            return
        self._members.discard(member)
        keep = [(p, o) for p, o in zip(self._points, self._owners)
                if o != member]
        self._points = [p for p, _ in keep]
        self._owners = [o for _, o in keep]

    @property
    def members(self) -> list[str]:
        return sorted(self._members)

    def __len__(self) -> int:
        return len(self._members)

    def __contains__(self, member: str) -> bool:
        return member in self._members

    def owner(self, key: Hashable) -> str:
        if not self._points:
            raise RuntimeError("empty hash ring")
        i = bisect.bisect_right(self._points, stable_hash(key))
        return self._owners[i if i < len(self._points) else 0]
