"""Consistent hashing (the port's copy of what it needs from the
reference's ring module): the splitmix64 mixers used by the YCSB key
scramble, ``stable_hash``, and the virtual-node ``HashRing`` that maps
KV pages to serving workers and keys to KNs, with its vectorized
owner lookup (the batched data plane's routing path) and the sampled
share and diff of a ring. Owners are bit-identical to the reference's."""

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
        self.generation = 0              # bumped on every membership change
        self._np_cache = None            # (points, owner_ids, names)
        self._share_cache: dict[int, np.ndarray] = {}  # samples -> ids
        for m in members:
            self.add(m)

    def _invalidate(self) -> None:
        self.generation += 1
        self._np_cache = None
        self._share_cache.clear()

    def add(self, member: str) -> None:
        if member in self._members:
            return
        self._members.add(member)
        for v in range(self.vnodes):
            pos = stable_hash(f"{member}#{v}")
            i = bisect.bisect_left(self._points, pos)
            self._points.insert(i, pos)
            self._owners.insert(i, member)
        self._invalidate()

    def remove(self, member: str) -> None:
        if member not in self._members:
            return
        self._members.discard(member)
        keep = [(p, o) for p, o in zip(self._points, self._owners)
                if o != member]
        self._points = [p for p, _ in keep]
        self._owners = [o for _, o in keep]
        self._invalidate()

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

    def owners(self, key: Hashable, n: int) -> list[str]:
        """The n distinct successors of the key's position: the primary
        owner followed by candidate secondary owners (for selective
        replication)."""
        if not self._points:
            raise RuntimeError("empty hash ring")
        i = bisect.bisect_right(self._points, stable_hash(key))
        out: list[str] = []
        seen: set[str] = set()
        for step in range(len(self._points)):
            o = self._owners[(i + step) % len(self._points)]
            if o not in seen:
                seen.add(o)
                out.append(o)
                if len(out) == n:
                    break
        return out

    def _np_view(self):
        """(sorted vnode positions, owner id per position, names) --
        cached numpy mirror of the ring, rebuilt on membership change."""
        if self._np_cache is None:
            names = sorted(self._members)
            idx = {n: i for i, n in enumerate(names)}
            points = np.asarray(self._points, dtype=np.uint64)
            owner_ids = np.asarray([idx[o] for o in self._owners],
                                   dtype=np.int64)
            self._np_cache = (points, owner_ids, names)
        return self._np_cache

    def owner_ids(self, keys: np.ndarray):
        """Vectorized ``owner`` for int keys: returns (ids, names) where
        ``names[ids[i]]`` == ``self.owner(int(keys[i]))`` exactly."""
        points, owner_ids, names = self._np_view()
        if not len(points):
            raise RuntimeError("empty hash ring")
        pos = mix64_batch(np.asarray(keys))
        i = np.searchsorted(points, pos, side="right")
        i[i == len(points)] = 0
        return owner_ids[i], names

    def _sample_ids(self, samples: int) -> np.ndarray:
        ids = self._share_cache.get(samples)
        if ids is None:
            ids, _ = self.owner_ids(np.arange(samples, dtype=np.uint64))
            self._share_cache[samples] = ids
        return ids

    def share(self, member: str, samples: int = 4096) -> float:
        """Approximate fraction of the keyspace owned by ``member``."""
        if not self._points or member not in self._members:
            return 0.0
        _, _, names = self._np_view()
        ids = self._sample_ids(samples)
        return int((ids == names.index(member)).sum()) / samples

    def diff(self, other: "HashRing", samples: int = 4096) -> float:
        """Fraction of sampled keys whose owner differs between two rings
        (the reconfiguration's blast radius)."""
        if not self._points or not other._points:
            return 1.0
        a_ids = self._sample_ids(samples)
        b_ids = other._sample_ids(samples)
        _, _, a_names = self._np_view()
        _, _, b_names = other._np_view()
        a = np.asarray(a_names, dtype=object)[a_ids]
        b = np.asarray(b_names, dtype=object)[b_ids]
        return int((a != b).sum()) / samples

    def snapshot(self) -> "HashRing":
        r = HashRing(vnodes=self.vnodes)
        r._points = list(self._points)
        r._owners = list(self._owners)
        r._members = set(self._members)
        return r
