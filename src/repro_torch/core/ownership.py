"""Ownership Partitioning (paper Sec. 3.4) + selective-replication metadata;
the port's copy of the reference's, decision for decision.

Ownership is *logical*: KNs own disjoint key ranges on a consistent-hash
ring while all data/metadata stay shared in the DPM pool. Reconfiguration
re-maps ranges (O(metadata)); hot keys may have their *ownership* (not
data) replicated to multiple KNs, reached through indirect pointers.

The map also identifies the *participants* of a membership change -- the
KNs whose ranges change -- which is step (1) of the paper's seven-step
reconfiguration protocol; non-participants keep serving throughout.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from .hashring import HashRing, stable_hash


@dataclass
class ReconfigEvent:
    """One membership change: who participates, and the ring versions."""
    kind: str                 # "add" | "remove" | "fail"
    node: str
    participants: set[str]
    old_version: int
    new_version: int


class OwnershipMap:
    """Global ring (key -> KN) + per-KN local ring (key -> thread) +
    replication metadata (key -> owner list). RNs/KNs/clients hold
    (possibly stale) snapshots identified by ``version``."""

    def __init__(self, vnodes: int = 64, threads_per_kn: int = 8):
        self.ring = HashRing(vnodes=vnodes)
        self.threads_per_kn = threads_per_kn
        self.replicated: dict[int, list[str]] = {}
        self.version = 0
        # fence generation per KN: the map version at which that KN's
        # ownership interval last changed.  A KN's writes are only valid
        # while it holds the current generation; after a handoff the old
        # owner's token is stale and the DPM fence rejects it (Sec. 3.5
        # made safe under imperfect failure detection).
        self.fence: dict[str, int] = {}
        self._rep_cache: tuple[int, np.ndarray] | None = None

    # ----- lookup --------------------------------------------------------
    def primary(self, key: int) -> str:
        return self.ring.owner(key)

    def primary_ids(self, keys: np.ndarray):
        """Vectorized ``primary``: (ids, names) from the global ring."""
        return self.ring.owner_ids(keys)

    def replicated_keys_array(self) -> np.ndarray:
        """Sorted int64 array of replicated keys (cached per version)."""
        if self._rep_cache is None or self._rep_cache[0] != self.version:
            arr = np.sort(np.fromiter(self.replicated.keys(),
                                      dtype=np.int64,
                                      count=len(self.replicated)))
            self._rep_cache = (self.version, arr)
        return self._rep_cache[1]

    def owners(self, key: int) -> list[str]:
        """All owners: primary plus secondaries if replicated."""
        reps = self.replicated.get(key)
        if reps:
            return list(reps)
        return [self.ring.owner(key)]

    def thread_of(self, key: int) -> int:
        """Local ring: partition a KN's range among its threads."""
        return stable_hash(("thread", key)) % self.threads_per_kn

    def is_replicated(self, key: int) -> bool:
        return key in self.replicated

    @property
    def kns(self) -> list[str]:
        return self.ring.members

    # ----- membership changes (steps 1 of the reconfig protocol) ----------
    def add_kn(self, name: str) -> ReconfigEvent:
        old = self.ring.snapshot()
        self.ring.add(name)
        participants = {name} | self._changed_owners(old)
        self.version += 1
        self._bump_fences(participants)
        self._repair_replicas()
        return ReconfigEvent("add", name, participants,
                             self.version - 1, self.version)

    def remove_kn(self, name: str, failed: bool = False) -> ReconfigEvent:
        old = self.ring.snapshot()
        self.ring.remove(name)
        participants = ({name} if not failed else set()) \
            | self._changed_owners(old)
        self.version += 1
        self.fence.pop(name, None)
        self._bump_fences(participants)
        self._repair_replicas(gone=name)
        return ReconfigEvent("fail" if failed else "remove", name,
                             participants, self.version - 1, self.version)

    def _bump_fences(self, participants: set[str]) -> None:
        """Stamp every participant of a membership change with a fresh
        fence generation (the new map version).  Monotone per KN: the
        version only grows, so an old owner's token can never become
        valid again."""
        for p in participants:
            if p in self.ring:
                self.fence[p] = self.version

    def fence_token(self, kn: str) -> int | None:
        """The current fence generation for ``kn`` (None if not a
        member).  KNs capture this at reconfiguration time and present
        it with every DPM write."""
        return self.fence.get(kn)

    def _changed_owners(self, old: HashRing) -> set[str]:
        """KNs (in the *new* ring) whose owned ranges changed.

        Exact ring-interval diff: the union of both rings' vnode points
        cuts the hash circle into arcs on which each ring's owner is
        constant, so comparing the two owners once per arc finds every
        moved range -- including arcs far smaller than any fixed key
        sample could hit (the old ``np.arange(2048)`` sample missed
        whole participants at low vnode counts, silently skipping their
        reconfiguration handoff)."""
        new = self.ring
        if not old._points or not new._points:
            return set(new.members)
        pa = np.asarray(old._points, dtype=np.uint64)
        pb = np.asarray(new._points, dtype=np.uint64)
        merged = np.union1d(pa, pb)
        # owner(pos) == owners[bisect_right(points, pos) mod n], so each
        # merged point starts an arc [q, next_q) with constant owners in
        # both rings; q itself is the arc's representative position.
        ia = np.searchsorted(pa, merged, side="right")
        ia[ia == pa.shape[0]] = 0
        ib = np.searchsorted(pb, merged, side="right")
        ib[ib == pb.shape[0]] = 0
        a_arr = np.asarray(old._owners, dtype=object)[ia]
        b_arr = np.asarray(new._owners, dtype=object)[ib]
        moved = a_arr != b_arr
        changed: set[str] = set(b_arr[moved])
        for a in set(a_arr[moved]):
            if a in new:
                changed.add(a)
        return changed

    def _repair_replicas(self, gone: str | None = None) -> None:
        for key, owners in list(self.replicated.items()):
            owners = [o for o in owners if o in self.ring and o != gone]
            prim = self.ring.owner(key)
            if prim not in owners:
                owners.insert(0, prim)
            if len(owners) <= 1:
                del self.replicated[key]
            else:
                self.replicated[key] = owners

    # ----- selective replication metadata ---------------------------------
    def replicate(self, key: int, factor: int) -> list[str]:
        """Share ownership of ``key`` across ``factor`` KNs (primary +
        secondaries, chosen as ring successors). Returns the owner list."""
        factor = max(1, min(factor, len(self.ring)))
        owners = self.ring.owners(key, factor)
        if factor <= 1:
            self.replicated.pop(key, None)
        else:
            self.replicated[key] = owners
        self.version += 1
        return owners

    def dereplicate(self, key: int) -> None:
        if key in self.replicated:
            del self.replicated[key]
            self.version += 1

    def replication_factor(self, key: int) -> int:
        return len(self.replicated.get(key, ())) or 1

    # ----- durable snapshot (stored in the DPM pool, Sec. 3.5) ------------
    def snapshot_blob(self) -> dict:
        return {
            "members": self.ring.members,
            "vnodes": self.ring.vnodes,
            "replicated": {k: list(v) for k, v in self.replicated.items()},
            "version": self.version,
            "fence": dict(self.fence),
        }

    @classmethod
    def from_blob(cls, blob: dict, threads_per_kn: int = 8) -> "OwnershipMap":
        m = cls(vnodes=blob["vnodes"], threads_per_kn=threads_per_kn)
        for member in blob["members"]:
            m.ring.add(member)
        m.replicated = {int(k): list(v)
                        for k, v in blob["replicated"].items()}
        m.version = blob["version"]
        m.fence = {str(k): int(v)
                   for k, v in blob.get("fence", {}).items()}
        return m
