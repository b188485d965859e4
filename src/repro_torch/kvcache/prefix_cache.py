"""Prefix cache: DINOMO's selective replication applied to shared prompts.

Sealed (full) pages never change, so sequences sharing a token prefix
can share the prefix's pages by refcount: a popular prompt prefix is a
hot key, and sharing its pages across many sequences is ownership
replication with copy-on-write at the first divergent page. Hit counts
feed the same frequency-threshold hotness policy as the paper's M-node.
"""

from __future__ import annotations

from dataclasses import dataclass

from ..core.hashring import stable_hash


@dataclass
class PrefixNode:
    pages: list[int]
    hits: int = 0


class PrefixCache:
    def __init__(self, controller, max_entries: int = 1024):
        self.ctl = controller
        self.max_entries = max_entries
        self.table: dict[int, PrefixNode] = {}

    @staticmethod
    def _key(tokens: tuple) -> int:
        return stable_hash(bytes(b % 256 for b in tokens) +
                           str(len(tokens)).encode())

    def seal_prefix(self, sid: int, tokens: list[int]) -> None:
        """Register the sealed page-aligned prefixes of ``sid``."""
        seq = self.ctl.sequences[sid]
        ps = self.ctl.page_size
        full_pages = seq.length // ps
        for npages in range(1, full_pages + 1):
            key = self._key(tuple(tokens[:npages * ps]))
            if key not in self.table:
                if len(self.table) >= self.max_entries:
                    self._evict()
                self.table[key] = PrefixNode(list(seq.pages[:npages]))

    def lookup(self, tokens: list[int]) -> tuple[list[int], int]:
        """Longest cached page-aligned prefix: (pages, tokens_covered)."""
        ps = self.ctl.page_size
        for npages in range(len(tokens) // ps, 0, -1):
            node = self.table.get(self._key(tuple(tokens[:npages * ps])))
            if node is not None:
                node.hits += 1
                return node.pages, npages * ps
        return [], 0

    def attach(self, sid: int, pages: list[int], covered: int) -> None:
        """Share ``pages`` into sequence ``sid`` (refcount + 1 each)."""
        seq = self.ctl.sequences[sid]
        if seq.length:
            raise ValueError("attach a prefix before any append")
        for pid in pages:
            self.ctl.refcount[pid] += 1
        seq.pages.extend(pages)
        seq.length = covered
        seq.shared_prefix_pages = len(pages)

    def _evict(self) -> None:
        coldest = min(self.table, key=lambda k: self.table[k].hits)
        del self.table[coldest]

    def hot_prefixes(self, min_hits: int = 2) -> list[tuple[int, int]]:
        return sorted(((n.hits, k) for k, n in self.table.items()
                       if n.hits >= min_hits), reverse=True)
