"""Disaggregated Adaptive Caching (paper Sec. 3.3, Table 3, Eq. 1): the
port's copy of the reference's per-op ``DAC``, decision for decision.
The paged KV controller runs one per serving worker over page ids.

Each KN's DRAM caches two kinds of entries:
  * value    -- full copy of the DPM value: hit costs 0 RTs
  * shortcut -- 64-bit pointer + length:    hit costs 1 RT

  BEGIN    start with an empty cache; cache values while space is spare
  MISS     cache the shortcut; make space by demoting an LRU value,
           else evicting LFU shortcuts
  HIT      on a shortcut hit, PROMOTE to value iff Eq. 1 holds:
             Hits(P) * avg_shortcut_hit_RTs >= sum_i Hits(S_i) * avg_miss_RTs
           where S_1..S_N are the LFU shortcuts that must be evicted
  EVICT    always the least-frequently-used shortcut
  DEMOTE   LRU value -> shortcut, on misses needing space

Promoted shortcuts inherit their access counts; demoted values are kept
as shortcuts. The array-backed ``ArrayDAC`` of the batched data plane
comes with the cache_transition slice.
"""

from __future__ import annotations

import heapq
from collections import OrderedDict
from dataclasses import dataclass

# Entry overheads (bytes): key + pointer + length (+ access count for values)
SHORTCUT_BYTES = 32
VALUE_OVERHEAD_BYTES = 40


@dataclass
class CacheStats:
    value_hits: int = 0
    shortcut_hits: int = 0
    misses: int = 0
    promotions: int = 0
    demotions: int = 0
    evictions: int = 0

    @property
    def lookups(self) -> int:
        return self.value_hits + self.shortcut_hits + self.misses

    @property
    def hit_ratio(self) -> float:
        n = self.lookups
        return (self.value_hits + self.shortcut_hits) / n if n else 0.0

    @property
    def value_hit_ratio(self) -> float:
        n = self.lookups
        return self.value_hits / n if n else 0.0


@dataclass
class _Entry:
    ptr: int
    length: int
    count: int = 0


class DAC:
    """One KN's adaptive cache."""

    def __init__(self, capacity_bytes: int, avg_miss_rts_init: float = 2.0,
                 ema: float = 0.05):
        self.capacity = capacity_bytes
        self.used = 0
        self.values: OrderedDict[int, _Entry] = OrderedDict()   # LRU order
        self.shortcuts: dict[int, _Entry] = {}
        self._lfu: list[tuple[int, int]] = []    # lazy heap (count, key)
        self.avg_miss_rts = avg_miss_rts_init
        self.avg_shortcut_hit_rts = 1.0
        self._ema = ema
        self.stats = CacheStats()

    @staticmethod
    def value_bytes(length: int) -> int:
        return VALUE_OVERHEAD_BYTES + length

    # ----- public API --------------------------------------------------
    def lookup(self, key: int):
        """-> ('value', ptr, length) | ('shortcut', ptr, length) | None.
        Updates recency/frequency; promotion decisions happen here."""
        ent = self.values.get(key)
        if ent is not None:
            ent.count += 1
            self.values.move_to_end(key)
            self.stats.value_hits += 1
            return ("value", ent.ptr, ent.length)
        ent = self.shortcuts.get(key)
        if ent is not None:
            ent.count += 1
            self.stats.shortcut_hits += 1
            if self._should_promote(key, ent):
                self._promote(key, ent)
                self.stats.promotions += 1
            return ("shortcut", ent.ptr, ent.length)
        self.stats.misses += 1
        return None

    def note_miss_rts(self, rts: float) -> None:
        self.avg_miss_rts += self._ema * (rts - self.avg_miss_rts)

    def fill_after_miss(self, key: int, ptr: int, length: int) -> None:
        """Install an entry after a miss (Table 3 MISS row + BEGIN rule:
        cache the value while the cache has spare space)."""
        if self.used + self.value_bytes(length) <= self.capacity:
            self._insert_value(key, ptr, length, count=1)
        else:
            self._insert_shortcut(key, ptr, length, count=1)

    def fill_after_write(self, key: int, ptr: int, length: int,
                         segment_cached: bool) -> None:
        """After a write the KN knows the new DPM address; if the log
        segment is still cached locally the value is readable locally,
        i.e. a value entry."""
        prior = self._remove(key)
        cnt = prior.count if prior else 0
        if segment_cached and \
                self.used + self.value_bytes(length) <= self.capacity:
            self._insert_value(key, ptr, length, count=cnt)
        else:
            self._insert_shortcut(key, ptr, length, count=cnt)

    def invalidate(self, key: int) -> None:
        self._remove(key)

    def demote_to_shortcut(self, key: int) -> None:
        """Force value->shortcut (a replicated key: indirect pointers
        forbid value caching, paper Sec. 5.3)."""
        ent = self.values.get(key)
        if ent is not None:
            del self.values[key]
            self.used -= self.value_bytes(ent.length)
            self._insert_shortcut(key, ent.ptr, ent.length, count=ent.count)

    def update_pointer(self, key: int, ptr: int, length: int) -> None:
        ent = self.values.get(key) or self.shortcuts.get(key)
        if ent is not None:
            delta = length - ent.length
            if key in self.values:
                if self.used + delta > self.capacity:
                    self.demote_to_shortcut(key)
                    self.update_pointer(key, ptr, length)
                    return
                self.used += delta
            ent.ptr, ent.length = ptr, length

    def clear(self) -> None:
        """Ownership handoff empties the cache (paper Sec. 3.4)."""
        self.values.clear()
        self.shortcuts.clear()
        self._lfu.clear()
        self.used = 0

    def __contains__(self, key: int) -> bool:
        return key in self.values or key in self.shortcuts

    @property
    def num_values(self) -> int:
        return len(self.values)

    @property
    def num_shortcuts(self) -> int:
        return len(self.shortcuts)

    # ----- internals ---------------------------------------------------
    def _remove(self, key: int) -> _Entry | None:
        ent = self.values.pop(key, None)
        if ent is not None:
            self.used -= self.value_bytes(ent.length)
            return ent
        ent = self.shortcuts.pop(key, None)
        if ent is not None:
            self.used -= SHORTCUT_BYTES
            return ent
        return None

    def _insert_value(self, key: int, ptr: int, length: int,
                      count: int) -> None:
        self._remove(key)
        need = self.value_bytes(length)
        self._make_space(need)
        if self.used + need > self.capacity:
            # cannot fit even after demotions/evictions: fall back
            self._insert_shortcut(key, ptr, length, count)
            return
        self.values[key] = _Entry(ptr, length, count)
        self.used += need

    def _insert_shortcut(self, key: int, ptr: int, length: int,
                         count: int) -> None:
        self._remove(key)
        self._make_space(SHORTCUT_BYTES)
        if self.used + SHORTCUT_BYTES > self.capacity:
            return  # cache smaller than one entry: degenerate, skip
        self.shortcuts[key] = _Entry(ptr, length, count)
        heapq.heappush(self._lfu, (count, key))
        self.used += SHORTCUT_BYTES

    def _make_space(self, need: int) -> None:
        """Demote LRU values first, then evict LFU shortcuts (Table 3)."""
        while self.used + need > self.capacity and self.values:
            k, ent = self.values.popitem(last=False)      # LRU value
            self.used -= self.value_bytes(ent.length)
            self.stats.demotions += 1
            if self.used + SHORTCUT_BYTES + need <= self.capacity:
                self.shortcuts[k] = ent
                heapq.heappush(self._lfu, (ent.count, k))
                self.used += SHORTCUT_BYTES
        while self.used + need > self.capacity and self.shortcuts:
            k = self._pop_lfu()
            if k is None:
                break
            self.shortcuts.pop(k)
            self.used -= SHORTCUT_BYTES
            self.stats.evictions += 1

    def _pop_lfu(self) -> int | None:
        """Pop the least-frequently-used *live* shortcut key."""
        while self._lfu:
            cnt, k = heapq.heappop(self._lfu)
            ent = self.shortcuts.get(k)
            if ent is None:
                continue                      # stale heap record
            if ent.count != cnt:
                heapq.heappush(self._lfu, (ent.count, k))   # refresh
                continue
            return k
        return None

    def _peek_lfu(self, n: int, exclude: int):
        """The up-to-n least-frequently-used live shortcuts (heap peek:
        pop/validate/push-back, O(n log H) -- never a full sort)."""
        popped = []
        out = []
        seen = set()
        while self._lfu and len(out) < n:
            cnt, k = heapq.heappop(self._lfu)
            ent = self.shortcuts.get(k)
            if ent is None:
                continue                     # stale heap record: drop
            if ent.count != cnt:
                heapq.heappush(self._lfu, (ent.count, k))  # refresh
                continue
            popped.append((cnt, k))
            # a re-inserted key can leave two identical live records;
            # count each victim once or Eq. 1 double-bills its evictions
            if k != exclude and k not in seen:
                seen.add(k)
                out.append((cnt, k))
        for item in popped:
            heapq.heappush(self._lfu, item)
        return out

    def _should_promote(self, key: int, ent: _Entry) -> bool:
        """Eq. 1: promote if RTs saved >= RTs newly incurred by evicting
        the N least-frequently-used shortcuts needed for space."""
        need = self.value_bytes(ent.length) - SHORTCUT_BYTES
        free = self.capacity - self.used
        if free >= need:
            return True
        deficit = need - free
        n_evict = -(-deficit // SHORTCUT_BYTES)     # ceil
        victims = self._peek_lfu(n_evict, exclude=key)
        if len(victims) < n_evict:
            return False                     # not enough shortcuts to evict
        evict_cost = sum(cnt for cnt, _ in victims) * self.avg_miss_rts
        saving = ent.count * self.avg_shortcut_hit_rts
        return saving >= evict_cost

    def _promote(self, key: int, ent: _Entry) -> None:
        del self.shortcuts[key]
        self.used -= SHORTCUT_BYTES
        # inherits access count (paper Sec. 4)
        self._insert_value(key, ent.ptr, ent.length, count=ent.count)
