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
as shortcuts.

``ArrayDAC`` is the same policy over dense per-key numpy vectors: the
KN's cache of the batched data plane, which ``core.transition`` plans a
window at a time. Like the reference it lives on the host (in DINOMO the
KN's cache is its DRAM); the device work of that path is the
cache_transition kernel, the planner's twin. While ``core.jit_engine``
keeps a copy of it on the device, its ``_dirty`` ``SlotRecord`` notes
every slot host code writes, so the next upload moves only those.

``StaticCache`` and ``ArrayStaticCache`` are the Fig. 3 static-split
baselines (shortcut-only, value-only, ``static:<f>``; ``dinomo-s`` runs
the first), the per-op oracle and the array-backed cache the batched
plane plans (``core.transition.plan_static_window``). A static cache
never enters the compiled engine, so it records no slots.
"""

from __future__ import annotations

import heapq
from collections import OrderedDict
from dataclasses import dataclass

import numpy as np

# Entry overheads (bytes): key + pointer + length (+ access count for values)
SHORTCUT_BYTES = 32
VALUE_OVERHEAD_BYTES = 40
# ArrayDAC keeps a histogram of live-shortcut access counts in
# [0, CNT_HIST_MAX); the Eq. 1 victim sum (sum of the n cheapest
# shortcut counts) then reads off the histogram in O(1) instead of an
# O(n log H) LFU-heap peek per shortcut hit. Counts at or above the
# bound fall back to the exact peek (rare: such victims are hot).
CNT_HIST_MAX = 64


class SlotRecord:
    """The slots host code wrote into an ``ArrayDAC`` since the jit
    engine's last upload of it (single keys and key arrays; repeats are
    allowed). ``take`` returns them sorted and unique and starts anew."""

    __slots__ = ("keys", "arrays")

    def __init__(self):
        self.keys: list = []
        self.arrays: list = []

    def add(self, key) -> None:
        self.keys.append(key)

    def extend(self, keys) -> None:
        self.arrays.append(np.asarray(keys, np.int64))

    def take(self) -> np.ndarray:
        parts = self.arrays
        if self.keys:
            parts = parts + [np.asarray(self.keys, np.int64)]
        self.keys, self.arrays = [], []
        if not parts:
            return np.empty(0, np.int64)
        return np.unique(np.concatenate(parts))

    def __deepcopy__(self, memo):
        # a copied cache has no device copy: it records nothing
        return None


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


class ArrayDAC:
    """Array-backed DAC: the batched data plane's cache.

    Same policy as ``DAC``, decision-for-decision (property-tested): the
    difference is representation. Entries live in dense numpy vectors
    indexed *by key* -- kind (0 absent / 1 shortcut / 2 value), pointer,
    length, frequency (``count``) and recency (``stamp``, a monotonic
    clock equal to OrderedDict move-to-end order) -- so a whole batch of
    operations can be classified with one gather and a run of value hits
    applied with one scatter-add (see ``classify_batch`` /
    ``bulk_value_hits``). LRU/LFU victim selection uses the same lazy
    heaps as the scalar DAC: argmin (stamp, key) over values == LRU
    order, argmin (count, key) over shortcuts == LFU order.

    The scalar per-op interface is kept in full so this class is a
    drop-in replacement anywhere a ``DAC`` is used.
    """

    KIND_NONE, KIND_SHORTCUT, KIND_VALUE = 0, 1, 2

    def __init__(self, capacity_bytes: int, avg_miss_rts_init: float = 2.0,
                 ema: float = 0.05, initial_keys: int = 1024):
        self.capacity = capacity_bytes
        self.used = 0
        self.avg_miss_rts = avg_miss_rts_init
        self.avg_shortcut_hit_rts = 1.0
        self._ema = ema
        self.stats = CacheStats()
        n = max(initial_keys, 8)
        # Every per-key vector is numpy: the planned-transition engine
        # (core.transition) gathers and scatters whole windows of
        # kind/ptr/len/count/stamp in single fancy-index operations
        # (~20x cheaper per element than list indexing), which is where
        # the batched plane now spends its per-key traffic.  The per-op
        # replay paths pay ~2x per scalar access versus the old list
        # layout, but they only run for windows the planner cannot
        # prove (small or degenerate ones).
        self.kind = np.zeros(n, np.int8)
        self.ptr = np.full(n, -1, np.int64)
        self.length = np.zeros(n, np.int64)
        self.count = np.zeros(n, np.int64)
        self.stamp = np.zeros(n, np.int64)
        self._clock = 1
        self._lru: list[tuple[int, int]] = []   # lazy heap (stamp, key)
        self._lfu: list[tuple[int, int]] = []   # lazy heap (count, key)
        self._nvals = 0
        self._nshort = 0
        self._zero_shortcuts = 0   # live shortcuts with count == 0
        # live-shortcut access-count histogram (see CNT_HIST_MAX)
        self._cnt_hist = [0] * (CNT_HIST_MAX + 1)
        # the slots written since the jit engine's last upload, while it
        # keeps a device copy of this cache (else None: nothing recorded)
        self._dirty: SlotRecord | None = None

    # ----- sizes -----------------------------------------------------------
    value_bytes = staticmethod(DAC.value_bytes)

    def _ensure(self, key: int) -> None:
        n = self.kind.shape[0]
        if key < n:
            return
        m = max(2 * n, key + 1)
        self._dirty = None          # the device copy's size is gone
        self.kind = np.concatenate(
            [self.kind, np.zeros(m - n, np.int8)])
        self.ptr = np.concatenate([self.ptr, np.full(m - n, -1, np.int64)])
        self.length = np.concatenate([self.length,
                                      np.zeros(m - n, np.int64)])
        self.count = np.concatenate([self.count,
                                     np.zeros(m - n, np.int64)])
        self.stamp = np.concatenate([self.stamp,
                                     np.zeros(m - n, np.int64)])

    # ----- public per-op API (mirrors DAC) ---------------------------------
    def lookup(self, key: int):
        self._ensure(key)
        kd = self.kind[key]
        if kd and self._dirty is not None:
            self._dirty.add(key)
        if kd == self.KIND_VALUE:
            c = self.count[key] + 1
            self.count[key] = c
            self.stamp[key] = self._clock
            self._clock += 1
            self.stats.value_hits += 1
            return ("value", self.ptr[key], self.length[key])
        if kd == self.KIND_SHORTCUT:
            c = self.count[key] + 1
            self.count[key] = c
            if c == 1:
                self._zero_shortcuts -= 1
            hist = self._cnt_hist
            hist[c - 1 if c <= CNT_HIST_MAX else CNT_HIST_MAX] -= 1
            hist[c if c < CNT_HIST_MAX else CNT_HIST_MAX] += 1
            self.stats.shortcut_hits += 1
            p, ln = self.ptr[key], self.length[key]
            if self._should_promote(key, c, ln):
                self._promote(key)
                self.stats.promotions += 1
            return ("shortcut", p, ln)
        self.stats.misses += 1
        return None

    def note_miss_rts(self, rts: float) -> None:
        self.avg_miss_rts += self._ema * (rts - self.avg_miss_rts)

    def fill_after_miss(self, key: int, ptr: int, length: int) -> None:
        self._ensure(key)
        if self.used + self.value_bytes(length) <= self.capacity:
            self._insert_value(key, ptr, length, count=1)
        else:
            self._insert_shortcut(key, ptr, length, count=1)

    def fill_after_write(self, key: int, ptr: int, length: int,
                         segment_cached: bool) -> None:
        self._ensure(key)
        prior = self._remove(key)
        cnt = prior[2] if prior else 0
        if segment_cached and \
                self.used + self.value_bytes(length) <= self.capacity:
            self._insert_value(key, ptr, length, count=cnt)
        else:
            self._insert_shortcut(key, ptr, length, count=cnt)

    def invalidate(self, key: int) -> None:
        self._ensure(key)
        self._remove(key)

    def demote_to_shortcut(self, key: int) -> None:
        self._ensure(key)
        if self.kind[key] == self.KIND_VALUE:
            if self._dirty is not None:
                self._dirty.add(key)
            p, ln, cnt = self.ptr[key], self.length[key], self.count[key]
            self.kind[key] = self.KIND_NONE
            self.used -= self.value_bytes(ln)
            self._nvals -= 1
            self._insert_shortcut(key, p, ln, count=cnt)

    def update_pointer(self, key: int, ptr: int, length: int) -> None:
        self._ensure(key)
        kd = self.kind[key]
        if kd == self.KIND_NONE:
            return
        delta = length - self.length[key]
        if kd == self.KIND_VALUE:
            if self.used + delta > self.capacity:
                self.demote_to_shortcut(key)
                self.update_pointer(key, ptr, length)
                return
            self.used += delta
        if self._dirty is not None:
            self._dirty.add(key)
        self.ptr[key] = ptr
        self.length[key] = length

    def clear(self) -> None:
        self._dirty = None          # every slot changes: upload anew
        self.kind[:] = 0
        self.count[:] = 0
        self.stamp[:] = 0
        self._lru.clear()
        self._lfu.clear()
        self.used = 0
        self._nvals = 0
        self._nshort = 0
        self._zero_shortcuts = 0
        self._cnt_hist = [0] * (CNT_HIST_MAX + 1)

    def __contains__(self, key: int) -> bool:
        return key < self.kind.shape[0] and self.kind[key] != 0

    @property
    def num_values(self) -> int:
        return self._nvals

    @property
    def num_shortcuts(self) -> int:
        return self._nshort

    def bulk_value_hits(self, keys: np.ndarray) -> None:
        """Apply a run of value hits whose every key is (still) a value
        entry: frequency += multiplicity, recency = clock at the key's
        last position in the run -- exactly what per-op lookups do."""
        n = keys.shape[0]
        c0 = self._clock
        if self._dirty is not None:
            self._dirty.extend(keys)
        if n > 24:
            u, ridx, mult = np.unique(keys[::-1], return_index=True,
                                      return_counts=True)
            self.count[u] += mult                 # u is unique: safe +=
            self.stamp[u] = c0 + (n - 1 - ridx)
        else:
            cnt, stp = self.count, self.stamp
            for i, k in enumerate(keys.tolist()):
                cnt[k] += 1
                stp[k] = c0 + i
        self._clock += n
        self.stats.value_hits += n

    def apply_plan(self, plan) -> None:
        """Apply one planned window's cache transitions in bulk (see
        core.transition.plan_dac_window).  The plan's scatters are
        already deduplicated (last op per key wins), victim keys are
        disjoint from the window's op keys, and LRU records arrive
        clock-ascending so they extend the lazy heap in place."""
        kind = self.kind
        rec = self._dirty
        if rec is not None:
            rec.extend(plan.victims)
            rec.extend(plan.kk_keys)
            rec.extend(plan.fill_keys)
            rec.extend(plan.stp_keys)
        if plan.victims:
            vk = np.asarray(plan.victims, np.int64)
            ri = np.asarray(plan.victim_reinsert, bool)
            kind[vk] = np.where(ri, np.int8(self.KIND_SHORTCUT),
                                np.int8(self.KIND_NONE))
        kind[plan.kk_keys] = plan.kk_kind
        self.count[plan.kk_keys] = plan.kk_cnt
        if plan.fill_keys.size:
            self.ptr[plan.fill_keys] = plan.fill_ptr
            self.length[plan.fill_keys] = plan.fill_len
        if plan.stp_keys.size:
            self.stamp[plan.stp_keys] = plan.stp_vals
        self._clock += plan.clock_delta
        if plan.lru_records:
            # every record exceeds everything in the heap: extend is a
            # valid heap push sequence
            self._lru.extend(plan.lru_records)
        if plan.lfu_push:
            push = heapq.heappush
            lfu = self._lfu
            for rec in plan.lfu_push:
                push(lfu, rec)
        if plan.hist_inc.size or plan.hist_dec.size:
            h = np.asarray(self._cnt_hist, np.int64)
            np.add.at(h, plan.hist_inc, 1)
            np.subtract.at(h, plan.hist_dec, 1)
            self._cnt_hist = h.tolist()
        self.used = plan.used_final
        self._nvals = plan.nvals_final
        self._nshort = plan.nshort_final
        self._zero_shortcuts = plan.zero_final
        s = self.stats
        s.value_hits += plan.value_hits
        s.shortcut_hits += plan.shortcut_hits
        s.misses += plan.misses
        s.promotions += plan.promotions
        s.demotions += plan.demotions

    def counts_array(self) -> np.ndarray:
        """Frequency vector as numpy (copy; for analysis/tests)."""
        return self.count.copy()

    def stamps_array(self) -> np.ndarray:
        """Recency vector as numpy (copy; for analysis/tests)."""
        return self.stamp.copy()

    # ----- batched API ------------------------------------------------------
    def classify_batch(self, keys: np.ndarray) -> np.ndarray:
        """Gather entry kinds for a batch: 0 absent, 1 shortcut, 2 value."""
        if keys.size:
            self._ensure(int(keys.max()))
        return self.kind[keys]

    def _victim_sum_hist(self, n: int, exclude_cnt: int):
        """Sum of the n smallest live-shortcut counts, excluding one
        shortcut with count ``exclude_cnt`` (the promotion candidate).
        None if the n-th victim spills past the histogram range -- the
        caller then takes the exact heap peek. The sum over the n
        cheapest counts is a multiset quantity, so tie-breaking by key
        cannot change it: the result equals the peek's sum exactly."""
        hist = self._cnt_hist
        s = 0
        got = 0
        for c in range(CNT_HIST_MAX):
            m = hist[c]
            if c == exclude_cnt:
                m -= 1
            if m <= 0:
                continue
            take = m if m <= n - got else n - got
            s += take * c
            got += take
            if got == n:
                return s
        return None

    # ----- internals --------------------------------------------------------
    def _remove(self, key: int):
        kd = self.kind[key]
        if kd == self.KIND_NONE:
            return None
        if self._dirty is not None:
            self._dirty.add(key)
        out = (self.ptr[key], self.length[key], self.count[key])
        if kd == self.KIND_VALUE:
            self.used -= self.value_bytes(out[1])
            self._nvals -= 1
        else:
            self.used -= SHORTCUT_BYTES
            self._nshort -= 1
            if out[2] == 0:
                self._zero_shortcuts -= 1
            self._cnt_hist[out[2] if out[2] < CNT_HIST_MAX
                           else CNT_HIST_MAX] -= 1
        self.kind[key] = self.KIND_NONE
        return out

    def _insert_value(self, key: int, ptr: int, length: int,
                      count: int) -> None:
        self._remove(key)
        need = self.value_bytes(length)
        self._make_space(need)
        if self.used + need > self.capacity:
            self._insert_shortcut(key, ptr, length, count)
            return
        if self._dirty is not None:
            self._dirty.add(key)
        self.kind[key] = self.KIND_VALUE
        self.ptr[key] = ptr
        self.length[key] = length
        self.count[key] = count
        self.stamp[key] = self._clock
        heapq.heappush(self._lru, (self._clock, key))
        self._clock += 1
        self.used += need
        self._nvals += 1

    def _insert_shortcut(self, key: int, ptr: int, length: int,
                         count: int) -> None:
        self._remove(key)
        self._make_space(SHORTCUT_BYTES)
        if self.used + SHORTCUT_BYTES > self.capacity:
            return  # cache smaller than one entry: degenerate, skip
        if self._dirty is not None:
            self._dirty.add(key)
        self.kind[key] = self.KIND_SHORTCUT
        self.ptr[key] = ptr
        self.length[key] = length
        self.count[key] = count
        heapq.heappush(self._lfu, (count, key))
        self.used += SHORTCUT_BYTES
        self._nshort += 1
        if count == 0:
            self._zero_shortcuts += 1
        self._cnt_hist[count if count < CNT_HIST_MAX
                       else CNT_HIST_MAX] += 1

    def _compact_lru(self) -> None:
        """Rebuild the LRU heap with one live record per value entry.
        Pure optimization: lazy pops return argmin (stamp, key) of the
        live entries regardless of stale records, but workloads that
        refresh every hot stamp per batch otherwise bloat the heap."""
        ks = np.flatnonzero(self.kind == self.KIND_VALUE)
        self._lru = list(zip(self.stamp[ks].tolist(), ks.tolist()))
        heapq.heapify(self._lru)

    def _compact_lfu(self) -> None:
        ks = np.flatnonzero(self.kind == self.KIND_SHORTCUT)
        self._lfu = list(zip(self.count[ks].tolist(), ks.tolist()))
        heapq.heapify(self._lfu)

    def _pop_lru(self) -> int | None:
        """Pop the least-recently-used *live* value key."""
        if len(self._lru) > 4 * self._nvals + 64:
            self._compact_lru()
        while self._lru:
            st, k = heapq.heappop(self._lru)
            if self.kind[k] != self.KIND_VALUE:
                continue                          # stale record: drop
            cur = self.stamp[k]
            if cur != st:
                heapq.heappush(self._lru, (cur, k))   # refresh
                continue
            return k
        return None

    def _make_space(self, need: int) -> None:
        """Demote LRU values first, then evict LFU shortcuts (Table 3)."""
        while self.used + need > self.capacity and self._nvals:
            k = self._pop_lru()
            if k is None:
                break
            if self._dirty is not None:
                self._dirty.add(k)
            ln = self.length[k]
            self.used -= self.value_bytes(ln)
            self._nvals -= 1
            self.kind[k] = self.KIND_NONE
            self.stats.demotions += 1
            if self.used + SHORTCUT_BYTES + need <= self.capacity:
                c = self.count[k]
                self.kind[k] = self.KIND_SHORTCUT
                heapq.heappush(self._lfu, (c, k))
                self.used += SHORTCUT_BYTES
                self._nshort += 1
                if c == 0:
                    self._zero_shortcuts += 1
                self._cnt_hist[c if c < CNT_HIST_MAX
                               else CNT_HIST_MAX] += 1
        while self.used + need > self.capacity and self._nshort:
            k = self._pop_lfu()
            if k is None:
                break
            if self._dirty is not None:
                self._dirty.add(k)
            c = self.count[k]
            self.kind[k] = self.KIND_NONE
            self.used -= SHORTCUT_BYTES
            self._nshort -= 1
            if c == 0:
                self._zero_shortcuts -= 1
            self._cnt_hist[c if c < CNT_HIST_MAX
                           else CNT_HIST_MAX] -= 1
            self.stats.evictions += 1

    def _pop_lfu(self) -> int | None:
        """Pop the least-frequently-used *live* shortcut key."""
        if len(self._lfu) > 4 * self._nshort + 64:
            self._compact_lfu()
        while self._lfu:
            cnt, k = heapq.heappop(self._lfu)
            if self.kind[k] != self.KIND_SHORTCUT:
                continue                          # stale record: drop
            cur = self.count[k]
            if cur != cnt:
                heapq.heappush(self._lfu, (cur, k))   # refresh
                continue
            return k
        return None

    def _peek_lfu(self, n: int, exclude: int):
        """Up-to-n least-frequently-used live shortcuts, dedup'd, in
        (count, key) order -- identical to DAC._peek_lfu."""
        if len(self._lfu) > 4 * self._nshort + 64:
            self._compact_lfu()
        popped = []
        out = []
        seen = set()
        while self._lfu and len(out) < n:
            cnt, k = heapq.heappop(self._lfu)
            if self.kind[k] != self.KIND_SHORTCUT:
                continue
            cur = self.count[k]
            if cur != cnt:
                heapq.heappush(self._lfu, (cur, k))
                continue
            popped.append((cnt, k))
            if k != exclude and k not in seen:
                seen.add(k)
                out.append((cnt, k))
        for item in popped:
            heapq.heappush(self._lfu, item)
        return out

    def _should_promote(self, key: int, cnt: int, length: int) -> bool:
        """Eq. 1, exactly as DAC._should_promote."""
        need = self.value_bytes(length) - SHORTCUT_BYTES
        free = self.capacity - self.used
        if free >= need:
            return True
        deficit = need - free
        n_evict = -(-deficit // SHORTCUT_BYTES)     # ceil
        if self._zero_shortcuts >= n_evict:
            # enough never-hit shortcuts: eviction is free (Eq. 1 rhs 0)
            return True
        if self._nshort - 1 < n_evict:
            return False                 # not enough shortcuts to evict
        total = self._victim_sum_hist(n_evict, cnt)
        if total is not None:
            return cnt * self.avg_shortcut_hit_rts \
                >= total * self.avg_miss_rts
        # histogram spill (a needed victim has count >= CNT_HIST_MAX):
        # fall back to the exact heap peek
        victims = self._peek_lfu(n_evict, exclude=key)
        if len(victims) < n_evict:
            return False
        evict_cost = sum(c for c, _ in victims) * self.avg_miss_rts
        return cnt * self.avg_shortcut_hit_rts >= evict_cost

    def _promote(self, key: int) -> None:
        p, ln, cnt = self.ptr[key], self.length[key], self.count[key]
        if self._dirty is not None:
            self._dirty.add(key)
        self.kind[key] = self.KIND_NONE
        self.used -= SHORTCUT_BYTES
        self._nshort -= 1
        if cnt == 0:
            self._zero_shortcuts -= 1
        self._cnt_hist[cnt if cnt < CNT_HIST_MAX
                       else CNT_HIST_MAX] -= 1
        # inherits access count (paper Sec. 4)
        self._insert_value(key, p, ln, count=cnt)


class ArrayStaticCache:
    """Array-backed StaticCache: the batched data plane's cache for the
    Fig. 3 static-split baselines (shortcut-only, value-only, static:f).

    Same policy as ``StaticCache``, decision-for-decision (property
    tested): entries live in dense per-key vectors -- kind (0 absent /
    1 shortcut / 2 value), pointer, length, recency stamp -- so a batch
    classifies with one gather and runs of hits apply in bulk. Each
    side keeps its own lazy LRU heap: argmin (stamp, key) over a side
    equals that side's OrderedDict order (stamps are monotone and hits
    move-to-end)."""

    KIND_NONE, KIND_SHORTCUT, KIND_VALUE = 0, 1, 2

    def __init__(self, capacity_bytes: int, value_fraction: float,
                 initial_keys: int = 1024):
        self.value_cap = int(capacity_bytes * value_fraction)
        self.shortcut_cap = capacity_bytes - self.value_cap
        self.value_used = 0
        self.shortcut_used = 0
        self.stats = CacheStats()
        n = max(initial_keys, 8)
        self.kind = np.zeros(n, np.int8)
        self.ptr = np.full(n, -1, np.int64)
        self.length = np.zeros(n, np.int64)
        self.stamp = np.zeros(n, np.int64)
        self._clock = 1
        self._vlru: list[tuple[int, int]] = []   # lazy heap (stamp, key)
        self._slru: list[tuple[int, int]] = []
        self._nvals = 0
        self._nshort = 0

    def _ensure(self, key: int) -> None:
        n = self.kind.shape[0]
        if key < n:
            return
        m = max(2 * n, key + 1)
        self.kind = np.concatenate([self.kind, np.zeros(m - n, np.int8)])
        self.ptr = np.concatenate([self.ptr, np.full(m - n, -1, np.int64)])
        self.length = np.concatenate([self.length,
                                      np.zeros(m - n, np.int64)])
        self.stamp = np.concatenate([self.stamp,
                                     np.zeros(m - n, np.int64)])

    # ----- public per-op API (mirrors StaticCache) --------------------------
    def lookup(self, key: int):
        self._ensure(key)
        kd = self.kind[key]
        if kd == self.KIND_VALUE:
            self.stamp[key] = self._clock
            self._clock += 1
            self.stats.value_hits += 1
            return ("value", self.ptr[key], self.length[key])
        if kd == self.KIND_SHORTCUT:
            self.stamp[key] = self._clock
            self._clock += 1
            self.stats.shortcut_hits += 1
            return ("shortcut", self.ptr[key], self.length[key])
        self.stats.misses += 1
        return None

    def note_miss_rts(self, rts: float) -> None:  # interface parity
        pass

    def _pop_side(self, heap, kd):
        """Pop the least-recently-used live key of one side."""
        live = self._nvals if kd == self.KIND_VALUE else self._nshort
        if len(heap) > 4 * live + 64:
            self._compact(kd)
            heap = self._vlru if kd == self.KIND_VALUE else self._slru
        while heap:
            st, k = heapq.heappop(heap)
            if self.kind[k] != kd:
                continue                          # stale record: drop
            cur = self.stamp[k]
            if cur != st:
                heapq.heappush(heap, (cur, k))    # refresh
                continue
            return k
        return None

    def _compact(self, kd) -> None:
        ks = np.flatnonzero(self.kind == kd)
        heap = list(zip(self.stamp[ks].tolist(), ks.tolist()))
        heapq.heapify(heap)
        if kd == self.KIND_VALUE:
            self._vlru = heap
        else:
            self._slru = heap

    def fill_after_miss(self, key: int, ptr: int, length: int) -> None:
        self._ensure(key)
        vb = VALUE_OVERHEAD_BYTES + length
        if vb <= self.value_cap:
            while self.value_used + vb > self.value_cap and self._nvals:
                v = self._pop_side(self._vlru, self.KIND_VALUE)
                if v is None:
                    break
                self.kind[v] = self.KIND_NONE
                self.value_used -= VALUE_OVERHEAD_BYTES + self.length[v]
                self._nvals -= 1
                self.stats.evictions += 1
            if self.value_used + vb <= self.value_cap:
                self.kind[key] = self.KIND_VALUE
                self.ptr[key] = ptr
                self.length[key] = length
                self.stamp[key] = self._clock
                heapq.heappush(self._vlru, (self._clock, key))
                self._clock += 1
                self.value_used += vb
                self._nvals += 1
                return
        while self.shortcut_used + SHORTCUT_BYTES > self.shortcut_cap \
                and self._nshort:
            v = self._pop_side(self._slru, self.KIND_SHORTCUT)
            if v is None:
                break
            self.kind[v] = self.KIND_NONE
            self.shortcut_used -= SHORTCUT_BYTES
            self._nshort -= 1
            self.stats.evictions += 1
        if self.shortcut_used + SHORTCUT_BYTES <= self.shortcut_cap:
            self.kind[key] = self.KIND_SHORTCUT
            self.ptr[key] = ptr
            self.length[key] = length
            self.stamp[key] = self._clock
            heapq.heappush(self._slru, (self._clock, key))
            self._clock += 1
            self.shortcut_used += SHORTCUT_BYTES
            self._nshort += 1

    def fill_after_write(self, key: int, ptr: int, length: int,
                         segment_cached: bool) -> None:
        self.invalidate(key)
        self.fill_after_miss(key, ptr, length)

    def invalidate(self, key: int) -> None:
        self._ensure(key)
        kd = self.kind[key]
        if kd == self.KIND_VALUE:
            self.value_used -= VALUE_OVERHEAD_BYTES + self.length[key]
            self._nvals -= 1
        elif kd == self.KIND_SHORTCUT:
            self.shortcut_used -= SHORTCUT_BYTES
            self._nshort -= 1
        self.kind[key] = self.KIND_NONE

    def demote_to_shortcut(self, key: int) -> None:
        self._ensure(key)
        if self.kind[key] == self.KIND_VALUE:
            p, ln = self.ptr[key], self.length[key]
            self.kind[key] = self.KIND_NONE
            self.value_used -= VALUE_OVERHEAD_BYTES + ln
            self._nvals -= 1
            self.fill_after_miss(key, p, ln)

    def update_pointer(self, key: int, ptr: int, length: int) -> None:
        self._ensure(key)
        if self.kind[key] != self.KIND_NONE:
            # StaticCache.update_pointer does not re-account bytes
            self.ptr[key] = ptr
            self.length[key] = length

    def clear(self) -> None:
        self.kind[:] = 0
        self.stamp[:] = 0
        self._vlru.clear()
        self._slru.clear()
        self.value_used = self.shortcut_used = 0
        self._nvals = self._nshort = 0

    def __contains__(self, key: int) -> bool:
        return key < self.kind.shape[0] and self.kind[key] != 0

    def bulk_value_hits(self, keys: np.ndarray) -> None:
        """A run of value hits: recency = clock at the key's last
        position in the run, exactly what per-op lookups do."""
        n = keys.shape[0]
        c0 = self._clock
        if n > 24:
            u, ridx = np.unique(keys[::-1], return_index=True)
            self.stamp[u] = c0 + (n - 1 - ridx)
        else:
            stp = self.stamp
            for i, k in enumerate(keys.tolist()):
                stp[k] = c0 + i
        self._clock += n
        self.stats.value_hits += n

    def apply_plan(self, plan) -> None:
        """Apply one planned window in bulk (see
        core.transition.plan_static_window): deduplicated last-wins
        scatters, per-side eviction victims disjoint from the window's
        keys, clock-ascending per-side LRU records."""
        kind = self.kind
        if plan.vvic:
            kind[np.asarray(plan.vvic, np.int64)] = self.KIND_NONE
        if plan.svic:
            kind[np.asarray(plan.svic, np.int64)] = self.KIND_NONE
        kind[plan.kk_keys] = plan.kk_kind
        if plan.fill_keys.size:
            self.ptr[plan.fill_keys] = plan.fill_ptr
            self.length[plan.fill_keys] = plan.fill_len
        if plan.stp_keys.size:
            self.stamp[plan.stp_keys] = plan.stp_vals
        self._clock += plan.clock_delta
        if plan.vlru_records:
            self._vlru.extend(plan.vlru_records)
        if plan.slru_records:
            self._slru.extend(plan.slru_records)
        self.value_used = plan.vused_final
        self.shortcut_used = plan.sused_final
        self._nvals = plan.nvals_final
        self._nshort = plan.nshort_final
        s = self.stats
        s.value_hits += plan.value_hits
        s.shortcut_hits += plan.shortcut_hits
        s.misses += plan.misses
        s.evictions += plan.evictions


class StaticCache:
    """Fig. 3 baselines: reserve ``value_fraction`` of capacity for values
    and the rest for shortcuts; LRU eviction on both sides.
    value_fraction=1.0 -> value-only; 0.0 -> shortcut-only."""

    def __init__(self, capacity_bytes: int, value_fraction: float):
        self.value_cap = int(capacity_bytes * value_fraction)
        self.shortcut_cap = capacity_bytes - self.value_cap
        self.value_used = 0
        self.shortcut_used = 0
        self.values: OrderedDict[int, _Entry] = OrderedDict()
        self.shortcuts: OrderedDict[int, _Entry] = OrderedDict()
        self.stats = CacheStats()

    def lookup(self, key: int):
        ent = self.values.get(key)
        if ent is not None:
            self.values.move_to_end(key)
            self.stats.value_hits += 1
            return ("value", ent.ptr, ent.length)
        ent = self.shortcuts.get(key)
        if ent is not None:
            self.shortcuts.move_to_end(key)
            self.stats.shortcut_hits += 1
            return ("shortcut", ent.ptr, ent.length)
        self.stats.misses += 1
        return None

    def note_miss_rts(self, rts: float) -> None:  # interface parity
        pass

    def fill_after_miss(self, key: int, ptr: int, length: int) -> None:
        vb = DAC.value_bytes(length)
        if vb <= self.value_cap:
            while self.value_used + vb > self.value_cap and self.values:
                _, old = self.values.popitem(last=False)
                self.value_used -= DAC.value_bytes(old.length)
                self.stats.evictions += 1
            if self.value_used + vb <= self.value_cap:
                self.values[key] = _Entry(ptr, length)
                self.value_used += vb
                return
        while self.shortcut_used + SHORTCUT_BYTES > self.shortcut_cap \
                and self.shortcuts:
            self.shortcuts.popitem(last=False)
            self.shortcut_used -= SHORTCUT_BYTES
            self.stats.evictions += 1
        if self.shortcut_used + SHORTCUT_BYTES <= self.shortcut_cap:
            self.shortcuts[key] = _Entry(ptr, length)
            self.shortcut_used += SHORTCUT_BYTES

    def fill_after_write(self, key: int, ptr: int, length: int,
                         segment_cached: bool) -> None:
        self.invalidate(key)
        self.fill_after_miss(key, ptr, length)

    def invalidate(self, key: int) -> None:
        ent = self.values.pop(key, None)
        if ent is not None:
            self.value_used -= DAC.value_bytes(ent.length)
        ent = self.shortcuts.pop(key, None)
        if ent is not None:
            self.shortcut_used -= SHORTCUT_BYTES

    def demote_to_shortcut(self, key: int) -> None:
        ent = self.values.pop(key, None)
        if ent is not None:
            self.value_used -= DAC.value_bytes(ent.length)
            self.fill_after_miss(key, ent.ptr, ent.length)

    def update_pointer(self, key: int, ptr: int, length: int) -> None:
        ent = self.values.get(key) or self.shortcuts.get(key)
        if ent is not None:
            ent.ptr, ent.length = ptr, length

    def clear(self) -> None:
        self.values.clear()
        self.shortcuts.clear()
        self.value_used = self.shortcut_used = 0

    def __contains__(self, key: int) -> bool:
        return key in self.values or key in self.shortcuts
