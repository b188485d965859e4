"""The DINOMO cluster: clients -> RNs -> KNs -> DPM pool (paper Fig. 1).

The port's copy of the reference's host engine. Four system variants
share it (paper Sec. 5):
  dinomo    OP + DAC + selective replication          (the paper's system)
  dinomo-s  OP + shortcut-only cache                  (isolates DAC's benefit)
  dinomo-n  shared-nothing + DAC                      (AsymNVM stand-in)
  clover    shared-everything + shortcut-only cache   (state of the art)
Every request runs against the real structures (DAC caches, the CLHT
index, log segments, the indirection table) and the exact number of
network round trips is counted per operation, decision for decision as
the reference does. Like the reference it is a host program over numpy
and Python structures, with two parts on the device: the DPM pool's
batched index reads (``DPMPool.index_lookup_batch``: kernel A over a
packed copy of the index), which ``execute_batch`` makes once per KN a
batch for that KN's predicted cache misses (``clover``: once a batch
for every op's key, the batched Clover plane's index read), and, with
``execute_batch(engine="jit")``, each eligible KN window of the DAC
state machine (``core.jit_engine``: kernel E over the KN's cache state,
resident on the device for the batch). A static cache's windows
(``dinomo-s``) run on the host engine under either engine, as in the
reference.
"""

from __future__ import annotations

import heapq
import itertools
import random
from collections import OrderedDict
from dataclasses import dataclass
from time import perf_counter

import numpy as np

from . import sanitize
from .dac import (CNT_HIST_MAX, SHORTCUT_BYTES, VALUE_OVERHEAD_BYTES,
                  ArrayDAC, ArrayStaticCache, CacheStats, DAC, StaticCache)
from .dpm_pool import DPMPool, FencedWrite
from .faults import CRASH_POINTS, KNCrash
from .hashring import stable_hash
from .mnode import PolicyConfig, PolicyEngine
from .netmodel import DEFAULT_MODEL, NetModel
from .ownership import OwnershipMap, ReconfigEvent
from .transition import (ENGINE_WALL, PLAN_STATS, plan_clover_reads,
                         plan_dac_window, plan_static_window)


@dataclass(frozen=True)
class VariantConfig:
    name: str
    cache_policy: str          # "dac" | "shortcut" | "value" | "static:<f>" | "clover"
    architecture: str          # "op" | "shared_nothing" | "shared_everything"
    selective_replication: bool


DINOMO = VariantConfig("dinomo", "dac", "op", True)
DINOMO_S = VariantConfig("dinomo-s", "shortcut", "op", True)
DINOMO_N = VariantConfig("dinomo-n", "dac", "shared_nothing", False)
CLOVER = VariantConfig("clover", "clover", "shared_everything", False)
VARIANTS = {v.name: v for v in (DINOMO, DINOMO_S, DINOMO_N, CLOVER)}


def make_cache(policy: str, capacity_bytes: int, reference: bool = False,
               initial_keys: int = 1024):
    """Build a KN cache. Every policy has two decision-for-decision
    equivalent implementations: the array-backed one the batched data
    plane vectorizes over (pre-sized to ``initial_keys`` keys), and the
    OrderedDict/heapq one -- ``reference=True`` selects the latter as
    the oracle."""
    if policy == "dac":
        return DAC(capacity_bytes) if reference \
            else ArrayDAC(capacity_bytes, initial_keys=initial_keys)
    if policy in ("shortcut", "value") or policy.startswith("static:"):
        frac = {"shortcut": 0.0, "value": 1.0}.get(policy)
        if frac is None:
            frac = float(policy.split(":")[1])
        return StaticCache(capacity_bytes, frac) if reference \
            else ArrayStaticCache(capacity_bytes, frac,
                                  initial_keys=initial_keys)
    if policy == "clover":
        return CloverCache(capacity_bytes) if reference \
            else ArrayCloverCache(capacity_bytes, initial_keys=initial_keys)
    raise ValueError(f"unknown cache policy {policy!r}")


class CloverCache:
    """Clover KNs keep a shortcut-only cache whose entries can go stale:
    out-of-place updates grow a version chain that readers must walk."""

    def __init__(self, capacity_bytes: int, entry_bytes: int = 32):
        self.cap_entries = max(capacity_bytes // entry_bytes, 1)
        self.entries: OrderedDict[int, int] = OrderedDict()  # key -> version
        self.stats = CacheStats()

    def lookup(self, key: int):
        v = self.entries.get(key)
        if v is None:
            self.stats.misses += 1
            return None
        self.entries.move_to_end(key)
        self.stats.shortcut_hits += 1
        return v

    def fill(self, key: int, version: int):
        self.entries[key] = version
        self.entries.move_to_end(key)
        while len(self.entries) > self.cap_entries:
            self.entries.popitem(last=False)
            self.stats.evictions += 1

    def clear(self):
        self.entries.clear()


class ArrayCloverCache:
    """Array-backed CloverCache: the batched Clover plane's version
    cache. Same policy as ``CloverCache`` decision-for-decision
    (property-tested): presence + version + recency stamp per key, LRU
    eviction through a lazy (stamp, key) heap -- argmin stamp over
    present keys equals the OrderedDict front."""

    def __init__(self, capacity_bytes: int, entry_bytes: int = 32,
                 initial_keys: int = 1024):
        self.cap_entries = max(capacity_bytes // entry_bytes, 1)
        n = max(initial_keys, 8)
        self.present = np.zeros(n, bool)
        self.ver = np.zeros(n, np.int64)
        self.stamp = np.zeros(n, np.int64)
        self._clock = 1
        self._lru: list[tuple[int, int]] = []
        self._n = 0
        self.stats = CacheStats()

    def _ensure(self, key: int) -> None:
        n = self.present.shape[0]
        if key < n:
            return
        m = max(2 * n, key + 1)
        self.present = np.concatenate(
            [self.present, np.zeros(m - n, bool)])
        self.ver = np.concatenate([self.ver, np.zeros(m - n, np.int64)])
        self.stamp = np.concatenate([self.stamp,
                                     np.zeros(m - n, np.int64)])

    def lookup(self, key: int):
        self._ensure(key)
        if not self.present[key]:
            self.stats.misses += 1
            return None
        self.stamp[key] = self._clock
        self._clock += 1
        self.stats.shortcut_hits += 1
        return self.ver[key]

    def fill(self, key: int, version: int):
        self._ensure(key)
        if not self.present[key]:
            self.present[key] = True
            self._n += 1
        self.ver[key] = version
        self.stamp[key] = self._clock
        heapq.heappush(self._lru, (self._clock, key))
        self._clock += 1
        while self._n > self.cap_entries:
            if len(self._lru) > 4 * self._n + 64:
                ks = np.flatnonzero(self.present)
                self._lru = list(zip(self.stamp[ks].tolist(),
                                     ks.tolist()))
                heapq.heapify(self._lru)
            st, k = heapq.heappop(self._lru)
            if not self.present[k]:
                continue                          # stale record: drop
            cur = self.stamp[k]
            if cur != st:
                heapq.heappush(self._lru, (cur, k))   # refresh
                continue
            self.present[k] = False
            self._n -= 1
            self.stats.evictions += 1

    def apply_plan(self, plan) -> None:
        """Apply one planned read-batch window in bulk (see
        core.transition.plan_clover_reads): deduplicated fill scatters,
        eviction-free by construction, clock-ascending LRU records."""
        if plan.fill_keys.size:
            self.present[plan.fill_keys] = True
            self.ver[plan.fill_keys] = plan.fill_ver
        if plan.stp_keys.size:
            self.stamp[plan.stp_keys] = plan.stp_vals
        self._clock += plan.clock_delta
        if plan.lru_records:
            self._lru.extend(plan.lru_records)
        self._n = plan.n_final
        self.stats.shortcut_hits += plan.shortcut_hits
        self.stats.misses += plan.misses

    def clear(self):
        self.present[:] = False
        self._lru.clear()
        self._n = 0


@dataclass
class KNStats:
    ops: int = 0
    rts: float = 0.0
    reads: int = 0
    writes: int = 0
    write_stalls: int = 0
    refused: int = 0

    def reset_window(self):
        self.ops = 0
        self.rts = 0.0
        self.reads = 0
        self.writes = 0


@dataclass
class BatchResult:
    """What a batched execution observed (aggregates the scalar loop
    would have produced; per-op stats land in kn.stats / cache.stats)."""
    executed: int                  # ops that reached a KN (incl. refused)
    writes: int                    # write attempts among them
    per_kn: dict[str, int]         # executed ops per KN name
    executed_keys: np.ndarray      # keys of executed ops, in order
    values: list | None = None     # read results iff collect_values


class _WritePlan:
    """One batch's staged write plane (built by _build_write_plan):
    per-write pointers/flush-RTs in global write order, rotation events
    for the coordinator to replay, and per-KN write positions for the
    stall scan."""
    __slots__ = ("nw", "ptrs", "rts", "wrank", "wkeys", "rotations",
                 "wpos_by_name", "segq", "rot_done", "staged",
                 "ptrs_l", "rts_l", "wrank_l")

    def __init__(self):
        self.nw = 0
        self.ptrs = None
        self.rts = None
        self.wrank = None
        self.wkeys = None
        self.ptrs_l = None
        self.rts_l = None
        self.wrank_l = None
        self.rotations: list = []
        self.wpos_by_name: dict = {}
        self.segq: dict = {}       # kn -> [(segment, lo, hi) ranges]
        self.rot_done: dict = {}   # kn -> rotations executed so far
        self.staged: dict = {}     # kn -> (logical_keys, ptrs) lists



class _KnWindow:
    """Per-KN cursor over its live non-replicated ops in a batch."""
    __slots__ = ("kn", "cache", "pos", "idx", "is_dac", "is_static")

    def __init__(self, kn, cache, pos):
        self.kn = kn
        self.cache = cache
        self.pos = pos
        self.idx = 0
        self.is_dac = isinstance(cache, ArrayDAC)
        self.is_static = isinstance(cache, ArrayStaticCache)


class KVSNode:
    """One KN: cache + exclusive log + soft ownership state."""

    def __init__(self, name: str, variant: VariantConfig, cache_bytes: int,
                 pool: DPMPool, write_batch: int = 8,
                 segcache_segments: int = 4, reference_cache: bool = False,
                 initial_keys: int = 1024):
        """``initial_keys`` pre-sizes an ArrayDAC's per-key vectors (a
        KN over a large key space grows them once, not by doublings)."""
        self.name = name
        self.variant = variant
        self.cache = make_cache(variant.cache_policy, cache_bytes,
                                reference=reference_cache,
                                initial_keys=initial_keys)
        if sanitize.enabled():
            sanitize.guard_cache(self.cache, name)
        self.pool = pool
        self.write_batch = write_batch
        self._pending_flush = 0
        # committed/un-merged segments cached locally (paper Sec. 4):
        # keys here are readable with zero RTs at the writing KN.
        self.segcache: OrderedDict[int, tuple[int, int]] = OrderedDict()
        self.segcache_cap = segcache_segments * pool.segment_capacity
        self.stats = KNStats()
        self.alive = True
        self.available = True      # False while participating in a reconfig
        # the ownership epoch this KN believes it holds: captured from
        # the cluster at every reconfiguration, presented with every
        # DPM mutation.  A partitioned KN keeps its *old* token while
        # the cluster moves on -- the DPM fence then rejects it.
        self.fence_token: int | None = None

    # ----- helpers ---------------------------------------------------------
    def _segcache_put(self, key: int, ptr: int, length: int):
        self.segcache[key] = (ptr, length)
        self.segcache.move_to_end(key)
        while len(self.segcache) > self.segcache_cap:
            self.segcache.popitem(last=False)

    def flush_rts(self) -> float:
        """Amortized one-sided log-write cost: one RT per batch.  A
        dropped flush ack (FaultPlane network fault) costs one retry
        RT on top."""
        self._pending_flush += 1
        if self._pending_flush >= self.write_batch:
            self._pending_flush = 0
            fp = self.pool.faults
            if fp is not None and fp.drop_flush_rt():
                return 2.0
            return 1.0
        return 0.0

    def clear_soft_state(self):
        # reconfiguration/failure path: any peer may wipe this KN's DRAM
        with sanitize.management():
            self.cache.clear()
        self.segcache.clear()


class DinomoCluster:
    """End-to-end cluster with exact RT accounting."""

    def __init__(self, variant: VariantConfig = DINOMO, num_kns: int = 4,
                 cache_bytes: int = 1 << 20, value_bytes: int = 1024,
                 model: NetModel = DEFAULT_MODEL,
                 policy: PolicyConfig | None = None,
                 num_buckets: int = 1 << 18, segment_capacity: int = 2048,
                 vnodes: int = 64, seed: int = 0,
                 reference_cache: bool = False, device=None):
        """``device`` is the DPM pool's and the jit engine's (the batched
        index reads and the compiled windows run there): ``None`` is the
        card, ``"cpu"`` runs the plain versions and must be asked for."""
        self.variant = variant
        # reference_cache selects the unoptimized per-op DAC oracle
        # (the batched plane then runs the fused per-op fallback)
        self.reference_cache = reference_cache
        self.model = model
        self.value_bytes = value_bytes
        self.cache_bytes = cache_bytes
        self.pool = DPMPool(num_buckets=num_buckets,
                            segment_capacity=segment_capacity,
                            device=device)
        self.device = self.pool.device
        self.ownership = OwnershipMap(vnodes=vnodes)
        self.kns: dict[str, KVSNode] = {}
        self.mnode = PolicyEngine(policy or PolicyConfig())
        self.rng = random.Random(seed)
        self._kn_counter = 0
        self._seq = 0
        # batch engine selection ("host" | "jit"), set per execute_batch
        self._engine = "host"
        self._jit = None        # lazy JitEngine (jit_engine.py)
        # Clover: per-key version counters + metadata-server op count
        self.versions: dict[int, int] = {}
        self.ms_ops = 0
        self.reconfig_log: list[dict] = []
        for _ in range(num_kns):
            self.add_kn(record=False)

    # ---------------------------------------------------------------------
    # membership
    # ---------------------------------------------------------------------
    def _new_kn_name(self) -> str:
        self._kn_counter += 1
        return f"kn{self._kn_counter}"

    def add_kn(self, record: bool = True) -> tuple[str, ReconfigEvent | None]:
        name = self._new_kn_name()
        self.pool.register_kn(name)
        self.kns[name] = KVSNode(name, self.variant, self.cache_bytes,
                                 self.pool,
                                 reference_cache=self.reference_cache)
        ev = self.ownership.add_kn(name)
        cost = self._reconfigure(ev) if record else None
        if not record:
            # initial construction bypasses _reconfigure; the fence
            # table still has to reach the pool before any write
            self._publish_fences()
        return name, ev if record else None

    def remove_kn(self, name: str) -> ReconfigEvent:
        ev = self.ownership.remove_kn(name)
        self._reconfigure(ev)
        self.pool.drop_kn(name)
        self._drop_resident(name)
        del self.kns[name]
        return ev

    def fail_kn(self, name: str) -> ReconfigEvent:
        """Fail-stop KN failure: DRAM (cache) contents lost; its pending
        log segments survive in DPM and are merged by a peer."""
        kn = self.kns[name]
        kn.alive = False
        self._drop_resident(name)
        kn.clear_soft_state()          # DRAM lost
        ev = self.ownership.remove_kn(name, failed=True)
        self._reconfigure(ev, failed=name)
        del self.kns[name]
        return ev

    def _drop_resident(self, name: str) -> None:
        """Free the jit engine's device copy of a KN's cache (a KN that
        leaves, fails or hands off ownership)."""
        if self._jit is not None:
            self._jit.drop(name)

    def _reconfigure(self, ev: ReconfigEvent, failed: str | None = None):
        """Paper Sec. 3.5 seven-step protocol. Returns a cost record with
        the synchronous-merge size (netmodel converts to seconds).

        Steps: (1) identify participants, (2) participants unavailable,
        (3) synchronously merge their pending logs, (4) new mapping,
        (5) participants available (others already serving; wrongly
        routed requests are refused), (6)/(7) async propagation."""
        participants = [p for p in ev.participants if p in self.kns]
        for p in participants:
            self.kns[p].available = False                 # step 2
        # fence the handoff *before* anyone touches the moved ranges:
        # the ownership map already bumped the participants' (and a
        # failed node's) generations, so publishing here invalidates
        # every token the old owners still hold -- a zombie that heals
        # after this point can no longer mutate DPM state
        self._publish_fences()
        merged = 0
        recovery = None
        if failed is not None:
            # crash-consistent recovery by a peer (paper Sec. 3.6): the
            # failed KN's segments are recovered -- torn tails
            # discarded, sealed-but-unmerged entries replayed, dangling
            # indirection repaired -- not just merged; a crash can leave
            # state merge_all would mis-account (see DPMPool.recover_kn)
            recovery = self.pool.recover_kn(failed)
            merged += recovery["replayed"]
            self.pool.drop_kn(failed)
        for p in participants:
            merged += self.pool.merge_all(p)              # step 3
        moved_fraction = 0.0
        if self.variant.architecture == "shared_nothing":
            # AsymNVM-style: physical data reorganization is required.
            moved_fraction = 1.0 / max(len(self.kns), 1)
        for p in participants:
            self._drop_resident(p)
            if self.kns[p].alive:
                self.kns[p].clear_soft_state()            # ownership moved
                self.kns[p].available = True              # step 5
        # durable policy metadata so restarted nodes can rebuild
        self.pool.policy_metadata["ownership"] = self.ownership.snapshot_blob()
        rec = {"event": ev.kind, "node": ev.node,
               "participants": sorted(ev.participants),
               "merged_entries": merged,
               "moved_fraction": moved_fraction,
               "version": ev.new_version}
        if recovery is not None:
            rec["recovery"] = recovery
        self.reconfig_log.append(rec)
        return rec

    def _publish_fences(self) -> None:
        """Install the ownership map's fence generations at the pool
        (the store-side fence every DPM mutation validates against) and
        refresh the tokens live KNs hold in soft state."""
        self.pool.publish_fences(self.ownership.fence)
        for nm, kn in self.kns.items():
            if kn.alive:    # a dead/zombie node keeps its stale token
                kn.fence_token = self.ownership.fence.get(nm)

    # ---------------------------------------------------------------------
    # selective replication mechanics (policy lives in mnode)
    # ---------------------------------------------------------------------
    def replicate_key(self, key: int, factor: int) -> None:
        if not self.variant.selective_replication:
            return
        # pending log entries for this key must reach the index before
        # the indirection slot snapshots it (paper: merge-before-share)
        for owner in self.ownership.owners(key):
            if owner in self.kns:
                self.pool.merge_all(owner)
        self.pool.install_indirect(key)
        owners = self.ownership.replicate(key, factor)
        # indirect pointers forbid value caching (paper Sec. 5.3)
        with sanitize.management():
            for o in owners:
                if o in self.kns:
                    self.kns[o].cache.demote_to_shortcut(key)

    def dereplicate_key(self, key: int) -> None:
        with sanitize.management():
            for o in self.ownership.owners(key):
                if o in self.kns:
                    self.kns[o].cache.invalidate(key)
        self.ownership.dereplicate(key)
        self.pool.remove_indirect(key)

    # ---------------------------------------------------------------------
    # request execution. Returns RTs charged (floats: write RTs amortize).
    # ---------------------------------------------------------------------
    def route(self, key: int) -> str:
        if self.variant.architecture == "shared_everything":
            # any KN serves any key: clients spread requests uniformly
            names = [n for n, k in self.kns.items() if k.alive]
            return self.rng.choice(names)
        owners = [o for o in self.ownership.owners(key) if o in self.kns]
        if not owners:
            raise KeyError("no owner")
        return owners[0] if len(owners) == 1 else self.rng.choice(owners)

    def read(self, key: int, kn_name: str | None = None, _probe=None):
        """``_probe``: optional (ptr_or_None, probes) pair prefetched by
        execute_batch against the current index version -- used in place
        of the per-key index traversal on the miss path."""
        kn_name = kn_name or self.route(key)
        with sanitize.owned(kn_name):
            return self._read_at(key, kn_name, _probe)

    def _read_at(self, key: int, kn_name: str, _probe=None):
        kn = self.kns[kn_name]
        if not kn.available or not kn.alive:
            kn.stats.refused += 1
            return None, 0.0, False
        if self.variant.name == "clover":
            return self._clover_read(kn, key)
        kn.stats.ops += 1
        kn.stats.reads += 1
        replicated = (self.variant.selective_replication
                      and self.ownership.is_replicated(key))
        rts = 0.0
        value = None
        hit = kn.cache.lookup(key)
        if hit is not None:
            kind, ptr, _len = hit
            if kind == "value" and not replicated:
                value = self.pool.read_value(ptr)[0]      # 0 RTs
            elif replicated:
                # shortcut names the indirection slot: 1 RT to read the
                # indirect pointer + 1 RT to read the value
                tgt = self.pool.read_indirect(key)
                rts += 2.0
                value = self.pool.read_value(tgt)[0] if tgt is not None \
                    else None
            else:
                rts += 1.0                                 # one-sided read
                value = self.pool.read_value(ptr)[0]
        else:
            seg = kn.segcache.get(key)
            if seg is not None and not replicated:
                ptr, length = seg
                value = self.pool.read_value(ptr)[0]       # local segment
                kn.cache.fill_after_write(key, ptr, length,
                                          segment_cached=True)
            else:
                ptr, probes = (self.pool.index_lookup(key)
                               if _probe is None else _probe)
                rts += probes                               # index traversal
                if ptr is None:
                    kn.stats.rts += rts
                    return None, rts, True
                rts += 1.0                                  # value fetch
                value, length = self.pool.read_value(ptr)
                kn.cache.note_miss_rts(rts)
                kn.cache.fill_after_miss(key, ptr, length)
        kn.stats.rts += rts
        return value, rts, True

    def write(self, key: int, value, kn_name: str | None = None,
              delete: bool = False, req_id: int = -1):
        kn_name = kn_name or self.route(key)
        with sanitize.owned(kn_name):
            return self._write_at(key, value, kn_name, delete, req_id)

    def _write_at(self, key: int, value, kn_name: str,
                  delete: bool = False, req_id: int = -1):
        kn = self.kns[kn_name]
        if not kn.available or not kn.alive:
            kn.stats.refused += 1
            return 0.0, False
        if self.variant.name == "clover":
            return self._clover_write(kn, key, value, delete, req_id)
        kn.stats.ops += 1
        kn.stats.writes += 1
        self._seq += 1
        rts = kn.flush_rts()       # amortized one-sided batched log write
        length = 0 if delete else self.value_bytes
        logical_key = -key - 1 if delete else key
        replicated = (self.variant.selective_replication
                      and self.ownership.is_replicated(key) and not delete)
        res = self.pool.log_write(kn.name, logical_key,
                                  None if delete else value, length,
                                  req_id=req_id, token=kn.fence_token)
        if isinstance(res, FencedWrite):
            kn.stats.refused += 1       # stale epoch: clean no-op
            return 0.0, False
        ptr, rotated = res
        if self.pool.write_blocked(kn.name):
            kn.stats.write_stalls += 1
            self.pool.merge_budget(self.pool.segment_capacity)
        if replicated:
            # atomically swing the indirect pointer: one-sided CAS
            expect = self.pool.read_indirect(key)
            self.pool.cas_indirect(key, expect, ptr,
                                   kn=kn.name, token=kn.fence_token)
            rts += 1.0
            kn.cache.update_pointer(key, ptr, length)
        elif delete:
            kn.cache.invalidate(key)
            kn.segcache.pop(key, None)
        else:
            kn._segcache_put(key, ptr, length)
            kn.cache.fill_after_write(key, ptr, length, segment_cached=True)
        self.versions[key] = self.versions.get(key, 0) + 1
        kn.stats.rts += rts
        return rts, True

    # ----- Clover request paths (shared everything, version chains) -------
    def _clover_read(self, kn: KVSNode, key: int):
        kn.stats.ops += 1
        kn.stats.reads += 1
        cur = self.versions.get(key, 0)
        cached = kn.cache.lookup(key)
        rts = 0.0
        if cached is None:
            self.ms_ops += 1            # two-sided RPC to metadata server
            rts += 1.0                  # (modeled as 1 RT-equivalent + MS load)
        ptr, _probes = self.pool.index_lookup(key)
        if ptr is None:
            kn.stats.rts += rts
            return None, rts, True
        stale = 0 if cached is None else max(cur - cached, 0)
        # walk the version chain from the cached cursor: header + value
        rts += 2.0 + stale
        kn.cache.fill(key, cur)
        value, _ = self.pool.read_value(ptr)
        kn.stats.rts += rts
        return value, rts, True

    def _clover_write(self, kn: KVSNode, key: int, value, delete: bool,
                      req_id: int = -1):
        kn.stats.ops += 1
        kn.stats.writes += 1
        length = 0 if delete else self.value_bytes
        logical_key = -key - 1 if delete else key
        res = self.pool.log_write(kn.name, logical_key,
                                  None if delete else value, length,
                                  req_id=req_id, token=kn.fence_token)
        if isinstance(res, FencedWrite):
            kn.stats.refused += 1
            return 0.0, False
        ptr, _ = res
        self.pool.merge_all(kn.name)    # Clover updates metadata in place
        rts = 2.0                       # out-of-place append + link/CAS
        self.versions[key] = self.versions.get(key, 0) + 1
        kn.cache.fill(key, self.versions[key])
        kn.stats.rts += rts
        return rts, True

    # ---------------------------------------------------------------------
    # batched data plane (vectorized op engine, read plane + write
    # plane): routes a whole batch with one consistent-hash
    # gather, stages the entire write plane up front (one bulk heap
    # extension, bulk per-KN segment fills, precomputed amortized-flush
    # RTs), then coordinates the batch as per-KN windows between global
    # events -- segment rotations, stall-triggered merges (which run
    # through the pool's planned merge plane: merge_entries_batch plans
    # each window as a MergeWindowPlan and applies it in bulk), and
    # replicated-key ops. Inside a window, per-KN streams are provably
    # independent, so ops are applied as vectorized runs (bulk value
    # hits, bulk write fills) with exact scalar fallbacks at every
    # boundary the vectorized regime cannot prove. Produces *identical*
    # statistics and cache decisions to calling read()/write() per op
    # (tests/test_torch_cluster*.py hold it to the reference's twin).
    # ---------------------------------------------------------------------
    def execute_batch(self, kinds, keys, *, value=None, values=None,
                      blocked_kns=(), collect_values: bool = False,
                      req_ids=None, engine: str | None = None) \
            -> "BatchResult":
        """Execute a batch of operations in submission order.

        kinds: (N,) array, 0 == read, 1 == write, 2 == delete
        keys:  (N,) int array
        value/values: write payloads (constant, sequence, or callable)
        blocked_kns: KN names whose ops are dropped before execution
            (the timed simulation's outage windows)
        collect_values: materialize read results (costs a python pass)
        req_ids: optional (N,) int array of client request IDs (-1 for
            none); write entries carry them into the durable log so the
            open-loop request plane's retries deduplicate exactly-once
            (DPMPool.req_index)
        engine: None/"host" -> the host window engine; "jit" -> the
            compiled batch executor (core.jit_engine): eligible
            ArrayDAC windows run as single kernel-E launches over
            device-resident cache state, truncation residuals and
            everything else replay through the host engine, so the
            result is decision-for-decision identical
            (tests/test_torch_jit_engine.py)
        """
        if engine not in (None, "host", "jit"):
            raise ValueError(f"unknown engine {engine!r}")
        self._engine = engine or "host"
        keys = np.ascontiguousarray(np.asarray(keys, dtype=np.int64))
        kinds = np.asarray(kinds, dtype=np.uint8)
        if req_ids is not None:
            req_ids = np.asarray(req_ids, dtype=np.int64)
        n = keys.shape[0]
        out_values: list | None = [None] * n if collect_values else None
        if n == 0 or not self.kns:
            return BatchResult(0, 0, {}, keys[:0], out_values)
        if self.variant.architecture == "shared_everything":
            if all(isinstance(k.cache, ArrayCloverCache)
                   for k in self.kns.values()) \
                    and not self.pool.indirect \
                    and not self.pool.merge_backlog \
                    and all(not s[-1].entries
                            for s in self.pool.segments.values()):
                # clover merges per write, so the batched plane assumes
                # (and every batch re-establishes) empty active logs
                return self._execute_batch_clover(kinds, keys, value,
                                                  values, blocked_kns,
                                                  out_values, req_ids)
            return self._execute_batch_fused(kinds, keys, value, values,
                                             blocked_kns, out_values,
                                             req_ids)
        if not all(isinstance(k.cache, (ArrayDAC, ArrayStaticCache))
                   for k in self.kns.values()):
            # reference caches have no vectorized plane: run the fused
            # scalar loop (same per-op semantics, minus driver overhead)
            return self._execute_batch_fused(kinds, keys, value, values,
                                             blocked_kns, out_values,
                                             req_ids)
        return self._execute_batch_spans(kinds, keys, value, values,
                                         blocked_kns, out_values, req_ids)

    def _execute_batch_spans(self, kinds, keys, value, values, blocked_kns,
                             out_values, req_ids=None) -> "BatchResult":
        names = list(self.kns.keys())
        name_idx = {nm: j for j, nm in enumerate(names)}
        n = keys.shape[0]

        # ----- vectorized routing over the ownership ring ------------------
        ring_ids, ring_names = self.ownership.primary_ids(keys)
        ring_to_kn = np.array([name_idx.get(nm, -1) for nm in ring_names],
                              dtype=np.int64)
        kn_ids = ring_to_kn[ring_ids]
        rep_arr = self.ownership.replicated_keys_array()
        if rep_arr.size:
            rep_mask = np.isin(keys, rep_arr)
            for p in np.nonzero(rep_mask)[0]:
                try:   # replicated keys draw a random owner, as scalar
                    kn_ids[p] = name_idx[self.route(int(keys[p]))]
                except KeyError:
                    kn_ids[p] = -1
        else:
            rep_mask = np.zeros(n, bool)

        # ----- availability masks ------------------------------------------
        blocked = np.zeros(len(names), bool)
        for nm in blocked_kns:
            j = name_idx.get(nm)
            if j is not None:
                blocked[j] = True
        refusing = np.array([not (self.kns[nm].alive
                                  and self.kns[nm].available)
                             for nm in names], bool)
        safe_ids = np.maximum(kn_ids, 0)
        exec_mask = (kn_ids >= 0) & ~blocked[safe_ids]
        refused_mask = exec_mask & refusing[safe_ids]
        live = exec_mask & ~refused_mask
        rcnt = np.bincount(kn_ids[refused_mask], minlength=len(names))
        for j in np.nonzero(rcnt)[0]:
            self.kns[names[j]].stats.refused += int(rcnt[j])

        # ----- stage the write plane ---------------------------------------
        pool = self.pool
        plan = self._build_write_plan(kinds, keys, kn_ids, live, names,
                                      value, values, req_ids)

        # ----- per-KN windows + predicted-miss probe prefetch --------------
        # (one vectorized CLHT gather replaces per-key chain walks; each
        # prefetched probe stays exact until a mid-batch merge remaps
        # its key or grows its bucket chain -- the pool's dirty sets --
        # after which that key's misses take the live per-key traversal,
        # exactly as the per-op path would)
        probe_map: dict[int, tuple] = {}
        dkeys, dbuckets = pool.track_merge_dirty()
        windows = []
        for grp in self._kn_groups(np.nonzero(live & ~rep_mask)[0], kn_ids):
            kn = self.kns[names[int(kn_ids[grp[0]])]]
            cache = kn.cache
            # grow the per-key vectors up front: the window loops cache
            # bound accessors, so the arrays must not move mid-batch
            cache._ensure(int(keys[grp].max()))
            rsub = grp[kinds[grp] == 0]
            if rsub.size:
                pm = rsub[cache.kind[keys[rsub]] == 0]
                if pm.size:
                    pk = keys[pm]
                    pptr, pprob = pool.index_lookup_batch(pk)
                    pbuck = pool.index._bucket_batch(pk)
                    for p_, pp, pb, bk in zip(pm.tolist(), pptr.tolist(),
                                              pprob.tolist(),
                                              pbuck.tolist()):
                        probe_map[p_] = (None if pp < 0 else pp, pb, bk)
            windows.append(_KnWindow(kn, cache, grp))

        # ----- event-driven coordination -----------------------------------
        # Global events order the cross-KN interactions exactly as the
        # per-op loop would: a rotation pushes its segment to the shared
        # FIFO backlog at its global position; a blocked KN's write
        # stalls and merges one budget chunk (all KNs' windows advance
        # first, so their reads observe the pre-merge index); a
        # replicated-key op synchronizes on the shared indirection slot.
        rep_pos = np.nonzero(live & rep_mask)[0]
        rot = plan.rotations
        cap = pool.segment_capacity
        stalls: dict[str, int] = {}
        try:
            ri, nrot = 0, len(rot)
            si, nrep = 0, int(rep_pos.size)
            cursor = -1
            while True:
                nr = rot[ri][0] if ri < nrot else n
                nrp = int(rep_pos[si]) if si < nrep else n
                ns, ns_name = n, None
                for nm, arr in plan.wpos_by_name.items():
                    if arr.size and pool.write_blocked(nm):
                        ii = int(np.searchsorted(arr, cursor, side="right"))
                        if ii < arr.size and arr[ii] < ns:
                            ns, ns_name = int(arr[ii]), nm
                p = min(nr, nrp, ns)
                if p >= n:
                    break
                if nr == p:                       # segment rotation
                    pos_, nm = rot[ri]
                    ri += 1
                    self._fill_planned_segment(plan, nm, final=False)
                    cursor = max(cursor, pos_)
                    if pool.write_blocked(nm):    # the rotating write stalls
                        self._advance_windows(windows, pos_, keys, kinds,
                                              plan, probe_map, dkeys,
                                              dbuckets, out_values)
                        stalls[nm] = stalls.get(nm, 0) + 1
                        pool.merge_budget(cap)
                    continue
                if ns == p:                       # stalled write
                    self._advance_windows(windows, p, keys, kinds, plan,
                                          probe_map, dkeys, dbuckets,
                                          out_values)
                    stalls[ns_name] = stalls.get(ns_name, 0) + 1
                    pool.merge_budget(cap)
                    cursor = p
                    continue
                # replicated-key op: exact generic path at its position
                self._advance_windows(windows, p - 1, keys, kinds, plan,
                                      probe_map, dkeys, dbuckets,
                                      out_values)
                if self._jit is not None:
                    # rep ops touch caches through the scalar paths:
                    # scatter device-resident state back first
                    self._jit.sync_all()
                self._exec_rep_op(p, kinds, keys, kn_ids, names, plan,
                                  dkeys, out_values)
                si += 1
                cursor = max(cursor, p)
            self._advance_windows(windows, n - 1, keys, kinds, plan,
                                  probe_map, dkeys, dbuckets, out_values)
        finally:
            if self._jit is not None:
                self._jit.end_batch()
            pool.untrack_merge_dirty()

        # ----- finalize -----------------------------------------------------
        for nm in plan.segq:
            self._fill_planned_segment(plan, nm, final=True)
        for nm, c in stalls.items():
            self.kns[nm].stats.write_stalls += c
        nw = plan.nw
        if nw:
            vs = self.versions
            uk, uc = np.unique(plan.wkeys, return_counts=True)
            for k, c in zip(uk.tolist(), uc.tolist()):
                vs[k] = vs.get(k, 0) + c
            self._seq += nw
        cnt = np.bincount(kn_ids[exec_mask], minlength=len(names))
        per_kn = {names[j]: int(cnt[j]) for j in np.nonzero(cnt)[0]}
        # scalar loops count refused writes too (the write() call refuses
        # after the attempt is recorded by the caller)
        writes = nw + int((kinds[refused_mask] != 0).sum())
        return BatchResult(int(exec_mask.sum()), writes, per_kn,
                           keys[exec_mask], out_values)

    def _build_write_plan(self, kinds, keys, kn_ids, live, names, value,
                          values, req_ids=None) -> "_WritePlan":
        """Stage every live write's log append up front: one bulk heap
        extension in global write order (pointer values are observable,
        so allocation order must match the per-op sequence) with the
        owning segments pre-assigned, vectorized amortized-flush RTs
        from each KN's pending-flush counter, and the rotation schedule
        (purely count-based, hence exact). Segment *entries* are filled
        lazily -- a segment's entries land when it rotates (or at batch
        end for the final partial segment), which is exactly when the
        per-op path would have completed them; filling earlier would
        inflate unmerged_count and distort the write-stall cadence."""
        pool = self.pool
        plan = _WritePlan()
        wpos = np.nonzero(live & (kinds != 0))[0]
        nw = int(wpos.size)
        plan.nw = nw
        if nw == 0:
            return plan
        wkeys = keys[wpos]
        wkn = kn_ids[wpos]
        wdel = kinds[wpos] == 2
        vb = self.value_bytes
        del_l = wdel.tolist()
        vals = [None if d else self._value_at(p, value, values)
                for p, d in zip(wpos.tolist(), del_l)]
        lens = [0 if d else vb for d in del_l]
        base = pool.alloc_values_batch(vals, lens)
        ptrs = base + np.arange(nw, dtype=np.int64)
        rts = np.zeros(nw, np.float64)
        cap = pool.segment_capacity
        hs = pool.heap_seg
        rotations = []
        for j in np.unique(wkn):
            nm = names[int(j)]
            kn = self.kns[nm]
            sel = np.nonzero(wkn == j)[0]
            m = sel.size
            seq = np.arange(1, m + 1)
            flags = (kn._pending_flush + seq) % kn.write_batch == 0
            r = flags.astype(np.float64)
            fp = pool.faults
            if fp is not None and fp.drop_flush_rt_rate > 0.0:
                # dropped flush acks: one retry RT per dropped flush
                # (draw order is per-KN here vs per-op in the scalar
                # loop, so fault runs are not bit-equivalent -- rate 0
                # consumes no randomness and stays exact)
                nf = int(flags.sum())
                if nf:
                    r[flags] += fp.drop_flush_mask(nf)
            rts[sel] = r
            kn._pending_flush = (kn._pending_flush + m) % kn.write_batch
            logical = np.where(wdel[sel], -wkeys[sel] - 1, wkeys[sel])
            pl = ptrs[sel].tolist()
            rq = [-1] * m if req_ids is None \
                else req_ids[wpos[sel]].tolist()
            # segment ranges: the active segment takes the first
            # cap - c0 staged entries, fresh segments take cap each
            active = pool.segments[nm][-1]
            if len(active.entries) >= cap:
                # defensively rotate a full active segment (log_write
                # and the event loop never leave one, but an external
                # caller could) -- mirrors fill_segments_batch
                pool.merge_backlog.append((active, 0))
                active = pool.new_segment(nm)
                pool.segments[nm].append(active)
                pool.gc.segments_created += 1
            c0 = len(active.entries)
            segq: list[tuple] = []
            lo = 0
            seg = active
            while True:
                hi_ = min(lo + (cap if lo else cap - c0), m)
                segq.append((seg, lo, hi_))
                for p in pl[lo:hi_]:
                    hs[p] = seg
                lo = hi_
                if lo >= m:
                    break
                seg = pool.new_segment(nm)
            rotm = (c0 + seq) % cap == 0
            rpos = wpos[sel][rotm]
            # every full range in segq corresponds to one rotation
            assert int(rotm.sum()) == sum(
                1 for s, a, b in segq
                if b - a == (cap if a else cap - c0))
            rotations.extend(zip(rpos.tolist(), itertools.repeat(nm)))
            plan.segq[nm] = segq
            plan.rot_done[nm] = 0
            plan.staged[nm] = (logical.tolist(), pl, rq)
            plan.wpos_by_name[nm] = wpos[sel]
        rotations.sort(key=lambda t: t[0])
        plan.rotations = rotations
        plan.ptrs = ptrs
        plan.rts = rts
        plan.wkeys = wkeys
        wrank = np.full(keys.shape[0], -1, np.int64)
        wrank[wpos] = np.arange(nw)
        plan.wrank = wrank
        # list mirrors for the per-op window loops (python list indexing
        # beats numpy scalar indexing in the short-run regime)
        plan.ptrs_l = ptrs.tolist()
        plan.rts_l = rts.tolist()
        plan.wrank_l = wrank.tolist()
        return plan

    def _fill_planned_segment(self, plan, nm, final: bool) -> None:
        """Land a planned segment's staged entries. ``final=False``:
        the segment just rotated -- fill it to capacity, enqueue it for
        async merge, and install the next planned (or a fresh) segment
        as the KN's active one, exactly as per-op log_write would have.
        ``final=True``: the batch is over -- fill the partial tail."""
        pool = self.pool
        k = plan.rot_done.get(nm, 0)
        segq = plan.segq.get(nm)
        if segq is None or k >= len(segq):
            return
        seg, lo, hi = segq[k]
        g = pool._gen_of(nm, self.kns[nm].fence_token)
        fp = pool.faults
        if fp is not None and fp.armed and hi > lo:
            j = fp.take_crash(CRASH_POINTS.LOG_PRE_SEAL, nm, hi - lo)
            if j is not None:
                # j staged entries of this fill sealed; the (j+1)-th
                # landed torn (its seal byte never made it to DPM)
                lk, pl, rq = plan.staged[nm]
                seg.entries.extend(zip(lk[lo:lo + j + 1],
                                       pl[lo:lo + j + 1]))
                seg.sealed.extend([True] * j + [False])
                seg.reqs.extend(rq[lo:lo + j + 1])
                seg.gens.extend([g] * (j + 1))
                seg.valid += j + 1
                # only the sealed prefix durably applied; the torn
                # entry's request stays unregistered so its retry lands
                pool.register_reqs(rq[lo:lo + j], pl[lo:lo + j])
                raise KNCrash(nm, CRASH_POINTS.LOG_PRE_SEAL)
        if not final:
            lk, pl, rq = plan.staged[nm]
            seg.entries.extend(zip(lk[lo:hi], pl[lo:hi]))
            seg.sealed.extend([True] * (hi - lo))
            seg.reqs.extend(rq[lo:hi])
            seg.gens.extend([g] * (hi - lo))
            seg.valid += hi - lo
            pool.register_reqs(rq[lo:hi], pl[lo:hi])
            plan.rot_done[nm] = k + 1
            if fp is not None and fp.armed and \
                    fp.take_crash(CRASH_POINTS.LOG_ROTATION, nm, 1) is not None:
                # the filled segment sealed but was never published to
                # the shared merge backlog; recovery must rediscover it
                raise KNCrash(nm, CRASH_POINTS.LOG_ROTATION)
            pool.merge_backlog.append((seg, 0))
            nxt = segq[k + 1][0] if k + 1 < len(segq) \
                else pool.new_segment(nm)
            pool.segments[nm].append(nxt)
            pool.gc.segments_created += 1
            return
        # batch end: the remaining range (if any) is the partial tail
        if hi > lo:
            lk, pl, rq = plan.staged[nm]
            seg.entries.extend(zip(lk[lo:hi], pl[lo:hi]))
            seg.sealed.extend([True] * (hi - lo))
            seg.reqs.extend(rq[lo:hi])
            seg.gens.extend([g] * (hi - lo))
            seg.valid += hi - lo
            pool.register_reqs(rq[lo:hi], pl[lo:hi])
            plan.rot_done[nm] = k + 1

    # ----- window processing -----------------------------------------------
    def _advance_windows(self, windows, hi, keys, kinds, plan, probe_map,
                         dkeys, dbuckets, out_values) -> None:
        if self._engine == "jit":
            self._advance_jit(windows, hi, keys, kinds, plan, probe_map,
                              dkeys, dbuckets, out_values)
            return
        for w in windows:
            pos = w.pos
            if w.idx < pos.size and pos[w.idx] <= hi:
                self._run_window(w, hi, keys, kinds, plan, probe_map,
                                 dkeys, dbuckets, out_values)

    def _advance_jit(self, windows, hi, keys, kinds, plan, probe_map,
                     dkeys, dbuckets, out_values) -> None:
        """The jit engine's advance: every ArrayDAC KN's window up to
        ``hi`` runs as a generator of device dispatches
        (``JitEngine.run_window``), and ``JitEngine.advance`` gathers one
        dispatch of each into one kernel-E launch until all are done;
        folds, cuts and host replays run per KN in KN order between the
        launches. Exact because no KN's window reads what another's
        writes inside one advance: caches, segment caches and stats are
        per KN; the write plan, the probe map and the pool's index and
        dirty sets change only outside the windows (replicated-key ops
        and stall merges run between advances)."""
        eng = self._jit
        if eng is None:
            from .jit_engine import JitEngine
            eng = self._jit = JitEngine(self)
        args = (keys, kinds, plan, probe_map, dkeys, dbuckets, out_values)
        steps = []
        for w in windows:
            pos = w.pos
            if not (w.idx < pos.size and pos[w.idx] <= hi):
                continue
            if not w.is_dac:
                self._run_window(w, hi, *args)
                continue
            i0 = w.idx
            i1 = int(np.searchsorted(pos, hi, side="right"))
            w.idx = i1
            full = pos[i0:i1]
            steps.append((w, eng.run_window(w, full, *args), full))
        eng.advance(steps, lambda w, full: self._host_window(w, full, *args))

    def _run_window(self, w, hi, keys, kinds, plan, probe_map, dkeys,
                    dbuckets, out_values) -> None:
        """One KN's ops in (last window end, hi], in order.

        Plan phase first: the whole window's transitions are planned as
        arrays (core.transition) and applied in bulk through the
        cache's apply_plan.  Windows the planner cannot prove replay
        through the exact per-op machinery below: classify the span
        with one kind-gather, split into maximal same-class runs, apply
        vectorizable runs in bulk (re-validated against the live cache
        at run boundaries), drop to the exact scalar op otherwise."""
        with sanitize.owned(w.kn.name):
            self._run_window_at(w, hi, keys, kinds, plan, probe_map,
                                dkeys, dbuckets, out_values)

    def _run_window_at(self, w, hi, keys, kinds, plan, probe_map, dkeys,
                       dbuckets, out_values) -> None:
        pos = w.pos
        i0 = w.idx
        i1 = int(np.searchsorted(pos, hi, side="right"))
        if i1 <= i0:
            return
        w.idx = i1
        self._host_window(w, pos[i0:i1], keys, kinds, plan, probe_map,
                          dkeys, dbuckets, out_values)

    def _host_window(self, w, full, keys, kinds, plan, probe_map, dkeys,
                     dbuckets, out_values) -> None:
        """The host engine on one KN's ops ``full`` (global positions),
        in order (also the jit engine's fallback for a window it
        declines: the int32 guards, a short window)."""
        kn, cache = w.kn, w.cache
        is_dac = w.is_dac
        planner = plan_dac_window if is_dac else \
            (plan_static_window if w.is_static else None)
        collect = out_values is not None
        start = 0
        n_all = full.size
        while start < n_all:
            span = full[start:] if start else full
            skeys = keys[span]
            sops = kinds[span]
            if planner is not None and span.size >= 48 \
                    and not sops.any():
                kdq = cache.kind[skeys]
                oddballs = int((kdq != 2).sum())
                if oddballs == 0:
                    # pure value-hit window (the high-skew read-only
                    # regime): one bulk scatter, no planning overhead
                    PLAN_STATS["planned_windows"] += 1
                    PLAN_STATS["planned_ops"] += int(span.size)
                    self._vh_run_big(kn, cache, span, skeys, probe_map,
                                     dkeys, dbuckets, out_values)
                    return
                if oddballs * 32 < span.size:
                    # hit-dominated read window: the run machinery's
                    # bulk value-hit path beats planning overhead
                    PLAN_STATS["replayed_windows"] += 1
                    PLAN_STATS["replayed_ops"] += int(span.size)
                    self._replay_span(kn, cache, is_dac, span, skeys,
                                      sops, plan, probe_map, dkeys,
                                      dbuckets, out_values)
                    return
            # bounded planning chunks: the planner truncates itself at
            # the first op it cannot prove (wp.ops tells how far it
            # got), so planning work stays linear in the window
            end = min(span.size, 512)
            t0 = perf_counter()
            wp = planner(cache, kn, skeys[:end], sops[:end], span[:end],
                         plan, probe_map, dkeys, dbuckets, self.pool,
                         self.value_bytes, collect) \
                if planner is not None else None
            ENGINE_WALL["host_plan"] += perf_counter() - t0
            if wp is not None:
                end = wp.ops
                PLAN_STATS["planned_windows"] += 1
                PLAN_STATS["planned_ops"] += end
                self._apply_window_plan(kn, cache, wp, out_values)
            else:
                PLAN_STATS["replayed_windows"] += 1
                PLAN_STATS["replayed_ops"] += end
                self._replay_span(kn, cache, is_dac, span[:end],
                                  skeys[:end], sops[:end], plan,
                                  probe_map, dkeys, dbuckets,
                                  out_values)
            start += end

    def _replay_span(self, kn, cache, is_dac, span, skeys, sops, plan,
                     probe_map, dkeys, dbuckets, out_values) -> None:
        """Exact per-op replay of one span: classify with one
        kind-gather, split into maximal same-class runs, apply
        vectorizable runs in bulk (re-validated against the live cache
        at run boundaries), drop to the exact scalar op otherwise."""
        t0_wall = perf_counter()
        cls = np.where(sops == 0, cache.kind[skeys],
                       np.where(sops == 1, np.int8(3), np.int8(4)))
        m = span.size
        bnd = np.nonzero(cls[1:] != cls[:-1])[0] + 1
        starts = (0, *bnd.tolist())
        ends = (*bnd.tolist(), m)
        cls_l = cls.tolist()
        span_l = keys_l = None
        for s, e in zip(starts, ends):
            c = cls_l[s]
            if c == 2 and e - s >= 48:
                # a long value-hit run stays in numpy end to end
                self._vh_run_big(kn, cache, span[s:e], skeys[s:e],
                                 probe_map, dkeys, dbuckets, out_values)
                continue
            if span_l is None:
                span_l = span.tolist()
                keys_l = skeys.tolist()
            if c == 2:
                if is_dac:
                    self._vh_run(kn, cache, span_l[s:e], keys_l[s:e],
                                 probe_map, dkeys, dbuckets, out_values)
                else:
                    self._hit_run_static(kn, cache, span_l[s:e],
                                         keys_l[s:e], c, probe_map,
                                         dkeys, dbuckets, out_values)
            elif c == 1:
                if is_dac:
                    self._sc_run(kn, cache, span_l[s:e], keys_l[s:e],
                                 probe_map, dkeys, dbuckets, out_values)
                else:
                    self._hit_run_static(kn, cache, span_l[s:e],
                                         keys_l[s:e], c, probe_map,
                                         dkeys, dbuckets, out_values)
            elif c >= 3:
                if is_dac:
                    self._write_run(kn, cache, span_l[s:e], keys_l[s:e],
                                    c == 4, plan, out_values)
                else:
                    self._write_run_generic(kn, cache, span_l[s:e],
                                            keys_l[s:e], c == 4, plan,
                                            out_values)
            else:
                # predicted misses: exact scalar ops
                for p_, k in zip(span_l[s:e], keys_l[s:e]):
                    self._scalar_read_dac(kn, cache, k, p_, probe_map,
                                          dkeys, dbuckets, out_values)
        ENGINE_WALL["host_replay"] += perf_counter() - t0_wall

    def _apply_window_plan(self, kn, cache, wp, out_values) -> None:
        """Apply a planned window (``apply_window_plan``), timed into
        ENGINE_WALL's host_apply."""
        t0_wall = perf_counter()
        apply_window_plan(kn, cache, wp, out_values, self.value_bytes)
        ENGINE_WALL["host_apply"] += perf_counter() - t0_wall

    def _vh_run(self, kn, cache, run_pos, run_keys, probe_map, dkeys,
                dbuckets, out_values) -> None:
        """A short run of predicted value hits: hit bookkeeping applied
        inline, with the live entry kind re-checked per op (an earlier
        op in the window may have moved a key); mispredictions take the
        exact scalar path in order."""
        kindarr = cache.kind
        heap = self.pool.heap_val
        st = kn.stats
        cnt = cache.count
        stp = cache.stamp
        ptr_l = cache.ptr
        clock = cache._clock
        if cache._dirty is not None:
            cache._dirty.extend(run_keys)
        collect = out_values is not None
        hits = 0
        for i in range(len(run_keys)):
            k = run_keys[i]
            if kindarr[k] != 2:
                cache._clock = clock
                self._scalar_read_dac(kn, cache, k, run_pos[i],
                                      probe_map, dkeys, dbuckets,
                                      out_values)
                clock = cache._clock
                continue
            cnt[k] += 1
            stp[k] = clock
            clock += 1
            hits += 1
            if collect:
                out_values[run_pos[i]] = heap[ptr_l[k]]
        cache._clock = clock
        cache.stats.value_hits += hits
        st.ops += hits
        st.reads += hits

    def _vh_run_big(self, kn, cache, run_pos, run_keys, probe_map, dkeys,
                    dbuckets, out_values) -> None:
        """A long run of predicted value hits: bulk-apply through
        bulk_value_hits with one vectorized validation gather per
        sub-run; mispredictions take the exact scalar path in order."""
        kindarr = cache.kind
        heap = self.pool.heap_val
        st = kn.stats
        while run_keys.size:
            okm = kindarr[run_keys] == 2
            b = run_keys.size if okm.all() else int(np.argmax(~okm))
            if b:
                cache.bulk_value_hits(run_keys[:b])
                st.ops += b
                st.reads += b
                if out_values is not None:
                    ptr_l = cache.ptr
                    for p_, k in zip(run_pos[:b].tolist(),
                                     run_keys[:b].tolist()):
                        out_values[p_] = heap[ptr_l[k]]
            if b == run_keys.size:
                return
            self._scalar_read_dac(kn, cache, int(run_keys[b]),
                                  int(run_pos[b]), probe_map, dkeys,
                                  dbuckets, out_values)
            run_pos = run_pos[b + 1:]
            run_keys = run_keys[b + 1:]

    def _sc_run(self, kn, cache, run_pos, run_keys, probe_map, dkeys,
                dbuckets, out_values) -> None:
        """A run of predicted shortcut hits: the hit bookkeeping and the
        always-promoting Eq. 1 transition (free space, or enough
        never-hit shortcut victims -- the common case on warm caches)
        run inline over the cache's lazy heaps with run-local state
        mirrors; undecided promotions and mispredictions drop to the
        exact library path with the mirrors synced around the call."""
        heap = self.pool.heap_val
        st = kn.stats
        cs = cache.stats
        heappush, heappop = heapq.heappush, heapq.heappop
        kind_a = cache.kind
        cnt = cache.count
        lenl = cache.length
        ptrl = cache.ptr
        stp = cache.stamp
        cap = cache.capacity
        used = cache.used
        zshort = cache._zero_shortcuts
        nvals = cache._nvals
        nshort = cache._nshort
        clock = cache._clock
        lru = cache._lru
        lfu = cache._lfu
        hist = cache._cnt_hist
        hmax = CNT_HIST_MAX
        # the jit engine's record of written slots: the run's keys, and
        # each victim of the inline make-space below
        rec = cache._dirty
        if rec is not None:
            rec.extend(run_keys)
        nops = 0
        rts = 0.0
        shits = promos = demos = evics = 0
        collect = out_values is not None
        kl = run_keys
        pl_ = run_pos
        m = len(kl)
        i = 0
        while i < m:
            k = kl[i]
            if kind_a[k] != 1:
                # misprediction (an earlier op in this window moved the
                # key): sync mirrors, take the exact scalar path
                cache.used = used
                cache._zero_shortcuts = zshort
                cache._nvals = nvals
                cache._nshort = nshort
                cache._clock = clock
                self._scalar_read_dac(kn, cache, k, pl_[i], probe_map,
                                      dkeys, dbuckets, out_values)
                used = cache.used
                zshort = cache._zero_shortcuts
                nvals = cache._nvals
                nshort = cache._nshort
                clock = cache._clock
                lru = cache._lru
                lfu = cache._lfu
                i += 1
                continue
            c = cnt[k] + 1
            cnt[k] = c
            if c == 1:
                zshort -= 1
            hist[c - 1 if c <= hmax else hmax] -= 1
            hist[c if c < hmax else hmax] += 1
            shits += 1
            nops += 1
            rts += 1.0          # one-sided pointer chase
            if collect:
                out_values[pl_[i]] = heap[ptrl[k]]
            i += 1
            # Eq. 1 fast decision (exact: sufficient conditions)
            ln = lenl[k]
            vb = ln + 40        # VALUE_OVERHEAD_BYTES
            free = cap - used
            if free >= vb - 32:
                promote = True
            elif zshort >= -((free - vb + 32) // 32):
                promote = True  # victims all free: Eq. 1 rhs 0
            else:
                promote = None  # undecided: exact slow path
            if promote is None:
                cache.used = used
                cache._zero_shortcuts = zshort
                cache._nvals = nvals
                cache._nshort = nshort
                cache._clock = clock
                if cache._should_promote(k, c, ln):
                    cache._promote(k)
                    cs.promotions += 1
                used = cache.used
                zshort = cache._zero_shortcuts
                nvals = cache._nvals
                nshort = cache._nshort
                clock = cache._clock
                lru = cache._lru
                lfu = cache._lfu
                continue
            # ---- inline promote: shortcut -> value (Table 3) ----
            promos += 1
            kind_a[k] = 0
            used -= 32
            nshort -= 1
            hist[c if c < hmax else hmax] -= 1
            if used + vb > cap:
                # make space: demote LRU values, then evict LFU
                while used + vb > cap and nvals:
                    if len(lru) > 4 * nvals + 64:
                        cache._compact_lru()
                        lru = cache._lru
                    v = None
                    while lru:
                        st_, kk = heappop(lru)
                        if kind_a[kk] != 2:
                            continue               # stale: drop
                        cur = stp[kk]
                        if cur != st_:
                            heappush(lru, (cur, kk))   # refresh
                            continue
                        v = kk
                        break
                    if v is None:
                        break
                    if rec is not None:
                        rec.add(v)
                    used -= lenl[v] + 40
                    nvals -= 1
                    kind_a[v] = 0
                    demos += 1
                    if used + 32 + vb <= cap:
                        cv = cnt[v]
                        kind_a[v] = 1
                        heappush(lfu, (cv, v))
                        used += 32
                        nshort += 1
                        if cv == 0:
                            zshort += 1
                        hist[cv if cv < hmax else hmax] += 1
                while used + vb > cap and nshort:
                    if len(lfu) > 4 * nshort + 64:
                        cache._compact_lfu()
                        lfu = cache._lfu
                    v = None
                    while lfu:
                        ct_, kk = heappop(lfu)
                        if kind_a[kk] != 1:
                            continue
                        cur = cnt[kk]
                        if cur != ct_:
                            heappush(lfu, (cur, kk))
                            continue
                        v = kk
                        break
                    if v is None:
                        break
                    if rec is not None:
                        rec.add(v)
                    cv = cnt[v]
                    kind_a[v] = 0
                    used -= 32
                    nshort -= 1
                    if cv == 0:
                        zshort -= 1
                    hist[cv if cv < hmax else hmax] -= 1
                    evics += 1
            if used + vb > cap:
                # degenerate: cannot fit the value even after
                # demotions/evictions -> falls back to a shortcut
                # entry, exactly as _insert_value
                if used + 32 <= cap:
                    kind_a[k] = 1
                    heappush(lfu, (c, k))
                    used += 32
                    nshort += 1
                    hist[c if c < hmax else hmax] += 1
            else:
                kind_a[k] = 2
                stp[k] = clock
                # monotonic stamps exceed every record in the heap, so
                # appending keeps the heap invariant (O(1) vs O(log n))
                lru.append((clock, k))
                clock += 1
                used += vb
                nvals += 1
        cache.used = used
        cache._zero_shortcuts = zshort
        cache._nvals = nvals
        cache._nshort = nshort
        cache._clock = clock
        cs.shortcut_hits += shits
        cs.promotions += promos
        cs.demotions += demos
        cs.evictions += evics
        st.ops += nops
        st.reads += nops
        st.rts += rts

    def _scalar_read_dac(self, kn, cache, k, p, probe_map, dkeys, dbuckets,
                         out_values) -> None:
        """One exact non-replicated read against an ArrayDAC KN --
        read() minus routing, with the batched probe prefetch in place
        of the live index traversal when still provably fresh."""
        pool = self.pool
        st = kn.stats
        st.ops += 1
        st.reads += 1
        rts = 0.0
        value = None
        hit = cache.lookup(k)
        if hit is not None:
            kind, ptr, _len = hit
            if kind != "value":
                rts = 1.0                          # one-sided pointer chase
            value = pool.heap_val[ptr]
        else:
            seg = kn.segcache.get(k)
            if seg is not None:
                ptr, length = seg
                value = pool.heap_val[ptr]         # local segment: 0 RTs
                cache.fill_after_write(k, ptr, length, segment_cached=True)
            else:
                pr = probe_map.get(p)
                if pr is None or k in dkeys or pr[2] in dbuckets:
                    ptr, probes = pool.index_lookup(k)
                else:
                    ptr, probes = pr[0], pr[1]
                if ptr is None:
                    st.rts += probes               # index traversal only
                    return
                rts = probes + 1.0                 # traversal + value fetch
                cache.note_miss_rts(rts)
                cache.fill_after_miss(k, ptr, pool.heap_len[ptr])
                value = pool.heap_val[ptr]
        st.rts += rts
        if out_values is not None:
            out_values[p] = value

    def _write_run(self, kn, cache, run_pos, run_keys, delete, plan,
                   out_values) -> None:
        """A run of same-KN writes: the log plane is already staged
        (pointers, flush RTs, segment entries), leaving the segcache
        update and the cache fill -- fill_after_write(segment_cached)
        inlined over the run-local state mirrors (value entry when it
        fits, else a shortcut with the full demote-LRU/evict-LFU
        make-space loop, exactly as the library path)."""
        st = kn.stats
        nrun = len(run_pos)
        st.ops += nrun
        st.writes += nrun
        wrank_l = plan.wrank_l
        rts_l = plan.rts_l
        ptrs_l = plan.ptrs_l
        segd = kn.segcache
        if delete:
            rts = 0.0
            for p_, k in zip(run_pos, run_keys):
                rts += rts_l[wrank_l[p_]]
                cache.invalidate(k)
                segd.pop(k, None)
            st.rts += rts
            return
        segcap = kn.segcache_cap
        vbytes = self.value_bytes
        vbb = vbytes + 40              # VALUE_OVERHEAD_BYTES
        heappush, heappop = heapq.heappush, heapq.heappop
        kind_a = cache.kind
        cnt = cache.count
        lenl = cache.length
        ptrl = cache.ptr
        stp = cache.stamp
        cap = cache.capacity
        used = cache.used
        zshort = cache._zero_shortcuts
        nvals = cache._nvals
        nshort = cache._nshort
        clock = cache._clock
        lru = cache._lru
        lfu = cache._lfu
        hist = cache._cnt_hist
        hmax = CNT_HIST_MAX
        rec = cache._dirty          # the jit engine's record, as _sc_run
        if rec is not None:
            rec.extend(run_keys)
        demos = evics = 0
        rts = 0.0
        for p_, k in zip(run_pos, run_keys):
            ptr = ptrs_l[wrank_l[p_]]
            rts += rts_l[wrank_l[p_]]
            segd[k] = (ptr, vbytes)
            segd.move_to_end(k)
            while len(segd) > segcap:
                segd.popitem(last=False)
            # ---- fill_after_write(k, ptr, vbytes, segment_cached) ----
            kd = kind_a[k]
            if kd == 0:
                cpri = 0
            elif kd == 1:
                cpri = cnt[k]
                kind_a[k] = 0
                used -= 32
                nshort -= 1
                if cpri == 0:
                    zshort -= 1
                hist[cpri if cpri < hmax else hmax] -= 1
            else:
                cpri = cnt[k]
                kind_a[k] = 0
                used -= lenl[k] + 40
                nvals -= 1
            if used + vbb <= cap:
                # the value entry fits: insert, no space-making needed
                kind_a[k] = 2
                ptrl[k] = ptr
                lenl[k] = vbytes
                cnt[k] = cpri
                stp[k] = clock
                # monotonic stamp: plain append keeps the heap invariant
                lru.append((clock, k))
                clock += 1
                used += vbb
                nvals += 1
                continue
            # shortcut entry: _make_space(32), demote-first (Table 3)
            while used + 32 > cap and nvals:
                if len(lru) > 4 * nvals + 64:
                    cache._compact_lru()
                    lru = cache._lru
                v = None
                while lru:
                    st_, kk = heappop(lru)
                    if kind_a[kk] != 2:
                        continue                   # stale: drop
                    cur = stp[kk]
                    if cur != st_:
                        heappush(lru, (cur, kk))   # refresh
                        continue
                    v = kk
                    break
                if v is None:
                    break
                if rec is not None:
                    rec.add(v)
                used -= lenl[v] + 40
                nvals -= 1
                kind_a[v] = 0
                demos += 1
                if used + 32 + 32 <= cap:
                    cv = cnt[v]
                    kind_a[v] = 1
                    heappush(lfu, (cv, v))
                    used += 32
                    nshort += 1
                    if cv == 0:
                        zshort += 1
                    hist[cv if cv < hmax else hmax] += 1
            while used + 32 > cap and nshort:
                if len(lfu) > 4 * nshort + 64:
                    cache._compact_lfu()
                    lfu = cache._lfu
                v = None
                while lfu:
                    ct_, kk = heappop(lfu)
                    if kind_a[kk] != 1:
                        continue
                    cur = cnt[kk]
                    if cur != ct_:
                        heappush(lfu, (cur, kk))
                        continue
                    v = kk
                    break
                if v is None:
                    break
                if rec is not None:
                    rec.add(v)
                cv = cnt[v]
                kind_a[v] = 0
                used -= 32
                nshort -= 1
                if cv == 0:
                    zshort -= 1
                hist[cv if cv < hmax else hmax] -= 1
                evics += 1
            if used + 32 <= cap:
                kind_a[k] = 1
                ptrl[k] = ptr
                lenl[k] = vbytes
                cnt[k] = cpri
                heappush(lfu, (cpri, k))
                used += 32
                nshort += 1
                if cpri == 0:
                    zshort += 1
                hist[cpri if cpri < hmax else hmax] += 1
            # else: cache smaller than one entry: degenerate, skip
        st.rts += rts
        cache.used = used
        cache._zero_shortcuts = zshort
        cache._nvals = nvals
        cache._nshort = nshort
        cache._clock = clock
        cs = cache.stats
        cs.demotions += demos
        cs.evictions += evics

    def _hit_run_static(self, kn, cache, run_pos, run_keys, kd, probe_map,
                        dkeys, dbuckets, out_values) -> None:
        """A run of predicted static-cache hits (value or shortcut):
        each hit is a recency bump (+1 RT for shortcuts), re-validated
        per op; mispredictions take the exact scalar path."""
        kindarr = cache.kind
        heap = self.pool.heap_val
        st = kn.stats
        stp = cache.stamp
        ptr_l = cache.ptr
        clock = cache._clock
        collect = out_values is not None
        hits = 0
        for i in range(len(run_keys)):
            k = run_keys[i]
            if kindarr[k] != kd:
                cache._clock = clock
                self._scalar_read_dac(kn, cache, k, run_pos[i],
                                      probe_map, dkeys, dbuckets,
                                      out_values)
                clock = cache._clock
                continue
            stp[k] = clock
            clock += 1
            hits += 1
            if collect:
                out_values[run_pos[i]] = heap[ptr_l[k]]
        cache._clock = clock
        st.ops += hits
        st.reads += hits
        if kd == 2:
            cache.stats.value_hits += hits
        else:
            cache.stats.shortcut_hits += hits
            st.rts += float(hits)          # one-sided pointer chase each

    def _write_run_generic(self, kn, cache, run_pos, run_keys, delete,
                           plan, out_values) -> None:
        """A run of same-KN writes against a non-DAC cache: staged log
        plane + segcache update + the library fill per op."""
        st = kn.stats
        nrun = len(run_pos)
        st.ops += nrun
        st.writes += nrun
        wrank_l = plan.wrank_l
        rts_l = plan.rts_l
        ptrs_l = plan.ptrs_l
        segd = kn.segcache
        rts = 0.0
        if delete:
            for p_, k in zip(run_pos, run_keys):
                rts += rts_l[wrank_l[p_]]
                cache.invalidate(k)
                segd.pop(k, None)
            st.rts += rts
            return
        segcap = kn.segcache_cap
        vb = self.value_bytes
        for p_, k in zip(run_pos, run_keys):
            r = wrank_l[p_]
            ptr = ptrs_l[r]
            rts += rts_l[r]
            segd[k] = (ptr, vb)
            segd.move_to_end(k)
            while len(segd) > segcap:
                segd.popitem(last=False)
            cache.fill_after_write(k, ptr, vb, segment_cached=True)
        st.rts += rts

    def _exec_rep_op(self, p, kinds, keys, kn_ids, names, plan, dkeys,
                     out_values) -> None:
        """One replicated-key op at its exact global position (the
        indirection slot is shared across owners, so these synchronize
        globally): reads take the generic read() path; writes replay
        write()'s indirection CAS against the staged log pointer."""
        k = int(keys[p])
        kn = self.kns[names[int(kn_ids[p])]]
        if kinds[p] == 0:
            r = self.read(k, kn.name)
            if out_values is not None:
                out_values[p] = r[0]
            return
        delete = kinds[p] == 2
        st = kn.stats
        st.ops += 1
        st.writes += 1
        rank = int(plan.wrank[p])
        rts = float(plan.rts[rank])
        ptr = int(plan.ptrs[rank])
        length = 0 if delete else self.value_bytes
        replicated = (self.variant.selective_replication
                      and self.ownership.is_replicated(k) and not delete)
        with sanitize.owned(kn.name):
            if replicated:
                # atomically swing the indirect pointer: one-sided CAS
                expect = self.pool.read_indirect(k)
                self.pool.cas_indirect(k, expect, ptr,
                                       kn=kn.name, token=kn.fence_token)
                rts += 1.0
                kn.cache.update_pointer(k, ptr, length)
                dkeys.add(k)   # index_lookup(k) now resolves differently
            elif delete:
                kn.cache.invalidate(k)
                kn.segcache.pop(k, None)
            else:
                kn._segcache_put(k, ptr, length)
                kn.cache.fill_after_write(k, ptr, length,
                                          segment_cached=True)
        st.rts += rts

    @staticmethod
    def _kn_groups(pos: np.ndarray, kn_ids: np.ndarray):
        """Split sorted global positions into per-KN groups (each group
        keeps ascending op order)."""
        if not pos.size:
            return
        ids = kn_ids[pos]
        order = np.argsort(ids, kind="stable")
        sp = pos[order]
        bounds = np.nonzero(np.diff(ids[order]))[0] + 1
        yield from np.split(sp, bounds)

    def _execute_batch_clover(self, kinds, keys, value, values,
                              blocked_kns, out_values,
                              req_ids=None) -> "BatchResult":
        """The batched Clover plane (shared-everything, version-chain
        cache): client routing draws the rng per op exactly as the
        scalar path, version-counter checks and shortcut fills run
        against the ArrayCloverCache, and the per-write merge-all
        (Clover updates metadata in place) is staged -- superseded
        pointers invalidate eagerly at their op position through a
        pending-index overlay, the CLHT bucket updates land once at
        batch end via the planned insert_batch (plan_merge_window ->
        apply_merge_plan, scalar replay past a plan's self-truncation
        point). Requires (and leaves)
        empty active logs; statistics are op-for-op identical to the
        per-op path (property-tested)."""
        # shared-everything: every KN serves (and stamps) any key, so
        # there is no ownership partition for the sanitizer to enforce
        with sanitize.management():
            return self._execute_batch_clover_at(
                kinds, keys, value, values, blocked_kns, out_values,
                req_ids)

    def _execute_batch_clover_at(self, kinds, keys, value, values,
                                 blocked_kns, out_values,
                                 req_ids=None) -> "BatchResult":
        pool = self.pool
        versions = self.versions
        heap = pool.heap_val
        heap_len = pool.heap_len
        heap_seg = pool.heap_seg
        gc = pool.gc
        kns = self.kns
        names = [n for n, k in kns.items() if k.alive]
        n = keys.shape[0]
        if not names:
            return BatchResult(0, 0, {}, keys[:0], out_values)
        choice = self.rng.choice
        kn_names = [choice(names) for _ in range(n)]
        blocked = set(blocked_kns)
        ptr0, _probes = pool.index_lookup_batch(keys)
        if not kinds.any():
            res = self._clover_read_batch(keys, kn_names, names, blocked,
                                          ptr0, out_values)
            if res is not None:
                return res
        ptr0_l = ptr0.tolist()
        keys_l = keys.tolist()
        kinds_l = kinds.tolist()
        vb = self.value_bytes
        cap = pool.segment_capacity
        collect = out_values is not None
        pend: dict[int, int] = {}      # key -> latest in-batch ptr (-1 del)
        wrote: set[str] = set()
        per_kn: dict[str, int] = {}
        exec_idx: list[int] = []
        writes = 0
        ms = 0
        vbump = 0                      # index.version bumps the per-op
        v0 = pool.index.version        # sequence would have made
        for i in range(n):
            nm = kn_names[i]
            if nm in blocked:
                continue
            k = keys_l[i]
            kn = kns[nm]
            exec_idx.append(i)
            per_kn[nm] = per_kn.get(nm, 0) + 1
            st = kn.stats
            if not kn.available:
                st.refused += 1
                if kinds_l[i]:
                    writes += 1
                continue
            cache = kn.cache
            if kinds_l[i] == 0:
                # ---- _clover_read, staged index ----
                st.ops += 1
                st.reads += 1
                cur = versions.get(k, 0)
                cached = cache.lookup(k)
                rts = 0.0
                if cached is None:
                    ms += 1            # two-sided RPC to metadata server
                    rts = 1.0
                p_ = pend.get(k, ptr0_l[i])
                if p_ < 0:
                    st.rts += rts
                    continue
                stale = cur - cached \
                    if cached is not None and cur > cached else 0
                # walk the version chain from the cached cursor
                rts += 2.0 + stale
                with sanitize.owned(kn.name):
                    cache.fill(k, cur)
                if collect:
                    out_values[i] = heap[p_]
                st.rts += rts
                continue
            # ---- _clover_write + staged merge-all ----
            writes += 1
            delete = kinds_l[i] == 2
            st.ops += 1
            st.writes += 1
            length = 0 if delete else vb
            ptr = len(heap)
            heap.append(None if delete
                        else self._value_at(i, value, values))
            heap_len.append(length)
            seg = pool.new_segment(nm)
            seg.entries.append((-k - 1 if delete else k, ptr))
            seg.sealed.append(True)
            rid = -1 if req_ids is None else int(req_ids[i])
            seg.reqs.append(rid)
            seg.gens.append(pool.fence.get(nm, 0))
            if rid >= 0:
                pool.req_index[rid] = ptr
            seg.valid = 1
            seg.merged_upto = 1
            heap_seg.append(seg)
            wrote.add(nm)
            gc.entries_merged += 1     # Clover merges each write in place
            old = pend.get(k)
            if old is None:
                old = ptr0_l[i]
            if delete:
                seg.valid -= 1         # tombstone consumes its own entry
                if old >= 0:
                    vbump += 1
                    pool._invalidate_ptr(old)
                pend[k] = -1
            else:
                vbump += 1
                if old >= 0 and old != ptr:
                    pool._invalidate_ptr(old)
                pend[k] = ptr
            versions[k] = versions.get(k, 0) + 1
            with sanitize.owned(kn.name):
                cache.fill(k, versions[k])
            st.rts += 2.0              # out-of-place append + link/CAS
        # land the final index state (grouped bucket update); superseded
        # pointers were invalidated at their op positions above
        if pend:
            ins = [(k, p) for k, p in pend.items() if p >= 0]
            if ins:
                ka = np.fromiter((k for k, _ in ins), np.int64, len(ins))
                pa = np.fromiter((p for _, p in ins), np.int64, len(ins))
                pool.index.insert_batch(ka, pa)
            for k, p in pend.items():
                if p < 0:
                    pool.index.delete(k)
            # align the version counter with the per-op merge cadence
            pool.index.version = v0 + vbump
        for nm in wrote:
            pool.segments[nm] = [pool.new_segment(nm)]
        self.ms_ops += ms
        idx = np.asarray(exec_idx, dtype=np.int64)
        return BatchResult(len(exec_idx), writes, per_kn, keys[idx],
                           out_values)

    def _clover_read_batch(self, keys, kn_names, names, blocked, ptr0,
                           out_values) -> "BatchResult | None":
        """Planned read-only Clover batch: each KN's slice of the batch
        is planned as one bulk cache transition (plan_clover_reads) and
        applied through ArrayCloverCache.apply_plan.  Returns None when
        any KN's plan could evict (the per-op loop then runs instead);
        nothing is mutated until every plan is in hand."""
        kns = self.kns
        versions = self.versions
        n = keys.shape[0]
        keys_l = keys.tolist()
        vget = versions.get
        vers = np.fromiter((vget(k, 0) for k in keys_l), np.int64, n)
        found = ptr0 >= 0
        idx = {nm: j for j, nm in enumerate(names)}
        kn_ids = np.fromiter(map(idx.__getitem__, kn_names), np.int64, n)
        bl = np.zeros(len(names), bool)
        un = np.zeros(len(names), bool)
        for j, nm in enumerate(names):
            bl[j] = nm in blocked
            un[j] = not kns[nm].available
        execm = ~bl[kn_ids]
        live = execm & ~un[kn_ids]
        plans = []
        for j, nm in enumerate(names):
            grp = np.flatnonzero(live & (kn_ids == j))
            if not grp.size:
                plans.append((nm, grp, None))
                continue
            wp = plan_clover_reads(kns[nm].cache, keys[grp], vers[grp],
                                   found[grp])
            if wp is None:
                return None
            plans.append((nm, grp, wp))
        ms = 0
        per_kn: dict[str, int] = {}
        for j, nm in enumerate(names):
            cnt = int(execm[kn_ids == j].sum())
            if cnt:
                per_kn[nm] = cnt
        for nm, grp, wp in plans:
            kn = kns[nm]
            st = kn.stats
            refused = int((execm & un[kn_ids] & (kn_ids == idx[nm]))
                          .sum())
            st.refused += refused
            if wp is None:
                continue
            with sanitize.owned(nm):
                kn.cache.apply_plan(wp)
            st.ops += int(grp.size)
            st.reads += int(grp.size)
            st.rts += wp.rts
            ms += wp.misses
            if out_values is not None:
                heap = self.pool.heap_val
                for p_, pt in zip(grp.tolist(), ptr0[grp].tolist()):
                    if pt >= 0:
                        out_values[p_] = heap[pt]
        self.ms_ops += ms
        eidx = np.flatnonzero(execm)
        return BatchResult(int(eidx.size), 0, per_kn, keys[eidx],
                           out_values)

    def _execute_batch_fused(self, kinds, keys, value, values, blocked_kns,
                             out_values, req_ids=None):
        blocked = set(blocked_kns)
        per_kn: dict[str, int] = {}
        writes = 0
        exec_idx = []
        read, write, route = self.read, self.write, self.route
        for i in range(keys.shape[0]):
            key = int(keys[i])
            try:
                kn = route(key)
            except KeyError:
                continue
            if kn in blocked:
                continue
            exec_idx.append(i)
            per_kn[kn] = per_kn.get(kn, 0) + 1
            rid = -1 if req_ids is None else int(req_ids[i])
            if kinds[i] == 0:
                r = read(key, kn)
                if out_values is not None:
                    out_values[i] = r[0]
            elif kinds[i] == 2:
                writes += 1
                write(key, None, kn, delete=True, req_id=rid)
            else:
                writes += 1
                write(key, self._value_at(i, value, values), kn,
                      req_id=rid)
        idx = np.asarray(exec_idx, dtype=np.int64)
        return BatchResult(len(exec_idx), writes, per_kn, keys[idx],
                           out_values)

    @staticmethod
    def _value_at(i: int, value, values):
        if values is None:
            return value
        if callable(values):
            return values(i)
        return values[i]

    def batch_read(self, keys, collect_values: bool = True):
        """Batched read entry point: returns (values, result)."""
        keys = np.asarray(keys, dtype=np.int64)
        res = self.execute_batch(np.zeros(keys.shape[0], np.uint8), keys,
                                 collect_values=collect_values)
        return res.values, res

    def batch_write(self, keys, values):
        """Batched write entry point: returns the BatchResult."""
        keys = np.asarray(keys, dtype=np.int64)
        return self.execute_batch(np.ones(keys.shape[0], np.uint8), keys,
                                  values=values)

    # ---------------------------------------------------------------------
    # background work + bookkeeping
    # ---------------------------------------------------------------------
    def advance_merge(self, ops: int) -> int:
        return self.pool.merge_budget(ops)

    def load(self, items, warm: bool = False) -> None:
        """Bulk-load the dataset (untimed, as in the paper's load phase).
        ``warm=True`` reproduces the load-through-KN effect: under OP the
        owner inserted every key it owns, so it holds a shortcut for
        free; under shared-everything each key was handled by one
        arbitrary KN. Where the per-key fills provably make no room (empty
        ArrayDACs, each owner's keys ascending and all fitting as
        shortcuts, no indirection slot), the warm-up runs in bulk, one
        ``warm_load`` an owner, to the same end state; otherwise (and for
        the baselines' caches) it runs key by key, as the reference."""
        items = list(items)
        self.pool.bulk_load((k, v, self.value_bytes) for k, v in items)
        if warm:
            self._warm([k for k, _ in items])

    def _warm(self, keys) -> None:
        """The warm-up of ``load(warm=True)`` over ``keys``, loaded."""
        with sanitize.management():     # warm load fills any KN's cache
            if not self._warm_bulk(keys):
                self._warm_per_key(keys)

    def _warm_per_key(self, keys) -> None:
        names = list(self.kns)
        for k in keys:
            ptr, _ = self.pool.index_lookup(k)
            if ptr is None:
                continue
            if self.variant.name == "clover":
                kn = self.kns[names[stable_hash(("load", k))
                                    % len(names)]]
                kn.cache.fill(k, self.versions.get(k, 0))
            else:
                owner = self.ownership.primary(k)
                self.kns[owner].cache.fill_after_write(
                    k, ptr, self.value_bytes, segment_cached=False)

    def _warm_bulk(self, keys) -> bool:
        """The per-key warm-up in bulk, or False (nothing touched) where
        its end state could differ: each owner's found keys must ascend
        (its LFU heap is then their list as pushed) and fit as shortcuts
        (no make-space), into an empty ArrayDAC."""
        caches = {nm: kn.cache for nm, kn in self.kns.items()}
        if not keys or self.pool.indirect or not all(
                isinstance(c, ArrayDAC) and not (c.used or c._nvals
                                                 or c._nshort)
                for c in caches.values()):
            return False
        keys = np.asarray(keys, np.int64)
        ptrs, _ = self.pool.index.lookup_batch(keys)
        found = ptrs >= 0
        keys, ptrs = keys[found], ptrs[found]
        ids, names = self.ownership.primary_ids(keys)
        plan = []
        for j, nm in enumerate(names):
            sel = ids == j
            ks = keys[sel]
            c = caches[nm]
            if (ks.size > 1 and not (np.diff(ks) > 0).all()) \
                    or ks.size * SHORTCUT_BYTES > c.capacity:
                return False
            plan.append((c, ks, ptrs[sel]))
        for c, ks, ps in plan:
            # grow the per-key vectors as the per-key fills would: each
            # key past the end doubles them (or reaches the key)
            while ks.size:
                i = int(np.searchsorted(ks, c.kind.shape[0]))
                if i == ks.size:
                    break
                c._ensure(int(ks[i]))
            warm_load(c, ks[:0], ps[:0], ks, ps, self.value_bytes)
        return True

    def aggregate_stats(self) -> dict:
        tot_ops = sum(k.stats.ops for k in self.kns.values())
        tot_rts = sum(k.stats.rts for k in self.kns.values())
        caches = [k.cache.stats for k in self.kns.values()
                  if hasattr(k.cache, "stats")]
        lookups = sum(c.lookups for c in caches)
        hits = sum(c.value_hits + c.shortcut_hits for c in caches)
        vhits = sum(c.value_hits for c in caches)
        return {
            "ops": tot_ops,
            "rts_per_op": tot_rts / tot_ops if tot_ops else 0.0,
            "hit_ratio": hits / lookups if lookups else 0.0,
            "value_hit_ratio": vhits / lookups if lookups else 0.0,
            "write_stalls": sum(k.stats.write_stalls
                                for k in self.kns.values()),
            "num_kns": len(self.kns),
        }

    def reset_stats(self) -> None:
        for kn in self.kns.values():
            kn.stats = KNStats()
            if hasattr(kn.cache, "stats"):
                kn.cache.stats = CacheStats()
        self.ms_ops = 0


def apply_window_plan(kn, cache, wp, out_values, value_bytes) -> None:
    """Apply a planned window: bulk cache mutation via apply_plan,
    then the kn-side effects (stats, miss-RT EMA in op order,
    segcache puts/pops, collected read values)."""
    cache.apply_plan(wp)
    st = kn.stats
    st.ops += wp.ops
    st.reads += wp.reads
    st.writes += wp.writes
    st.rts += wp.rts
    if wp.ema_rts:
        ema = cache._ema
        a = cache.avg_miss_rts
        for r in wp.ema_rts:
            a += ema * (r - a)
        cache.avg_miss_rts = a
    segd = kn.segcache
    cap = kn.segcache_cap
    if wp.seg_replay is not None:
        vb = value_bytes
        for k, p in wp.seg_replay:
            if p is None:
                segd.pop(k, None)
            else:
                segd[k] = (p, vb)
                segd.move_to_end(k)
                while len(segd) > cap:
                    segd.popitem(last=False)
    elif wp.seg_puts is not None:
        ks, ps = wp.seg_puts
        vb = value_bytes
        segd.update(zip(ks, ((p, vb) for p in ps)))
        # C-level move_to_end sweep keeps last-put order; trimming
        # afterwards equals per-put trimming (LRU invariant)
        any(map(segd.move_to_end, ks))
        while len(segd) > cap:
            segd.popitem(last=False)
    if out_values is not None and wp.out_vals:
        for p, v in wp.out_vals:
            out_values[p] = v


def warm_load(cache, value_keys, value_ptrs, shortcut_keys, shortcut_ptrs,
              length: int) -> None:
    """Warm an empty ArrayDAC in bulk: the state that
    ``fill_after_miss(k, p, length)`` for each value key in order, then
    ``fill_after_write(k, p, length, segment_cached=False)`` for each
    shortcut key in ascending order leave when everything fits -- the
    load-through-KN warm-up of the reference's ``load(warm=True)``
    (a shortcut for every key loaded), with the hottest keys as values.
    Values arrive with count 1 and ascending stamps, shortcuts with count
    0; both heap record lists are ascending, hence valid heaps."""
    value_keys = np.asarray(value_keys, np.int64)
    shortcut_keys = np.asarray(shortcut_keys, np.int64)
    nv, ns = value_keys.size, shortcut_keys.size
    gross = length + VALUE_OVERHEAD_BYTES
    if cache.used or cache.num_values or cache.num_shortcuts:
        raise ValueError("warm_load needs an empty cache")
    if nv * gross + ns * SHORTCUT_BYTES > cache.capacity:
        raise ValueError("the warm set does not fit the cache")
    if np.unique(np.concatenate([value_keys, shortcut_keys])).size != nv + ns:
        raise ValueError("warm keys repeat")
    if ns > 1 and not (np.diff(shortcut_keys) > 0).all():
        raise ValueError("shortcut keys must ascend")
    cache._ensure(int(max(value_keys.max(initial=0),
                          shortcut_keys.max(initial=0))))
    stamps = cache._clock + np.arange(nv, dtype=np.int64)
    if cache._dirty is not None:
        cache._dirty.extend(value_keys)
        cache._dirty.extend(shortcut_keys)
    for keys, ptrs, kind, cnt in (
            (value_keys, value_ptrs, cache.KIND_VALUE, 1),
            (shortcut_keys, shortcut_ptrs, cache.KIND_SHORTCUT, 0)):
        cache.kind[keys] = kind
        cache.ptr[keys] = ptrs
        cache.length[keys] = length
        cache.count[keys] = cnt
    cache.stamp[value_keys] = stamps
    cache._lru = list(zip(stamps.tolist(), value_keys.tolist()))
    cache._lfu = list(zip([0] * ns, shortcut_keys.tolist()))
    cache._clock += nv
    cache.used = nv * gross + ns * SHORTCUT_BYTES
    cache._nvals, cache._nshort, cache._zero_shortcuts = nv, ns, ns
    cache._cnt_hist[0] += ns
