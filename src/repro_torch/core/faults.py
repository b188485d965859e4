"""Fault-injection plane: KN crashes at named crash points + network faults.

The port's copy of the reference's ``core/faults.py``, behaviour for
behaviour (numpy only): the port's ``core.dpm_pool.DPMPool`` calls its
hooks exactly where the reference pool does.

The paper's fault model (Sec. 3.6) is fail-stop KNs over a durable DPM
pool: a crash loses the KN's DRAM soft state while its log segments
survive in PM -- but only entries whose seal byte landed are
crash-atomic.  A torn entry invalidates itself and everything after it,
because merge order must match request order.  The atomic
crash-consistent DPM store and CIDER's contested-key synchronization
(PAPERS.md) name the failure modes worth forcing; this module forces
them *deterministically* so every run is replayable from a seed.

Crash points (threaded through the staged write plane in dpm_pool.py and
cluster.py; units say what an armed countdown counts):

  log.pre_seal      [entries]  value bytes written, seal byte not yet:
                    the current entry lands torn, nothing after it lands
  log.rotation      [events]   a segment filled and sealed, crash before
                    it is published to the shared merge backlog --
                    recovery must rediscover it by scanning the KN's
                    segments, not the backlog
  merge.mid_apply   [entries]  crash partway through a merge window: a
                    prefix reached the index, the merge cursor
                    (merged_upto) never advanced
  merge.post_apply  [events]   the whole window applied, crash before
                    the merge cursor / allowance accounting advanced --
                    recovery replays the window, so tombstone GC
                    accounting must be recomputed, never trusted
  rep.post_cas      [events]   a replicated write's CAS swung the
                    indirection slot but the KN died before the
                    superseded-pointer GC (and, on the batched plane,
                    the entry's seal byte) landed -- the one-sided CAS
                    and the seal write are separate verbs, nothing
                    orders them.  Armed inside ``DPMPool.cas_indirect``
                    (the fenced indirection-CAS path); ``force_crash``
                    remains the fallback when the victim performs no
                    CAS in the observed step

Network faults (consumed by the scenario harness and request plane):

  dropped flush RTs   a one-sided log-flush ack is lost; the KN retries,
                      costing one extra RT per drop
  delayed heartbeats  failure detection takes longer than the calibrated
                      ``NetModel.detect_s``
  partitions          a KN loses connectivity to the DPM pool
                      (``kn-dpm``: its ops stall, queues stop draining)
                      or to the M-node (``kn-mnode``: heartbeats are
                      lost, so a perfectly healthy KN is eventually
                      declared dead -- the false-positive detection the
                      fencing plane exists to survive); windows are
                      explicit or drawn from seeded onset/heal schedules
  fail-slow / gray    a KN serves at a degraded rate (``fail_slow``):
                      its measured RTs inflate by ``factor``, which the
                      request plane's live EWMA turns into a lower
                      drain rate and earlier hedging -- degraded, never
                      dead, the classic gray failure

Two injection mechanisms share these definitions: *armed* crashes
(``arm_crash`` + the ``take_crash`` hooks inside the write/merge paths
raise :class:`KNCrash` mid-operation -- the property tests' exact
mechanism) and *forced* crashes (``force_crash`` corrupts a pool's state
the way the named crash point would -- the scenario harness's mechanism
when an armed point does not fire inside the observed step).
"""

from __future__ import annotations

import enum
from dataclasses import dataclass

import numpy as np


class CRASH_POINTS(str, enum.Enum):
    """Canonical registry of declared crash points.

    Every ``take_crash`` / ``arm_crash`` / ``force_crash`` site must
    name one of these members, so an undeclared literal is refused
    where it is armed or forced, not silently ignored.  Members are ``str`` subclasses whose
    value is the wire name, so existing string-keyed comparisons,
    dict lookups, and crash-log records keep working unchanged.
    """

    LOG_PRE_SEAL = "log.pre_seal"
    LOG_ROTATION = "log.rotation"
    MERGE_MID_APPLY = "merge.mid_apply"
    MERGE_POST_APPLY = "merge.post_apply"
    REP_POST_CAS = "rep.post_cas"

    def __str__(self) -> str:  # str(member) == wire name, not member name
        return self.value

    __hash__ = str.__hash__  # interchangeable with plain str as dict key


# declaration-ordered tuple (the enum class itself indexes by *name*)
ALL_POINTS = tuple(CRASH_POINTS)
# every declared point can fire mid-operation: rep.post_cas gained its
# armed hook when the indirection-CAS path became a fenced DPM entry
# point (DPMPool.cas_indirect) -- before that it was forced-only
ARMABLE_POINTS = ALL_POINTS
# the subset whose hooks sit on the log/merge paths every write-heavy
# workload exercises; rep.post_cas only fires when the victim actually
# performs an indirection CAS, so fire-guaranteed sweeps use this
LOG_MERGE_POINTS = ALL_POINTS[:4]


def _as_point(point: str) -> CRASH_POINTS:
    """Normalize a wire name (or member) to the declared member."""
    try:
        return CRASH_POINTS(point)
    except ValueError:
        raise ValueError(
            f"unknown crash point {point!r}; declared points: "
            f"{[p.value for p in CRASH_POINTS]}") from None


class KNCrash(Exception):
    """A KN (or the DPM processor working its segment) fail-stopped at a
    named crash point.  State behind the crash point is durable; state
    past it never happened."""

    def __init__(self, kn: str, point: str):
        super().__init__(f"KN {kn!r} crashed at {point}")
        self.kn = kn
        self.point = point


@dataclass
class CrashSpec:
    point: str
    kn: str | None          # None matches any KN
    after: int              # units to let pass before the crash fires


PARTITION_KINDS = ("kn-dpm", "kn-mnode")


@dataclass
class Partition:
    """One network-partition window: during [start_s, end_s) the KN
    cannot reach the DPM pool (``kn-dpm``) or the M-node
    (``kn-mnode``).  The node itself stays perfectly healthy -- that is
    the point: a ``kn-mnode`` partition makes a live KN look dead."""
    kn: str
    kind: str               # one of PARTITION_KINDS
    start_s: float
    end_s: float

    def active(self, t: float) -> bool:
        return self.start_s <= t < self.end_s


@dataclass
class SlowSpec:
    """A fail-slow (gray) window: the KN's measured service RTs inflate
    by ``factor`` during [start_s, end_s) -- degraded, never dead."""
    kn: str
    factor: float           # RT multiplier, >= 1.0
    start_s: float
    end_s: float

    def active(self, t: float) -> bool:
        return self.start_s <= t < self.end_s


class FaultPlane:
    """Deterministic fault injector.

    Attach to a pool (``pool.faults = plane``) to arm crash points; the
    network faults perturb the reference's timed simulation, which is
    not ported yet.  All randomness comes from the seeded generator,
    so a (seed, workload) pair replays the same faults."""

    def __init__(self, seed: int = 0, drop_flush_rt_rate: float = 0.0,
                 heartbeat_delay_s: float = 0.0,
                 heartbeat_jitter_s: float = 0.0):
        self.rng = np.random.default_rng(seed)
        self.drop_flush_rt_rate = drop_flush_rt_rate
        self.heartbeat_delay_s = heartbeat_delay_s
        self.heartbeat_jitter_s = heartbeat_jitter_s
        self._armed: list[CrashSpec] = []
        self.crash_log: list[dict] = []
        self.flush_rts_dropped = 0
        self.partitions: list[Partition] = []
        self.slow: list[SlowSpec] = []

    # ----- armed crashes (raise KNCrash inside the guarded paths) ---------
    def arm_crash(self, point: str, kn: str | None = None,
                  after: int = 0) -> CrashSpec:
        point = _as_point(point)
        if point not in ARMABLE_POINTS:
            raise ValueError(f"cannot arm {point.value!r}; armable points: "
                             f"{[p.value for p in ARMABLE_POINTS]}")
        spec = CrashSpec(point, kn, max(int(after), 0))
        self._armed.append(spec)
        return spec

    def disarm(self) -> None:
        self._armed.clear()

    @property
    def armed(self) -> bool:
        return bool(self._armed)

    def take_crash(self, point: str, kn: str | None, n: int) -> int | None:
        """Called by a guarded path about to process ``n`` units of
        ``point``-flavored work for ``kn``.  Returns None (no crash in
        this run) or the offset ``j < n`` at which the crash fires; the
        caller performs j units, leaves the crash point's torn state,
        and raises :class:`KNCrash`.  The fired spec disarms itself."""
        for spec in self._armed:
            if spec.point != point:
                continue
            if spec.kn is not None and kn is not None and spec.kn != kn:
                continue
            if spec.after >= n:
                spec.after -= n
                return None
            j = spec.after
            self._armed.remove(spec)
            self.crash_log.append({"point": str(point), "kn": kn,
                                   "offset": j, "forced": False})
            return j
        return None

    # ----- forced crashes (corrupt pool state directly) --------------------
    def force_crash(self, pool, kn: str, point: str,
                    torn: int = 2) -> dict:
        """Impose the state a crash of ``kn`` at ``point`` would leave on
        ``pool`` (a :class:`~repro_torch.core.dpm_pool.DPMPool`).  Used by the
        scenario harness when the armed crash point did not fire inside
        the observed step (e.g. the victim never rotated a segment), and
        by targeted tests.  Returns a record of the corruption actually
        applied -- some points degrade to "nothing to corrupt" when the
        KN has no matching state (a KN with an empty log has nothing to
        tear)."""
        point = _as_point(point)
        segs = pool.segments.get(kn, [])
        rec = {"point": str(point), "kn": kn, "forced": True,
               "effect": "none"}
        if point is CRASH_POINTS.LOG_PRE_SEAL:
            for seg in reversed(segs):
                cut = max(len(seg.entries) - torn, seg.merged_upto)
                if cut < len(seg.entries):
                    for i in range(cut, len(seg.entries)):
                        seg.sealed[i] = False
                    rec["effect"] = f"tore {len(seg.entries) - cut} entries"
                    break
        elif point is CRASH_POINTS.LOG_ROTATION:
            # un-publish one of the KN's sealed backlog segments
            for i, (seg, d) in enumerate(pool.merge_backlog):
                if seg.kn == kn and seg.merged_upto < len(seg.entries):
                    del pool.merge_backlog[i]
                    rec["effect"] = (f"unpublished segment with "
                                     f"{len(seg.entries)} entries")
                    break
        elif point in (CRASH_POINTS.MERGE_MID_APPLY,
                       CRASH_POINTS.MERGE_POST_APPLY):
            for seg in segs:
                entries = seg.sealed_entries()
                todo = entries[seg.merged_upto:]
                if not todo:
                    continue
                j = len(todo) if point is CRASH_POINTS.MERGE_POST_APPLY \
                    else max(len(todo) // 2, 1)
                for key, ptr in todo[:j]:
                    pool._merge_entry(key, ptr, seg)
                # the crash: merged_upto / accounting never advanced
                rec["effect"] = f"applied {j}/{len(todo)} without cursor"
                break
        elif point is CRASH_POINTS.REP_POST_CAS:
            key = next(iter(pool.indirect), None)
            if key is not None and segs and not segs[-1].full():
                seg = segs[-1]
                ptr = pool.alloc_value(f"torn@{key}", 0, seg)
                seg.append(key, ptr, sealed=False,
                           gen=pool.fence.get(kn, 0))
                # CAS landed, seal + superseded-pointer GC never did
                pool.indirect[key] = ptr
                pool._indirect_version += 1
                rec["effect"] = f"dangling CAS for key {key} -> {ptr}"
        self.crash_log.append(rec)
        return rec

    # ----- network faults ---------------------------------------------------
    def drop_flush_rt(self) -> bool:
        """One flush-ack bernoulli draw (scalar write path).  Zero rate
        consumes no randomness, keeping fault-free runs bit-identical."""
        if self.drop_flush_rt_rate <= 0.0:
            return False
        hit = bool(self.rng.random() < self.drop_flush_rt_rate)
        self.flush_rts_dropped += hit
        return hit

    def drop_flush_mask(self, n: int) -> np.ndarray:
        """Retry-RT increments per flush event for a staged batch of
        ``n`` flush events (float 0/1 per event)."""
        if self.drop_flush_rt_rate <= 0.0:
            return np.zeros(n, np.float64)
        m = (self.rng.random(n) < self.drop_flush_rt_rate)
        self.flush_rts_dropped += int(m.sum())
        return m.astype(np.float64)

    def heartbeat_delay(self) -> float:
        """Extra failure-detection latency beyond ``NetModel.detect_s``."""
        d = self.heartbeat_delay_s
        if self.heartbeat_jitter_s > 0.0:
            d += float(self.rng.random()) * self.heartbeat_jitter_s
        return d

    # ----- partitions & gray failures --------------------------------------
    def partition(self, kn: str, kind: str, start_s: float,
                  end_s: float = float("inf")) -> Partition:
        """Register one partition window.  Composable with armed crash
        points and every other fault: the lists are independent."""
        if kind not in PARTITION_KINDS:
            raise ValueError(f"unknown partition kind {kind!r}; "
                             f"choose from {PARTITION_KINDS}")
        p = Partition(kn, kind, float(start_s), float(end_s))
        self.partitions.append(p)
        return p

    def schedule_partition(self, kn: str, kind: str, horizon_s: float,
                           mean_onset_s: float,
                           mean_outage_s: float) -> Partition | None:
        """Seeded onset/heal schedule: onset ~ Exp(mean_onset_s),
        outage ~ Exp(mean_outage_s), clipped to the horizon.  Returns
        None when the drawn onset falls past the horizon (no partition
        this run) -- deterministic per (seed, call order)."""
        onset = float(self.rng.exponential(mean_onset_s))
        if onset >= horizon_s:
            return None
        heal = min(onset + float(self.rng.exponential(mean_outage_s)),
                   horizon_s)
        return self.partition(kn, kind, onset, heal)

    def partitioned(self, kn: str, kind: str, t: float) -> bool:
        return any(p.kn == kn and p.kind == kind and p.active(t)
                   for p in self.partitions)

    def partitioned_kns(self, kind: str, t: float) -> set[str]:
        return {p.kn for p in self.partitions
                if p.kind == kind and p.active(t)}

    def heal_partitions(self, kn: str | None = None, t: float = 0.0) -> int:
        """Force-heal open partitions (all of ``kn``'s, or everyone's):
        their windows close at ``t``.  Returns how many were healed."""
        healed = 0
        for p in self.partitions:
            if (kn is None or p.kn == kn) and p.end_s > t:
                p.end_s = t
                healed += 1
        return healed

    def fail_slow(self, kn: str, factor: float, start_s: float = 0.0,
                  end_s: float = float("inf")) -> SlowSpec:
        """Register a gray-failure window: ``factor`` >= 1 multiplies
        the KN's measured RTs while active (visible to the request
        plane's live EWMA, hence its drain credits and hedging)."""
        s = SlowSpec(kn, max(float(factor), 1.0), float(start_s),
                     float(end_s))
        self.slow.append(s)
        return s

    def slow_factor(self, kn: str, t: float) -> float:
        """The RT inflation for ``kn`` at time ``t`` (1.0 = healthy);
        overlapping windows take the worst factor."""
        f = 1.0
        for s in self.slow:
            if s.kn == kn and s.active(t):
                f = max(f, s.factor)
        return f
