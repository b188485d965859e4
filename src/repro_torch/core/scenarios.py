"""Production-traffic scenario harness: churn, storms, crashes.

The port's copy of the reference's harness, row for row
(tests/test_torch_scenarios.py holds the rows and events equal). The
entry points that build clusters (``run_scenario``, ``run_overload``,
``run_suite``) take ``device``: the card unless ``"cpu"`` is asked for.

Figures 6-8 each reproduce one clean event -- a single scale-out, a
single hot-key storm, a single failure.  Production traffic composes
them: the autoscaler churns membership while a flash crowd concentrates
load and a KN dies mid-batch.  This harness runs those compositions
against the real data structures with the fault plane armed, and turns
the paper's robustness claims into SLO rows:

  churn     an oscillating offered load drives the PolicyEngine through
            continuous join/leave churn; the ring must never empty,
            every reconfiguration stays bounded, integrity holds at the
            end of the run.
  storm     a flash crowd redirects a fraction of traffic onto a
            handful of hot keys mid-run, stressing selective
            replication and the Eq. 1 screen; throughput must not
            collapse onto the hot keys' owner.
  crash     a KN fail-stops at a named (seeded) crash point under
            write-heavy load -- armed mid-batch when the point fires
            inside the observed step, forced otherwise -- and the
            recovery plane (DPMPool.recover_kn) repairs the pool;
            downtime is measured as an SLO: recovery window,
            minimum-throughput fraction during recovery, and
            zero-throughput epochs.
  composed  all of the above at once: churn plus a storm window plus a
            crash at the storm's peak.

Two fencing scenarios (ownership variants only) exercise the epoch
fence under imperfect failure detection:

  partition a KN loses its DPM link mid-run (its requests block), a
            second KN goes gray (fail-slow); the partition heals on
            schedule and delivery must recover -- no false failure.
  zombie    the false-positive story: a partitioned-but-alive KN is
            declared dead, ownership hands off, the zombie heals and
            flushes its staged oplog with its stale fence token.  Every
            flush must no-op (``FencedWrite``), the acked history must
            stay linearizable, and detection latency is gated.

``violations`` in a result row collects integrity failures
(DPMPool.verify_integrity), an emptied ring, or a dead cluster at the
end of a run -- a healthy variant reports zero.  Network faults
(dropped flush RTs, delayed heartbeats) ride along on every scenario
via the seeded FaultPlane, so the SLOs are measured under realistic
noise, not lab silence.

Run one scenario:  ``run_scenario("composed", "dinomo", seed=0)``
On the card:       ``chip_smoke.py``'s ``scenarios`` phase
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

import numpy as np

from .cluster import DinomoCluster, VARIANTS
from .dpm_pool import FencedWrite
from .faults import (ALL_POINTS, ARMABLE_POINTS, CRASH_POINTS,
                     FaultPlane, KNCrash)
from .linearizability import Op, check_history
from .mnode import PolicyConfig
from .netmodel import (ArrivalProcess, DEFAULT_MODEL, NetModel,
                       PhasedArrival)
from .requestplane import RequestPlaneConfig
from .simulate import TimedSimulation
from ..data.ycsb import MIXES, Workload

SCENARIOS = ("churn", "storm", "crash", "composed")
# fencing scenarios: meaningful only for variants with logical
# ownership (a shared-everything plane has no epochs to fence)
FENCE_SCENARIOS = ("partition", "zombie")
BENCH_VARIANTS = ("dinomo", "dinomo-n", "clover")


@dataclass
class ScenarioConfig:
    """Knobs for one scenario run; ``smoke()`` is the CI profile."""
    num_kns: int = 4
    num_keys: int = 20_000
    cache_bytes: int = 1 << 19
    value_bytes: int = 1024
    num_buckets: int = 1 << 14
    segment_capacity: int = 256
    sample_ops: int = 2000
    dt: float = 1.0
    duration_s: float = 120.0
    dataset_bytes: float = 32e9          # represented scale (paper Sec. 5)
    # load shape: base_load sits inside the policy's stable band for
    # the starting cluster (no spurious scaling in steady scenarios);
    # churn oscillates between churn_low (remove band) and peak_load
    # (add band); storms bump to storm_load inside the window
    base_load: float = 8e5
    churn_low: float = 2e5
    peak_load: float = 8e6
    storm_load: float = 5e6
    churn_period_s: float = 40.0
    # storm window
    storm_start_s: float = 40.0
    storm_end_s: float = 80.0
    storm_frac: float = 0.7
    storm_hot: int = 4
    # crash
    crash_at_s: float = 60.0
    # partition / zombie (fencing scenarios)
    partition_at_s: float = 30.0
    partition_heal_s: float = 20.0       # outage length before heal
    gray_slow_factor: float = 4.0        # fail-slow RT multiplier
    zombie_staged_ops: int = 24          # oplog the zombie flushes at heal
    # background network faults
    drop_flush_rt_rate: float = 0.01
    heartbeat_delay_s: float = 0.01
    heartbeat_jitter_s: float = 0.01
    # policy
    epoch_s: float = 5.0
    grace_period_s: float = 10.0
    max_kns: int = 8

    @classmethod
    def smoke(cls) -> "ScenarioConfig":
        return cls(num_keys=3000, num_buckets=1 << 13, sample_ops=400,
                   duration_s=40.0, churn_period_s=16.0,
                   storm_start_s=10.0, storm_end_s=28.0,
                   crash_at_s=18.0, partition_at_s=10.0,
                   partition_heal_s=12.0, zombie_staged_ops=12,
                   epoch_s=4.0, grace_period_s=8.0)


@dataclass
class ScenarioResult:
    scenario: str
    variant: str
    seed: int
    crash_point: str | None
    duration_s: float
    recovery_window_s: float | None
    min_tput_during_frac: float | None
    zero_tput_epochs: int
    membership_changes: int
    replication_actions: int
    flush_rts_dropped: int
    recovery: dict | None
    violations: list[str] = field(default_factory=list)
    events: list[str] = field(default_factory=list)
    # scenario-specific observables (fence scenarios: zombie attempt /
    # fenced counts, detection latency, delivery through a partition)
    extra: dict = field(default_factory=dict)

    def row(self) -> dict:
        return {
            "scenario": self.scenario, "variant": self.variant,
            "seed": self.seed, "crash_point": self.crash_point,
            "duration_s": self.duration_s,
            "recovery_window_s": self.recovery_window_s,
            "min_tput_during_frac": self.min_tput_during_frac,
            "zero_tput_epochs": self.zero_tput_epochs,
            "membership_changes": self.membership_changes,
            "replication_actions": self.replication_actions,
            "flush_rts_dropped": self.flush_rts_dropped,
            "recovery": self.recovery,
            "violations": self.violations,
            "extra": self.extra,
        }


class StormWorkload:
    """Flash-crowd wrapper over a base Workload: during [t0, t1) a
    fraction ``frac`` of the sampled ops redirect (uniformly) onto a
    small hot set -- the sudden skew spike selective replication and
    the Eq. 1 screen exist to absorb."""

    def __init__(self, base: Workload, hot: list[int], frac: float,
                 t0: float, t1: float):
        self.base = base
        self.hot = np.asarray(hot, dtype=np.int64)
        self.frac = frac
        self.t0, self.t1 = t0, t1

    def timed_batched(self, t: float, rng, n: int):
        kinds, keys = self.base.ops_arrays(n)
        if self.t0 <= t < self.t1 and self.hot.size:
            m = rng.random(n) < self.frac
            hits = int(m.sum())
            if hits:
                keys = keys.copy()
                keys[m] = self.hot[rng.integers(0, self.hot.size, hits)]
        return kinds, keys


def _offered_fn(scenario: str, cfg: ScenarioConfig):
    if scenario in ("churn", "composed"):
        # full sine sweep: troughs dip to churn_low (the policy's remove
        # band), peaks reach peak_load (the add band) -- continuous
        # join/leave churn by construction
        def offered(t: float) -> float:
            phase = math.sin(2.0 * math.pi * t / cfg.churn_period_s)
            lo, hi = cfg.churn_low, cfg.peak_load
            return lo + (hi - lo) * max(phase, 0.0)
        return offered
    if scenario == "storm":
        # the flash crowd brings extra load with it -- enough to
        # overload the hot keys' owner unless replication spreads it
        return lambda t: (cfg.storm_load
                          if cfg.storm_start_s <= t < cfg.storm_end_s
                          else cfg.base_load)
    # crashes run against a steady in-band load so the SLO fractions
    # measure the event, not the load shape
    return lambda t: cfg.base_load


def _pick_victim(c: DinomoCluster, skip=()) -> str | None:
    """The alive KN with the most unmerged log state -- the most
    interesting crash victim -- ties broken by name for determinism."""
    best, best_pending = None, -1
    for name in sorted(c.kns):
        if not c.kns[name].alive or name in skip:
            continue
        pending = sum(len(s.entries) - s.merged_upto
                      for s in c.pool.segments.get(name, ()))
        if pending > best_pending:
            best, best_pending = name, pending
    return best


def _crash_and_recover(sim: TimedSimulation, faults: FaultPlane,
                       point: str, offered, result: ScenarioResult,
                       skip=()):
    """Crash a KN at ``point`` mid-run: arm the crash point so it fires
    inside the next step's batched write/merge paths when it can (the
    mid-batch flavor), force the equivalent state corruption when the
    step completes without reaching it (e.g. Clover's inline-merge plane
    or a point the victim never hits), then fail the KN through the
    timed reconfiguration path and verify pool integrity."""
    c = sim.c
    victim = _pick_victim(c, skip=skip)
    if victim is None or len(sim._alive_kns()) <= 1 + len(skip):
        result.events.append("crash skipped: no eligible victim")
        return
    armed = point in ARMABLE_POINTS and c.variant.name != "clover"
    if armed:
        faults.arm_crash(point, kn=victim,
                         after=int(faults.rng.integers(0, 64)))
    crashed = False
    try:
        sim.step(offered(sim.now), [f"crash {victim}@{point}"])
        sim.now += sim.dt
    except KNCrash as e:
        crashed = True
        victim = e.kn
        result.events.append(f"t={sim.now:.1f} {victim} crashed "
                             f"mid-batch at {point}")
    faults.disarm()
    if not crashed:
        rec = faults.force_crash(c.pool, victim, point)
        result.events.append(f"t={sim.now:.1f} forced {point} on "
                             f"{victim}: {rec['effect']}")
    window = sim.inject_failure(victim)
    result.recovery_window_s = window
    result.recovery = (c.reconfig_log[-1].get("recovery")
                       if c.reconfig_log else None)
    result.violations.extend(
        f"post-recovery: {v}" for v in c.pool.verify_integrity())


def _keys_owned_by(c: DinomoCluster, kn: str, start: int,
                   count: int) -> list[int]:
    """``count`` sentinel keys (outside the workload key range) whose
    ring owner is ``kn`` -- a key timeline the background traffic never
    touches, so linearizability can be checked exactly."""
    out: list[int] = []
    k = start
    while len(out) < count and k < start + 500_000:
        if c.ownership.primary(k) == kn:
            out.append(k)
        k += 1
    return out


def _run_partition(sim: TimedSimulation, faults: FaultPlane,
                   cfg: ScenarioConfig, offered,
                   result: ScenarioResult,
                   point: str | None = None) -> None:
    """A KN loses its DPM link for ``partition_heal_s`` seconds while a
    second KN goes gray (fail-slow).  No failure is injected for the
    partitioned KN: the partition must degrade delivery while open and
    delivery must recover once it heals.  With ``point`` set (the chaos
    matrix), a *different* KN crashes at that armed crash point while
    the partition is still open -- recovery must stay clean with the
    partition degrading the cluster underneath it."""
    c = sim.c
    sim.run(cfg.partition_at_s, offered)
    t0 = sim.now
    victim = _pick_victim(c)
    if victim is None:
        result.events.append("partition skipped: no eligible victim")
        sim.run(cfg.duration_s, offered)
        return
    t1 = t0 + cfg.partition_heal_s
    faults.partition(victim, "kn-dpm", start_s=t0, end_s=t1)
    gray = next((n for n in sorted(c.kns)
                 if n != victim and c.kns[n].alive), None)
    if gray is not None:
        faults.fail_slow(gray, cfg.gray_slow_factor, start_s=t0, end_s=t1)
    sim.log_event("partition", node=victim, net="kn-dpm",
                  heal_s=round(t1, 6))
    if point is not None:
        sim.run(min(t0 + cfg.partition_heal_s / 2, cfg.duration_s),
                offered)
        _crash_and_recover(sim, faults, point, offered, result,
                           skip=(victim,))
    sim.run(cfg.duration_s, offered)
    healed = faults.heal_partitions(victim, t=sim.now)
    sim.log_event("partition_healed", node=victim, open_windows=healed)
    during = [p.throughput / p.offered for p in sim.trace
              if t0 <= p.t < t1 and p.offered > 0]
    after = [p.throughput / p.offered for p in sim.trace
             if p.t >= t1 and p.offered > 0]
    result.extra = {
        "partitioned_kn": victim, "gray_kn": gray,
        "min_delivery_during": min(during) if during else None,
        "mean_delivery_after": (sum(after) / len(after)) if after else None,
    }
    if victim in c.kns and not c.kns[victim].alive:
        result.violations.append(
            "partition: healed KN was permanently failed (false positive)")


def _run_zombie(sim: TimedSimulation, faults: FaultPlane,
                cfg: ScenarioConfig, offered,
                result: ScenarioResult) -> None:
    """The false-positive detection story (paper Sec. 3.5/3.6 made safe
    under imperfect detection):

      1. a KN is partitioned from the M-node (alive, still serving);
      2. missed heartbeats declare it dead -> ownership hands off and
         the fence generation bumps;
      3. the partition heals and the zombie flushes its staged oplog
         (writes it accepted while partitioned) with its stale token.

    Every flush -- log writes, a batched fill, an indirection CAS, even
    a replayed recovery -- must come back ``FencedWrite`` without
    touching pool state, and the acked history (pre-handoff writes +
    new-owner writes + final reads) must stay linearizable with the
    fenced ops dropped."""
    c = sim.c
    pool = c.pool
    sim.run(cfg.partition_at_s, offered)
    victim = _pick_victim(c)
    if victim is None or len(sim._alive_kns()) <= 1:
        result.events.append("zombie skipped: no eligible victim")
        sim.run(cfg.duration_s, offered)
        return
    stale_token = c.kns[victim].fence_token
    zkeys = _keys_owned_by(c, victim, cfg.num_keys, cfg.zombie_staged_ops)
    history: list[Op] = []
    t = sim.now
    # acked writes through the still-legitimate owner (durable at ack)
    for i, k in enumerate(zkeys):
        inv = t + i * 1e-6
        _rts, ok = c.write(k, f"pre@{k}", victim)
        if ok:
            history.append(Op("write", k, f"pre@{k}", inv, inv + 1e-7))
    # the zombie accepts (but cannot ack) staged ops while partitioned
    t1 = t + cfg.partition_heal_s
    faults.partition(victim, "kn-mnode", start_s=t, end_s=t1)
    sim.log_event("partition", node=victim, net="kn-mnode",
                  heal_s=round(t1, 6))
    for i, k in enumerate(zkeys):
        history.append(Op("write", k, f"zombie@{k}",
                          t + 1e-3 + i * 1e-6, t1, status="fenced"))
    # missed heartbeats: the M-node declares the zombie dead and hands
    # ownership off (this bumps the fence generation past stale_token)
    window = sim.inject_failure(victim)
    result.recovery_window_s = window
    detect_s = next((e.get("detect_s") for e in reversed(sim.event_log)
                     if e["kind"] == "kn_failed"), None)
    # the new owners overwrite half the keys before the zombie returns
    t2 = t + 1e-2
    for i, k in enumerate(zkeys[::2]):
        inv = t2 + i * 1e-6
        _rts, ok = c.write(k, f"own2@{k}")
        if ok:
            history.append(Op("write", k, f"own2@{k}", inv, inv + 1e-7))
    sim.run(min(t1, cfg.duration_s), offered)
    # heal: the zombie flushes its staged oplog with the stale token --
    # every DPM entry point must reject it as a clean no-op
    faults.heal_partitions(victim, t=sim.now)
    sim.log_event("partition_healed", node=victim)
    before = pool.verify_integrity()
    attempts, fenced = 0, 0
    for k in zkeys:
        r = pool.log_write(victim, k, f"zombie@{k}", cfg.value_bytes,
                           token=stale_token)
        attempts += 1
        fenced += isinstance(r, FencedWrite)
    nb = min(4, len(zkeys))
    for op_res in (
        pool.log_write_batch(victim, zkeys[:nb],
                             [f"zombie@{k}" for k in zkeys[:nb]],
                             [cfg.value_bytes] * nb, token=stale_token),
        pool.cas_indirect(zkeys[0], None, 0, kn=victim,
                          token=stale_token),
        pool.recover_kn(victim, token=stale_token),
    ):
        attempts += 1
        fenced += isinstance(op_res, FencedWrite)
    sim.log_event("zombie_flush", node=victim, attempts=attempts,
                  fenced=fenced, token=stale_token)
    result.violations.extend(
        f"zombie: {v}" for v in pool.verify_integrity()
        if v not in before)
    if fenced != attempts:
        result.violations.append(
            f"zombie: {attempts - fenced}/{attempts} stale writes "
            "slipped past the fence")
    sim.run(cfg.duration_s, offered)
    # final reads through the current owners close the history
    t3 = sim.now
    for i, k in enumerate(zkeys):
        inv = t3 + i * 1e-6
        val, _rts, ok = c.read(k)
        if ok:
            history.append(Op("read", k, val, inv, inv + 1e-7))
    verdicts = check_history(history, initial=None)
    bad = sorted(k for k, ok in verdicts.items() if not ok)
    if bad:
        result.violations.append(
            f"zombie: non-linearizable acked history for keys {bad}")
    result.extra = {
        "victim": victim, "stale_token": stale_token,
        "zombie_attempts": attempts, "zombie_fenced": fenced,
        "fenced_write_records": len(pool.fenced_writes),
        "linearizable": not bad, "detect_s": detect_s,
    }


def run_scenario(scenario: str, variant: str, seed: int = 0,
                 smoke: bool = False, model: NetModel | None = None,
                 crash_point: str | None = None,
                 cfg: ScenarioConfig | None = None,
                 device=None) -> ScenarioResult:
    """Run one scenario against one variant; returns the SLO row.
    ``device`` is the cluster's: None is the card, "cpu" must be asked
    for."""
    if scenario not in SCENARIOS + FENCE_SCENARIOS:
        raise ValueError(f"unknown scenario {scenario!r}; "
                         f"choose from {SCENARIOS + FENCE_SCENARIOS}")
    cfg = cfg or (ScenarioConfig.smoke() if smoke else ScenarioConfig())
    model = model or DEFAULT_MODEL
    faults = FaultPlane(seed=seed,
                        drop_flush_rt_rate=cfg.drop_flush_rt_rate,
                        heartbeat_delay_s=cfg.heartbeat_delay_s,
                        heartbeat_jitter_s=cfg.heartbeat_jitter_s)
    c = DinomoCluster(VARIANTS[variant], num_kns=cfg.num_kns,
                      cache_bytes=cfg.cache_bytes,
                      value_bytes=cfg.value_bytes, model=model,
                      num_buckets=cfg.num_buckets,
                      segment_capacity=cfg.segment_capacity,
                      policy=PolicyConfig(epoch_s=cfg.epoch_s,
                                          grace_period_s=cfg.grace_period_s,
                                          max_kns=cfg.max_kns),
                      seed=seed, device=device)
    c.load((k, f"v{k}") for k in range(cfg.num_keys))
    c.pool.faults = faults
    mix = "read_mostly_update" if scenario == "storm" \
        else "write_heavy_update"
    base = Workload(num_keys=cfg.num_keys, zipf=0.99, mix=mix,
                    value_bytes=cfg.value_bytes, seed=seed)
    if scenario in ("storm", "composed"):
        wl = StormWorkload(base, base.hot_keys(cfg.storm_hot),
                           cfg.storm_frac, cfg.storm_start_s,
                           cfg.storm_end_s).timed_batched
    else:
        wl = base.timed_batched
    sim = TimedSimulation(c, wl, model=model, dt=cfg.dt,
                          sample_ops=cfg.sample_ops, seed=seed,
                          dataset_bytes=cfg.dataset_bytes, faults=faults)
    offered = _offered_fn(scenario, cfg)
    point = crash_point
    if point is None:
        point = ALL_POINTS[int(faults.rng.integers(0, len(ALL_POINTS)))]
    with_crash = scenario in ("crash", "composed")
    # the partition chaos matrix composes an explicit armed crash point
    # with the open partition; a plain partition run injects no failure
    composed_partition = scenario == "partition" and crash_point is not None
    result = ScenarioResult(
        scenario=scenario, variant=variant, seed=seed,
        crash_point=point if (with_crash or composed_partition) else None,
        duration_s=cfg.duration_s, recovery_window_s=None,
        min_tput_during_frac=None, zero_tput_epochs=0,
        membership_changes=0, replication_actions=0,
        flush_rts_dropped=0, recovery=None)

    if scenario == "partition":
        _run_partition(sim, faults, cfg, offered, result,
                       point=crash_point)
    elif scenario == "zombie":
        _run_zombie(sim, faults, cfg, offered, result)
    elif with_crash:
        sim.run(cfg.crash_at_s, offered)
        t_crash = sim.now
        _crash_and_recover(sim, faults, point, offered, result)
        sim.run(cfg.duration_s, offered)
        # SLO: delivery ratio (throughput / offered) so an oscillating
        # load doesn't masquerade as recovery -- minimum ratio during
        # the recovery window vs the mean ratio just before the crash,
        # plus zero-throughput epochs while the window is open
        window = result.recovery_window_s or 0.0
        obs_end = min(t_crash + max(window, 1.0) + 3 * cfg.dt,
                      cfg.duration_s)
        before = [p.throughput / p.offered for p in sim.trace
                  if t_crash - 6 * cfg.dt <= p.t < t_crash and p.offered > 0]
        during = [p.throughput / p.offered for p in sim.trace
                  if t_crash <= p.t <= obs_end and p.offered > 0]
        if before and during:
            steady = sum(before) / len(before)
            if steady > 0:
                result.min_tput_during_frac = min(during) / steady
        result.zero_tput_epochs = sum(1 for x in during if x <= 0.0)
    else:
        sim.run(cfg.duration_s, offered)

    result.membership_changes = sum(
        1 for r in c.reconfig_log if r["event"] in ("add", "remove",
                                                    "fail"))
    result.replication_actions = sum(
        1 for _t, kind in c.mnode.decision_log
        if kind in ("replicate", "dereplicate"))
    result.flush_rts_dropped = faults.flush_rts_dropped
    # end-of-run health: ring intact, cluster alive, pool consistent
    alive = sim._alive_kns()
    if not alive:
        result.violations.append("end: no alive KNs")
    if not c.ownership.ring.members:
        result.violations.append("end: empty ownership ring")
    result.violations.extend(f"end: {v}" for v in c.pool.verify_integrity())
    # zero throughput at run end is a correctness smell for variants
    # that reconfigure online; shared-nothing reorganizes the whole
    # dataset on any membership change, so a legitimately-open outage
    # window can overlap run end (the paper's Fig. 8 contrast)
    if (sim.trace and sim.trace[-1].throughput <= 0 and not with_crash
            and c.variant.architecture != "shared_nothing"):
        result.violations.append("end: throughput collapsed to zero")
    result.events.extend(_format_events(sim.event_log))
    return result


def _format_events(event_log: list[dict]) -> list[str]:
    """Render schema'd timeline events as human-readable rows."""
    out = []
    for e in event_log:
        rest = " ".join(f"{k}={v}" for k, v in e.items()
                        if k not in ("t", "kind"))
        out.append(f"t={e['t']:.1f} {e['kind']}"
                   + (f" {rest}" if rest else ""))
    return out


# --------------------------------------------------------------------------
# Graceful degradation under sustained overload (the open-loop request
# plane's SLO story): baseline -> 2x-saturation overload -> recovery,
# one continuous run so the overload backlog really drains into the
# recovery phase.  The policy under test: shed lowest-priority traffic
# first, keep latency bounded for admitted ops, return to baseline
# behavior within a bounded settle window once load drops.
# --------------------------------------------------------------------------
def estimated_capacity(model: NetModel, num_kns: int, mix: str,
                       value_bytes: int = 1024,
                       rts_per_op: float = 2.0) -> float:
    """Closed-form saturation estimate used to place open-loop load
    points (the bench reports measured goodput; this only anchors the
    sweep)."""
    r, u, ins = MIXES[mix]
    return model.cluster_throughput(
        num_kns=num_kns, rts_per_op=rts_per_op, value_bytes=value_bytes,
        write_fraction=u + ins)


@dataclass
class OverloadResult:
    """SLO row for one overload run; ``gates`` maps gate name ->
    (passed, observed, bound)."""
    variant: str
    seed: int
    capacity_est: float
    phases: dict
    counters: dict
    gates: dict
    violations: list[str] = field(default_factory=list)

    @property
    def passed(self) -> bool:
        return not self.violations and all(
            ok for ok, _obs, _bound in self.gates.values())

    def row(self) -> dict:
        return {
            "variant": self.variant, "seed": self.seed,
            "capacity_est": self.capacity_est, "phases": self.phases,
            "counters": {k: v for k, v in self.counters.items()},
            "gates": {k: {"passed": ok, "observed": obs, "bound": bound}
                      for k, (ok, obs, bound) in self.gates.items()},
            "violations": self.violations,
        }


def _phase_stats(records, lo: float, hi: float, op_scale: float) -> dict:
    """Latency percentiles + outcome counts for ops that *arrived*
    inside [lo, hi)."""
    lats, completed, shed, failed, total = [], 0, 0, 0, 0
    shed_by_prio: dict[int, int] = {}
    for op in records:
        if not (lo <= op.arrival < hi):
            continue
        total += 1
        if op.status == "completed":
            completed += 1
            lats.append(op.done_t - op.arrival)
        elif op.status == "shed":
            shed += 1
            shed_by_prio[op.priority] = shed_by_prio.get(op.priority,
                                                         0) + 1
        elif op.status == "failed":
            failed += 1
    out = {"offered": total, "completed": completed, "shed": shed,
           "failed": failed, "shed_by_prio": shed_by_prio,
           "goodput": completed / op_scale / max(hi - lo, 1e-9),
           "p50": None, "p99": None, "p999": None}
    if lats:
        p50, p99, p999 = np.percentile(np.asarray(lats),
                                       [50.0, 99.0, 99.9])
        out.update(p50=float(p50), p99=float(p99), p999=float(p999))
    return out


def admitted_latency_bound(cfg: RequestPlaneConfig) -> float:
    """Worst-case client latency of a *completed* request: every
    attempt may burn a full deadline, plus the (jittered) exponential
    backoffs between attempts, plus one engine quantum of slack."""
    n = cfg.max_retries + 1
    backoffs = cfg.backoff_s * (2.0 ** n - 1.0) * 1.25
    return n * cfg.deadline_s + backoffs + 2 * cfg.round_s


def run_overload(variant: str = "dinomo", seed: int = 0,
                 smoke: bool = False, mix: str = "read_mostly_update",
                 num_kns: int = 4, num_keys: int | None = None,
                 plane_cfg: RequestPlaneConfig | None = None,
                 baseline_frac: float = 0.4,
                 overload_frac: float = 2.0,
                 model: NetModel | None = None,
                 device=None) -> OverloadResult:
    """One graceful-degradation run: baseline load, sustained
    2x-saturation overload, recovery -- continuous, so the overload
    backlog drains into the recovery window.  Machine-checked gates:

      overload_p999    admitted (completed) ops stay under the
                       retry-closed latency bound during overload
      shed_priority    sheds hit the lowest priority class first
      recovery         post-settle recovery p99 and delivery return to
                       baseline-comparable levels
      exactly_once     no shed / never-dispatched request ID is
                       registered in the durable log; pool integrity
                       holds end-to-end
    """
    model = model or DEFAULT_MODEL
    num_keys = num_keys or (3000 if smoke else 20_000)
    base_s, over_s, rec_s = (0.6, 0.9, 0.9) if smoke else (2.0, 3.0, 3.0)
    settle_s = 0.4 if smoke else 1.0
    cfg = plane_cfg or RequestPlaneConfig()
    c = DinomoCluster(VARIANTS[variant], num_kns=num_kns,
                      cache_bytes=1 << 19, value_bytes=1024, model=model,
                      num_buckets=1 << 13, segment_capacity=256,
                      seed=seed, device=device)
    c.load((k, f"v{k}") for k in range(num_keys))
    wl = Workload(num_keys=num_keys, zipf=0.99, mix=mix,
                  value_bytes=1024, seed=seed)
    sim = TimedSimulation(c, wl.timed_batched, model=model, seed=seed)
    cap = estimated_capacity(model, num_kns, mix)
    arrival = PhasedArrival((
        (base_s, ArrivalProcess(rate=baseline_frac * cap)),
        (over_s, ArrivalProcess(rate=overload_frac * cap)),
        (rec_s, ArrivalProcess(rate=baseline_frac * cap)),
    ))
    res = sim.run_open_loop(base_s + over_s + rec_s, arrival, config=cfg)
    recs = res.records or []
    base = _phase_stats(recs, 0.0, base_s, cfg.op_scale)
    over = _phase_stats(recs, base_s, base_s + over_s, cfg.op_scale)
    rec = _phase_stats(recs, base_s + over_s + settle_s,
                       base_s + over_s + rec_s, cfg.op_scale)
    result = OverloadResult(
        variant=variant, seed=seed, capacity_est=cap,
        phases={"baseline": base, "overload": over, "recovery": rec},
        counters={k: v for k, v in res.counters.items()}, gates={})

    # gate: bounded tails for admitted ops under sustained overload
    bound = admitted_latency_bound(cfg)
    p999 = over["p999"]
    result.gates["overload_p999"] = (
        p999 is not None and p999 <= bound, p999, bound)
    # gate: sheds follow priority order (lowest class absorbs the cut)
    sbp = over["shed_by_prio"]
    lowest = cfg.priorities - 1
    low_sheds = sbp.get(lowest, 0)
    high_sheds = sum(v for p, v in sbp.items() if p != lowest)
    total_shed = low_sheds + high_sheds
    result.gates["shed_priority"] = (
        total_shed == 0 or low_sheds > high_sheds,
        {"lowest": low_sheds, "higher": high_sheds}, "lowest > higher")
    # gate: recovery returns to baseline-comparable service after the
    # settle window (tails within 4x baseline p99 or the absolute
    # bound, and delivery ratio back above 95%)
    rec_ok = rec["offered"] > 0 and rec["p99"] is not None
    if rec_ok:
        base_p99 = base["p99"] or bound
        lat_ok = rec["p99"] <= max(4.0 * base_p99, 0.25 * bound)
        deliver = rec["completed"] / rec["offered"]
        rec_ok = lat_ok and deliver >= 0.95
        obs = {"p99": rec["p99"], "delivery": deliver}
    else:
        obs = None
    result.gates["recovery"] = (
        bool(rec_ok), obs,
        {"p99": "<= max(4x baseline, bound/4)", "delivery": ">= 0.95"})
    # gate: exactly-once -- shed / never-dispatched requests left no
    # durable trace, and the pool stays internally consistent
    leaked = 0
    shed_writes = 0
    for op in recs:
        if op.kind != 0 and op.status == "shed":
            shed_writes += 1
            if c.pool.req_applied(op.req_id):
                leaked += 1
    result.gates["exactly_once"] = (
        leaked == 0, {"shed_writes": shed_writes, "leaked": leaked}, 0)
    result.violations.extend(f"overload: {v}"
                             for v in c.pool.verify_integrity())
    return result


def run_suite(variants=BENCH_VARIANTS, scenarios=SCENARIOS, seed: int = 0,
              smoke: bool = False,
              crash_point: str | None = None,
              device=None) -> list[ScenarioResult]:
    """The bench matrix: every scenario x every variant, one seed,
    plus the fencing scenarios for every variant with logical
    ownership (epoch fences are an ownership-plane construct)."""
    rows = [run_scenario(s, v, seed=seed, smoke=smoke,
                         crash_point=crash_point, device=device)
            for s in scenarios for v in variants]
    owned = [v for v in variants
             if VARIANTS[v].architecture != "shared_everything"]
    rows.extend(run_scenario(s, v, seed=seed, smoke=smoke, device=device)
                for s in FENCE_SCENARIOS for v in owned)
    return rows
