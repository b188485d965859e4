"""Timed cluster simulation for the elasticity experiments (Figs. 6-8):
the port's copy of the reference's ``TimedSimulation``, step for step
(tests/test_torch_simulate.py holds twin runs equal). Its sampled
batches run on the cluster's device: the miss reads through kernel A,
and with ``engine="jit"`` the KN windows through kernel E.

Drives a DinomoCluster through wall-clock time: clients offer load,
sampled operations run against the real data structures (so hit ratios
and RTs/op are measured, not assumed), the M-node policy engine makes
decisions every epoch, and reconfigurations/failures inject the
protocol's real unavailability windows (synchronous merge for DINOMO,
data reorganization for DINOMO-N, membership refresh for Clover).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

import numpy as np

from .cluster import DinomoCluster, VariantConfig, DINOMO
from .mnode import EpochStats, PolicyConfig
from .netmodel import NetModel, DEFAULT_MODEL


@dataclass
class TimePoint:
    t: float
    throughput: float
    avg_latency: float
    p99_latency: float
    num_kns: int
    offered: float
    events: list[str] = field(default_factory=list)


@dataclass
class Outage:
    """A KN (or the whole cluster) unavailable until ``until``."""
    node: str | None
    until: float
    reason: str


class TimedSimulation:
    def __init__(self, cluster: DinomoCluster, workload,
                 model: NetModel = DEFAULT_MODEL, dt: float = 1.0,
                 sample_ops: int = 20_000, seed: int = 0,
                 dataset_bytes: float | None = None,
                 batched: bool = True, faults=None,
                 engine: str | None = None):
        # the sampled working set stands in for a paper-scale dataset;
        # reorganization physics (Dinomo-N) uses the represented bytes
        self.dataset_bytes = dataset_bytes
        """``workload(t, rng, n)`` yields n (op, key) pairs for time t
        -- either a list of tuples or a (kinds, keys) array pair (see
        Workload.timed_batched). ``batched=True`` drives the sampled
        ops through DinomoCluster.execute_batch (the vectorized data
        plane, statistically identical to the per-op loop);
        ``batched=False`` keeps the per-op loop for equivalence tests.
        The raised ``sample_ops`` default leans on the batched plane to
        sample closer to paper-scale op counts per epoch."""
        self.c = cluster
        self.workload = workload
        self.model = model
        self.dt = dt
        self.sample_ops = sample_ops
        self.batched = batched
        # batch-engine selection forwarded to execute_batch (None/"host"
        # -> host window engine, "jit" -> compiled batch executor)
        self.engine = engine
        self.rng = np.random.default_rng(seed)
        self.now = 0.0
        self.outages: list[Outage] = []
        self.trace: list[TimePoint] = []
        # optional FaultPlane: perturbs failure detection (delayed
        # heartbeats) -- the pool-level crash points attach to the pool
        self.faults = faults
        # operator-visible event timeline: guarded no-ops (e.g. refusing
        # to fail/remove the last alive KN), injected faults, and the
        # open-loop request plane's sheds/retries/timeouts.  Stable
        # schema: every entry is a dict with at least {"t": <simulated
        # seconds>, "kind": <event kind>}, plus kind-specific fields --
        # so scenario/latency reports can correlate sheds, retries,
        # crashes, and recoveries on one timeline.
        self.event_log: list[dict] = []
        # per-epoch key-frequency accumulator, sparse: sorted key array
        # + aligned counts, merged once per step -- top-k extraction is
        # one argpartition over the distinct sampled keys instead of
        # nlargest over a dict of every sampled key (which dominated
        # the batched plane's step cost on low-skew workloads)
        self._ef_keys = np.empty(0, np.int64)
        self._ef_cnts = np.empty(0, np.int64)
        self._epoch_total = 0.0
        self._next_epoch = cluster.mnode.cfg.epoch_s

    def log_event(self, kind: str, **fields) -> dict:
        """Append one schema'd event to the timeline and return it."""
        ev = {"t": round(self.now, 6), "kind": kind, **fields}
        self.event_log.append(ev)
        return ev

    def _freq_add(self, u: np.ndarray, cnt: np.ndarray) -> None:
        """Fold one step's (sorted unique keys, counts) into the epoch
        accumulator (one sorted merge)."""
        if self._ef_keys.size == 0:
            self._ef_keys = u.astype(np.int64)
            self._ef_cnts = cnt.astype(np.int64)
            return
        merged = np.union1d(self._ef_keys, u)
        cnts = np.zeros(merged.size, np.int64)
        cnts[np.searchsorted(merged, self._ef_keys)] = self._ef_cnts
        cnts[np.searchsorted(merged, u)] += cnt
        self._ef_keys, self._ef_cnts = merged, cnts

    def _freq_top(self, k: int):
        """The k highest-frequency (key, count) pairs this epoch."""
        c = self._ef_cnts
        if c.size > k:
            idx = np.argpartition(c, c.size - k)[-k:]
        else:
            idx = np.arange(c.size)
        kk = self._ef_keys
        return [(int(kk[i]), float(c[i])) for i in idx.tolist()
                if c[i] > 0]

    # ------------------------------------------------------------------
    def _alive_kns(self):
        return [n for n, k in self.c.kns.items() if k.alive]

    def _available(self, name: str) -> bool:
        for o in self.outages:
            if o.until > self.now and (o.node is None or o.node == name):
                return False
        if self.faults is not None and \
                self.faults.partitioned(name, "kn-dpm", self.now):
            return False    # cannot reach the DPM pool: ops don't serve
        return True

    def _blocked_fraction(self) -> float:
        """Fraction of this step's requests that hit an unavailable
        owner, weighted by how much of the step the outage overlaps."""
        names = self._alive_kns()
        if not names:
            return 1.0
        total = 0.0
        for o in self.outages:
            overlap = min(o.until, self.now + self.dt) - self.now
            if overlap <= 0:
                continue
            frac = min(overlap / self.dt, 1.0)
            if o.node is None:
                total += frac
            elif o.node in names:
                total += frac * self.c.ownership.ring.share(o.node,
                                                            samples=512)
        if self.faults is not None:
            seen = {o.node for o in self.outages if o.until > self.now}
            for nm in self.faults.partitioned_kns("kn-dpm", self.now):
                if nm in names and nm not in seen:
                    total += self.c.ownership.ring.share(nm, samples=512)
        return min(total, 1.0)

    # ------------------------------------------------------------------
    def step(self, offered_ops_per_s: float, events: list[str]):
        c, model = self.c, self.model
        n_sample = min(self.sample_ops, max(int(offered_ops_per_s * self.dt),
                                            1))
        ops = self.workload(self.now, self.rng, n_sample)
        c.reset_stats()
        # per-step DPM-processor merge budget: write-stall merges inside
        # the step and the async catch-up below share one allowance, so
        # neither the per-op loop nor a batched flush can merge more per
        # step than the processors could (merge_all -- the synchronous
        # reconfiguration merge -- is exempt)
        budget = int(model.merge_capacity() * self.dt)
        c.pool.merge_allowance = budget
        if self.batched:
            n_ops, per_kn_ops, writes = self._step_batched(ops)
        else:
            n_ops, per_kn_ops, writes = self._step_scalar(ops)
        c.advance_merge(budget)
        c.pool.merge_allowance = None

        stats = c.aggregate_stats()
        rts = max(stats["rts_per_op"], 1e-3)
        wf = writes / max(n_ops, 1)
        shares = self._load_shares(per_kn_ops)
        # hottest single-owner key: its effective share is divided by
        # its replication factor (paper Sec. 3.4 / selective replication)
        top_share = 0.0
        if self._epoch_total and c.variant.architecture \
                != "shared_everything":
            tot_f = self._epoch_total
            # top-8 without a full sort: the epoch-frequency vectors
            # hold every sampled key (paper-scale, batched plane)
            for k, f in self._freq_top(8):
                eff = (f / tot_f) / c.ownership.replication_factor(k)
                top_share = max(top_share, eff)
        cap = model.cluster_throughput(
            num_kns=max(len(self._alive_kns()), 1), rts_per_op=rts,
            value_bytes=c.value_bytes, write_fraction=wf,
            load_shares=shares,
            metadata_server_cap=(model.clover_ms_ops
                                 if c.variant.name == "clover" else None),
            ms_load_fraction=(1.0 - stats["hit_ratio"]) + wf,
            top_key_share=top_share)
        blocked = self._blocked_fraction()
        tput = min(offered_ops_per_s, cap) * (1.0 - blocked)
        util = offered_ops_per_s / max(cap, 1.0)
        queue = 1.0 / max(1.0 - min(util, 0.99), 0.01) if util > 0.7 else 1.0
        stale_penalty = 2.0 if events else 1.0   # mapping refresh hops
        # closed-loop queue estimate: a utilization-derived depth stands
        # in for the open-loop plane's real per-KN queues (run_open_loop
        # measures the real thing)
        avg_lat = model.request_latency(
            rts, queue_depth=queue * stale_penalty - 1.0)
        p99 = avg_lat * (4.0 + 8.0 * max(util - 0.8, 0.0) * 5.0)
        if blocked > 0:
            # requests to blocked owners wait for the outage (or the
            # partition window) to clear
            rems = [o.until - self.now for o in self.outages
                    if o.until > self.now]
            if self.faults is not None:
                rems.extend(p.end_s - self.now
                            for p in self.faults.partitions
                            if p.kind == "kn-dpm" and p.active(self.now))
            rem = max(rems, default=self.dt)
            avg_lat = avg_lat + blocked * min(rem, 0.5)
            p99 = max(p99, min(rem, 0.5) * 2.0)
        self.trace.append(TimePoint(self.now, tput, avg_lat, p99,
                                    len(self._alive_kns()),
                                    offered_ops_per_s, events))
        return util, avg_lat, p99, per_kn_ops, cap

    def _step_batched(self, ops):
        """Run the sampled ops through the vectorized data plane; the
        KN/cache statistics are identical to the per-op loop
        (property-tested). Ops owned by KNs inside an outage window
        are dropped exactly as the scalar loop drops them."""
        c = self.c
        if isinstance(ops, tuple):
            kinds, keys = ops
        else:
            n = len(ops)
            kinds = np.fromiter((0 if k == "read" else 1 for k, _ in ops),
                                np.uint8, n)
            keys = np.fromiter((key for _, key in ops), np.int64, n)
        blocked: set[str] = set()
        for o in self.outages:
            if o.until > self.now:
                if o.node is None:
                    blocked.update(c.kns)
                    break
                blocked.add(o.node)
        if self.faults is not None:
            # a KN partitioned from the DPM pool cannot serve: one-sided
            # reads/writes have nowhere to go (kn-mnode partitions only
            # hide heartbeats -- the data path keeps working)
            blocked.update(self.faults.partitioned_kns("kn-dpm", self.now)
                           & set(c.kns))
        res = c.execute_batch(kinds, keys, value=f"v@{self.now}",
                              blocked_kns=blocked, engine=self.engine)
        if res.executed:
            u, cnt = np.unique(res.executed_keys, return_counts=True)
            self._freq_add(u, cnt)
            self._epoch_total += float(res.executed)
        return kinds.shape[0], res.per_kn, res.writes

    def _step_scalar(self, ops):
        """The original per-op sampling loop (equivalence baseline)."""
        c = self.c
        if isinstance(ops, tuple):
            kinds, keys = ops
            ops = [("read" if kd == 0 else "write", int(k))
                   for kd, k in zip(kinds, keys)]
        per_kn_ops: dict[str, int] = {}
        writes = 0
        step_freq: dict[int, int] = {}
        for kind, key in ops:
            try:
                kn = c.route(key)
            except KeyError:
                continue
            if not self._available(kn):
                continue
            per_kn_ops[kn] = per_kn_ops.get(kn, 0) + 1
            if kind == "read":
                c.read(key, kn)
            else:
                writes += 1
                c.write(key, f"v@{self.now}", kn)
            step_freq[key] = step_freq.get(key, 0) + 1
            self._epoch_total += 1.0
        if step_freq:
            u = np.fromiter(sorted(step_freq), np.int64, len(step_freq))
            cnt = np.fromiter((step_freq[k] for k in u.tolist()),
                              np.int64, u.size)
            self._freq_add(u, cnt)
        return len(ops), per_kn_ops, writes

    def _load_shares(self, per_kn_ops: dict[str, int]):
        tot = sum(per_kn_ops.values())
        names = self._alive_kns()
        if not tot or not names:
            return None
        return [per_kn_ops.get(n, 0) / tot for n in names]

    # ------------------------------------------------------------------
    def run(self, duration: float, offered_fn, inject=None):
        """``offered_fn(t)`` -> ops/s; ``inject(t, sim)`` optional event
        hook (e.g. failures). Runs the M-node policy every epoch."""
        cfg = self.c.mnode.cfg
        while self.now < duration:
            events: list[str] = []
            if inject is not None:
                ev = inject(self.now, self)
                if ev:
                    events.append(ev)
            util, avg_lat, p99, per_kn, cap = self.step(
                offered_fn(self.now), events)
            self.now += self.dt
            if self.now >= self._next_epoch:
                self._run_epoch(avg_lat, p99, per_kn, cap)
                self._next_epoch = self.now + cfg.epoch_s

    def _run_epoch(self, avg_lat, p99, per_kn, cap):
        c = self.c
        names = self._alive_kns()
        if not names:
            return
        kn_cap = cap / max(len(names), 1) if cap else 1.0
        occupancy = {}
        tot = sum(per_kn.values()) or 1
        offered = self.trace[-1].offered if self.trace else 0.0
        for n in names:
            share = per_kn.get(n, 0) / tot
            kn_rate = share * offered
            occupancy[n] = min(kn_rate / max(self.model.kn_cpu_ops, 1.0),
                               1.0)
        epoch_s = c.mnode.cfg.epoch_s
        stats = EpochStats(
            now=self.now, avg_latency=avg_lat, p99_latency=p99,
            occupancy=occupancy,
            key_freq={k: f / epoch_s for k, f in self._freq_top(64)},
            replication={k: c.ownership.replication_factor(k)
                         for k in c.ownership.replicated},
        )
        for action in c.mnode.decide(stats):
            self._apply(action)
        self._ef_keys = np.empty(0, np.int64)
        self._ef_cnts = np.empty(0, np.int64)
        self._epoch_total = 0.0

    def _apply(self, action):
        c = self.c
        if action.kind == "add_kn":
            name, _ = c.add_kn()
            self._post_reconfig(name)
        elif action.kind == "remove_kn" and action.node in c.kns:
            alive = self._alive_kns()
            if len(alive) <= 1 and action.node in alive:
                # removing the last alive KN would leave an empty ring;
                # refuse with a reason rather than corrupt routing
                self.log_event("refused", action="remove_kn",
                               node=action.node, reason="last alive KN")
                return
            c.remove_kn(action.node)
            self._post_reconfig(None)
        elif action.kind == "replicate":
            c.replicate_key(action.key, action.factor)
        elif action.kind == "dereplicate":
            c.dereplicate_key(action.key)

    def _post_reconfig(self, node: str | None):
        """Translate the protocol's synchronous work into outage windows."""
        rec = self.c.reconfig_log[-1] if self.c.reconfig_log else None
        if rec is None:
            return
        merge_s = rec["merged_entries"] / max(self.model.merge_capacity(), 1)
        if self.c.variant.architecture == "shared_nothing":
            # physical data reorganization blocks the cluster
            dataset_bytes = self.dataset_bytes or \
                len(self.c.pool.heap_val) * self.c.value_bytes
            move_s = rec["moved_fraction"] * dataset_bytes \
                / self.model.reorg_bw
            self.outages.append(Outage(None, self.now + merge_s + move_s,
                                       "data reorganization"))
        else:
            for p in rec["participants"]:
                self.outages.append(Outage(
                    p, self.now + merge_s + self.model.handoff_s,
                    "ownership handoff"))

    # ------------------------------------------------------------------
    def run_open_loop(self, duration: float, arrival, config=None,
                      on_crash=None):
        """Drive the cluster *open-loop* for ``duration`` seconds:
        requests arrive on ``arrival``'s schedule (an ArrivalProcess /
        PhasedArrival), queue at their owner KN's bounded FIFO, and
        live through the full backpressure / deadline / retry / hedge
        machinery (core.requestplane).  Ops sample from this
        simulation's workload and run against the real data structures
        through execute_batch; request-plane events land on this
        simulation's event_log timeline.  Returns the
        ``RequestPlaneResult`` (per-op records, latency percentiles,
        shed/retry counters)."""
        from .requestplane import RequestPlane, RequestPlaneConfig
        plane = RequestPlane(
            self.c, arrival, self.workload,
            cfg=config or RequestPlaneConfig(), model=self.model,
            seed=int(self.rng.integers(1 << 31)), t0=self.now,
            event_sink=self.event_log, on_crash=on_crash)
        res = plane.run(duration)
        self.now += duration
        self.log_event("open_loop_done",
                       offered_rate=res.offered_rate,
                       goodput=res.goodput(),
                       completed=res.counters["completed"],
                       shed=res.counters["shed"],
                       retries=res.counters["retries"])
        return res

    # ------------------------------------------------------------------
    def inject_failure(self, name: str, extra_detect_s: float = 0.0) -> float:
        """Fail a KN; returns the recovery window in seconds.  Timing
        constants come from the NetModel (detect_s / handoff_s /
        clover_refresh_s) so scenarios can sweep them; an attached
        FaultPlane adds its heartbeat delay to detection.  Failing the
        last alive KN is refused (window 0.0, reason logged): a cluster
        with an empty ring cannot recover ownership anywhere."""
        c = self.c
        alive = self._alive_kns()
        if name not in c.kns or (len(alive) <= 1 and name in alive):
            self.log_event("refused", action="inject_failure", node=name,
                           reason=("unknown KN" if name not in c.kns
                                   else "last alive KN"))
            return 0.0
        detect_s = self.model.detect_s + extra_detect_s   # heartbeat miss
        if self.faults is not None:
            detect_s += self.faults.heartbeat_delay()
        ev = c.fail_kn(name)
        rec = c.reconfig_log[-1]
        merge_s = rec["merged_entries"] / max(self.model.merge_capacity(), 1)
        if c.variant.architecture == "shared_nothing":
            dataset_bytes = self.dataset_bytes or \
                len(c.pool.heap_val) * c.value_bytes
            window = detect_s + merge_s + rec["moved_fraction"] \
                * dataset_bytes / self.model.reorg_bw
            self.outages.append(Outage(None, self.now + window,
                                       "failure reorganization"))
        elif c.variant.name == "clover":
            window = detect_s + self.model.clover_refresh_s   # refresh only
            self.outages.append(Outage(None, self.now + window,
                                       "membership refresh"))
        else:
            window = detect_s + merge_s + self.model.handoff_s
            for p in rec["participants"]:
                if p in c.kns:
                    self.outages.append(Outage(p, self.now + window,
                                               "failover"))
        self.c.mnode.note_failure(self.now)
        # detect_s = effective detection latency (heartbeat miss + any
        # FaultPlane heartbeat delay): scenarios gate on a detection SLO
        self.log_event("kn_failed", node=name, window_s=window,
                       detect_s=round(detect_s, 6))
        return window
