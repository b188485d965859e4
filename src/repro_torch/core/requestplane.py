"""Open-loop request plane: bounded queues, backpressure, deadlines,
exactly-once retries, and hedged reads over the batched data plane.

The port's copy of the reference's plane, decision for decision: the same
random draws in the same order, the same events and counters
(tests/test_torch_requestplane.py holds twin runs equal). It reaches the
cluster only through ``execute_batch(req_ids=..., values=...,
collect_values=...)``, so its batches run on the cluster's device.

The paper's throughput figures are closed-loop: clients wait for each
response, so offered load can never exceed service capacity and tail
latency stays hidden.  Production traffic is open-loop -- requests
arrive on their own schedule (``netmodel.ArrivalProcess``), queue at
their owner KN, and overload shows up as queueing collapse, retry
storms, and unbounded tails unless the serving plane defends itself.
This module adds that defense:

  * **Bounded per-KN FIFO queues** with explicit backpressure.  A full
    queue either *sheds* (reject immediately, lowest priority first --
    a shed request is a clean no-op) or *defers* (push back on the
    client, who resubmits after a short wait), per
    ``RequestPlaneConfig.policy``.
  * **Per-attempt deadlines** with timeout, exponential backoff, and
    bounded retries.  A timed-out write is *indeterminate*: it may have
    applied before the client gave up.  Retries therefore carry the
    original request ID into the durable log (``DinomoCluster.
    execute_batch(req_ids=...)`` -> ``DPMPool.req_index``), so a retry
    of an applied write deduplicates -- exactly-once end to end, across
    crash/recovery boundaries (a torn entry unregisters its ID during
    ``recover_kn``; the retry then applies fresh).
  * **Hedged reads**: a read still waiting ``hedge_after_s`` after
    submission issues a duplicate to the least-loaded other KN (served
    off the shared pool via the miss path) and takes the earlier
    completion.
  * **Timestamps**: every request records queued -> dispatched ->
    completed times; latency percentiles come from these, reconciled
    against the NetModel's RDMA RT costs (Table 5 counts measured live
    off each KN's stats, not assumed).

Simulation scaling: the engine op-scales the open-loop system by
``op_scale`` -- arrivals run at ``rate * op_scale`` and each KN drains
its queue at ``kn_capacity * op_scale`` sim-ops/s -- so utilization
(and therefore queueing behavior) matches the real system while the
Python data plane executes a tractable number of ops.  Queue waits are
``depth / (capacity * op_scale)`` and come out in real seconds; the
in-service time of an op is its real, unscaled ``NetModel.
service_time`` from measured RTs/op.  Every sampled op runs against
the real data structures through ``execute_batch``, so hit ratios,
RTs/op, crashes, and recovery are measured, not assumed.
"""

from __future__ import annotations

import dataclasses
import heapq
import math
from collections import deque

import numpy as np

from .faults import KNCrash
from .netmodel import ArrivalProcess, DEFAULT_MODEL, NetModel

# terminal request statuses
COMPLETED = "completed"      # client got a success before some deadline
SHED = "shed"                # rejected by backpressure: clean no-op
FAILED = "failed"            # retries exhausted (writes: indeterminate)
INFLIGHT = "inflight"        # censored at end of run

_INF = math.inf


@dataclasses.dataclass(frozen=True)
class RequestPlaneConfig:
    """Knobs for the open-loop request plane (times in real seconds,
    queue sizes in sim-ops -- one sim-op stands for ``1 / op_scale``
    real ops, see the module docstring)."""

    queue_capacity: int = 32          # per-KN bounded FIFO (sim-ops)
    policy: str = "shed"              # queue-full: "shed" | "defer"
    deadline_s: float = 0.03          # per-attempt deadline budget
    max_retries: int = 3
    backoff_s: float = 5e-3           # exponential base, 25% jitter
    hedge_after_s: float | None = None
    priorities: int = 2               # 0 == highest
    priority_weights: tuple | None = None
    op_scale: float = 1e-3            # sim-ops per real op
    round_s: float = 0.02             # batching quantum of the engine
    defer_wait_s: float = 5e-3        # client resubmit wait on defer
    dedup_rts: float = 1.0            # req-index probe cost on dedup hit
    record_values: bool = False       # collect read values (history mode)
    keep_records: bool = True         # retain per-op records

    def __post_init__(self):
        if self.policy not in ("shed", "defer"):
            raise ValueError(f"unknown queue-full policy {self.policy!r}")
        if self.priorities < 1:
            raise ValueError("need at least one priority class")
        if self.op_scale <= 0.0:
            raise ValueError("op_scale must be positive")


@dataclasses.dataclass
class OpRecord:
    """One logical client request across all its attempts."""
    req_id: int
    kind: int                 # 0 read, 1 write, 2 delete
    key: int
    priority: int
    arrival: float            # original submission time
    payload: str | None
    submit_t: float = 0.0     # current attempt's submission
    deadline: float = 0.0     # current attempt's deadline
    enq_t: float = 0.0
    attempts: int = 0
    deferrals: int = 0
    dispatch_t: float = -1.0  # current attempt's dispatch (-1 = queued)
    first_dispatch_t: float = -1.0
    status: str = INFLIGHT
    done_t: float = -1.0
    value: object = None      # read result (history mode)
    kn: str | None = None
    dispatched_ever: bool = False   # any attempt reached the data plane
    hedged: bool = False
    hedge_win: bool = False
    deduped: bool = False


class _KnQueue:
    """Bounded multi-priority FIFO for one KN (strict priority
    dispatch, FIFO within a class)."""

    __slots__ = ("qs", "count")

    def __init__(self, priorities: int):
        self.qs = [deque() for _ in range(priorities)]
        self.count = 0

    def peek(self) -> OpRecord | None:
        for q in self.qs:
            if q:
                return q[0]
        return None

    def pop(self) -> OpRecord:
        for q in self.qs:
            if q:
                self.count -= 1
                return q.popleft()
        raise IndexError("pop from empty queue")

    def push(self, op: OpRecord) -> None:
        self.qs[op.priority].append(op)
        self.count += 1

    def evict_lower(self, priority: int) -> OpRecord | None:
        """Evict the youngest *sheddable* op of the lowest class
        strictly below ``priority`` (shed policy: lowest-priority
        traffic goes first).  An op any of whose attempts reached the
        data plane is never sheddable -- shed promises a clean no-op,
        and a requeued retry's earlier attempt may already have applied
        (its timeout was indeterminate)."""
        for pi in range(len(self.qs) - 1, priority, -1):
            q = self.qs[pi]
            for i in range(len(q) - 1, -1, -1):
                if not q[i].dispatched_ever:
                    victim = q[i]
                    del q[i]
                    self.count -= 1
                    return victim
        return None

    def expire(self, t: float) -> list[OpRecord]:
        """Remove (and return) queued ops whose deadline is <= t."""
        out = []
        for pi, q in enumerate(self.qs):
            if not any(op.deadline <= t for op in q):
                continue
            keep = deque()
            for op in q:
                (out if op.deadline <= t else keep).append(op)
            self.qs[pi] = keep
        self.count -= len(out)
        return out


@dataclasses.dataclass
class RequestPlaneResult:
    duration_s: float
    offered_rate: float            # real ops/s (long-run mean)
    op_scale: float
    counters: dict
    latencies: np.ndarray          # completed-op client latencies (s)
    records: list | None
    events: list

    def percentiles(self) -> dict:
        if self.latencies.size == 0:
            return {"p50": None, "p99": None, "p999": None}
        p50, p99, p999 = np.percentile(self.latencies, [50.0, 99.0, 99.9])
        return {"p50": float(p50), "p99": float(p99), "p999": float(p999)}

    def goodput(self) -> float:
        """Completed real ops/s over the offered-load window."""
        if self.duration_s <= 0:
            return 0.0
        return self.counters["completed"] / self.op_scale / self.duration_s

    def row(self) -> dict:
        pct = self.percentiles()
        return {
            "duration_s": self.duration_s,
            "offered_rate": self.offered_rate,
            "op_scale": self.op_scale,
            "goodput": self.goodput(),
            **pct,
            "counters": dict(self.counters),
        }


class RequestPlane:
    """The open-loop engine: one run drives ``cluster`` with arrivals
    from ``arrival`` (an ``ArrivalProcess`` or anything with
    ``.arrivals(rng, t0, t1)`` + ``.scaled(f)``), sampling op kinds and
    keys from ``workload(t, rng, n)`` (the ``TimedSimulation``
    convention: a (kinds, keys) array pair or a list of (kind, key))."""

    def __init__(self, cluster, arrival, workload, *,
                 cfg: RequestPlaneConfig | None = None,
                 model: NetModel = DEFAULT_MODEL, seed: int = 0,
                 t0: float = 0.0, event_sink: list | None = None,
                 on_crash=None):
        self.c = cluster
        self.cfg = cfg = cfg or RequestPlaneConfig()
        self.model = model
        self.offered_rate = float(getattr(arrival, "rate", 0.0))
        self.arrival = arrival.scaled(cfg.op_scale)
        self.workload = workload
        self.rng = np.random.default_rng(seed)
        self.t0 = t0
        self.on_crash = on_crash
        self.events: list[dict] = [] if event_sink is None else event_sink
        self.queues: dict[str, _KnQueue] = {}
        self.free_at: dict[str, float] = {}
        self.rts_est: dict[str, float] = {}    # EWMA measured RTs/op
        self.credit: dict[str, float] = {}     # server busy time / sim-op
        self.pending: list = []                # (t, seq, op) resubmissions
        self.records: list[OpRecord] = []
        self.latencies: list[float] = []
        self.never_applied_reqs: list[int] = []  # shed / never-dispatched
        # write requests that could still retry (req_id -> None); the
        # min is the retry horizon below which the pool's dedup table
        # can be compacted (DPMPool.retire_reqs) -- see _retire_reqs
        self._open_writes: set[int] = set()
        self.retire_horizon = 0                # last _retire_reqs horizon
        self._seq = 0
        self._next_id = 0
        self._round_end = t0
        z = ["offered", "resubmits", "completed", "shed", "deferred",
             "queue_expired", "late_applied", "attempt_timeouts",
             "retries", "dedup_hits", "hedges", "hedge_wins", "failed",
             "crashes", "executed", "refused", "censored",
             "retired_reqs"]
        self.counters: dict = {k: 0 for k in z}
        self.counters["shed_by_prio"] = [0] * cfg.priorities
        self.counters["completed_by_prio"] = [0] * cfg.priorities
        self._refresh_credit()

    # ----- bookkeeping ----------------------------------------------------
    def _log(self, kind: str, t: float, **fields) -> None:
        self.events.append({"t": round(t, 6), "kind": kind, **fields})

    def _tick(self) -> int:
        self._seq += 1
        return self._seq

    def _refresh_credit(self) -> None:
        """Per-KN sim service credit from the current RTs/op estimate:
        1 / (kn_capacity * op_scale) seconds of server occupancy per
        sim-op (the op-scaled drain rate; see the module docstring)."""
        vb = self.c.value_bytes
        for nm in self.c.kns:
            est = self.rts_est.get(nm, 2.0)
            mu = self.model.kn_capacity(max(est, 0.5), vb) \
                * self.cfg.op_scale
            self.credit[nm] = 1.0 / max(mu, 1e-9)

    def _sample(self, t: float, n: int):
        ops = self.workload(t, self.rng, n)
        if isinstance(ops, tuple):
            return ops
        kinds = np.fromiter((0 if k == "read" else 1 for k, _ in ops),
                            np.uint8, len(ops))
        keys = np.fromiter((key for _, key in ops), np.int64, len(ops))
        return kinds, keys

    def _priorities(self, n: int) -> np.ndarray:
        P = self.cfg.priorities
        if P == 1:
            return np.zeros(n, np.int64)
        w = self.cfg.priority_weights
        if w is None:
            return self.rng.integers(0, P, n)
        p = np.asarray(w, np.float64)
        return self.rng.choice(P, size=n, p=p / p.sum())

    # ----- driver ---------------------------------------------------------
    def run(self, duration: float) -> RequestPlaneResult:
        t, t_end = self.t0, self.t0 + duration
        while t < t_end:
            t1 = min(t + self.cfg.round_s, t_end)
            self._round(t, t1, fresh=True)
            t = t1
        # drain phase: no fresh arrivals; resolve queued ops and
        # scheduled retries (bounded -- retries are finite)
        cfg = self.cfg
        drain_cap = t + (cfg.max_retries + 1) \
            * (cfg.deadline_s + 8 * cfg.backoff_s) + 4 * cfg.round_s
        while (self.pending
               or any(q.count for q in self.queues.values())) \
                and t < drain_cap:
            t1 = t + cfg.round_s
            self._round(t, t1, fresh=False)
            t = t1
        for op in self.records:
            if op.status == INFLIGHT:
                self.counters["censored"] += 1
        return RequestPlaneResult(
            duration_s=duration, offered_rate=self.offered_rate,
            op_scale=cfg.op_scale, counters=self.counters,
            latencies=np.asarray(self.latencies, np.float64),
            records=self.records if cfg.keep_records else None,
            events=self.events)

    def _round(self, rt0: float, t1: float, fresh: bool) -> None:
        self._round_end = t1
        cfg = self.cfg
        per_kn: dict[str, list[OpRecord]] = {}
        sheds0 = self.counters["shed"]
        if fresh:
            ts = self.arrival.arrivals(self.rng, rt0, t1)
            n = int(ts.size)
            if n:
                kinds, keys = self._sample(rt0, n)
                prios = self._priorities(n)
                for i in range(n):
                    rid = self._next_id
                    self._next_id += 1
                    kd = int(kinds[i])
                    op = OpRecord(req_id=rid, kind=kd, key=int(keys[i]),
                                  priority=int(prios[i]),
                                  arrival=float(ts[i]),
                                  payload=f"r{rid}" if kd else None)
                    op.submit_t = op.arrival
                    op.deadline = op.arrival + cfg.deadline_s
                    op.attempts = 1
                    if kd:
                        self._open_writes.add(rid)
                    self.counters["offered"] += 1
                    if cfg.keep_records:
                        self.records.append(op)
                    self._submit(op, per_kn)
        while self.pending and self.pending[0][0] < t1:
            _, _, op = heapq.heappop(self.pending)
            self.counters["resubmits"] += 1
            self._submit(op, per_kn)
        dispatches: list[OpRecord] = []
        for nm in sorted(set(per_kn)
                         | {k for k, q in self.queues.items() if q.count}):
            arr = per_kn.get(nm, ())
            if arr:
                arr = sorted(arr, key=lambda o: o.submit_t)
            self._drain_kn(nm, arr, t1, dispatches)
        if dispatches:
            dispatches.sort(key=lambda o: o.dispatch_t)
            self._resolve_batch(dispatches)
        shed = self.counters["shed"] - sheds0
        if shed:
            self._log("shed", t1, count=shed, policy=cfg.policy)
        self._retire_reqs()

    def _retire_reqs(self) -> None:
        """Per-round dedup-table compaction.  The retry horizon is the
        smallest request ID a future ``req_applied`` probe could still
        carry: the min over writes that are not yet terminal (every
        probe comes from a retry of such a write).  Everything below it
        is provably dead to the exactly-once contract and can leave
        ``DPMPool.req_index`` -- including across crash/recover, since
        a recovered pool is only ever probed by those same open
        retries."""
        horizon = min(self._open_writes) if self._open_writes \
            else self._next_id
        self.retire_horizon = horizon
        self.counters["retired_reqs"] += self.c.pool.retire_reqs(horizon)

    # ----- admission ------------------------------------------------------
    def _submit(self, op: OpRecord, per_kn: dict) -> None:
        try:
            nm = self.c.route(op.key)
        except KeyError:
            self._fail(op, op.submit_t)
            return
        kn = self.c.kns.get(nm)
        if kn is None or not (kn.alive and kn.available):
            # owner down: the client sees a refusal and retries later
            self.counters["refused"] += 1
            self._attempt_timeout(op, op.submit_t)
            return
        op.kn = nm
        per_kn.setdefault(nm, []).append(op)

    def _enqueue(self, nm: str, op: OpRecord) -> None:
        q = self.queues.get(nm)
        if q is None:
            q = self.queues[nm] = _KnQueue(self.cfg.priorities)
        if q.count >= self.cfg.queue_capacity:
            # backpressure: shedding is only legal for first attempts
            # (a shed request must be a clean no-op, and an earlier
            # attempt of a retry may already have applied) -- retries
            # under a full queue always defer
            if self.cfg.policy == "defer" or op.attempts > 1:
                self._defer(op)
                return
            victim = q.evict_lower(op.priority)
            if victim is not None:
                self._shed(victim, op.submit_t)
                op.enq_t = op.submit_t
                q.push(op)
            else:
                self._shed(op, op.submit_t)
            return
        op.enq_t = op.submit_t
        q.push(op)

    def _defer(self, op: OpRecord) -> None:
        op.deferrals += 1
        self.counters["deferred"] += 1
        t = op.submit_t + self.cfg.defer_wait_s
        if t >= op.deadline:
            # the client's timer fires before the resubmission lands
            self._attempt_timeout(op, op.deadline)
            return
        op.submit_t = t
        heapq.heappush(self.pending, (t, self._tick(), op))

    def _shed(self, op: OpRecord, t: float) -> None:
        op.status = SHED
        op.done_t = t
        self._open_writes.discard(op.req_id)
        self.counters["shed"] += 1
        self.counters["shed_by_prio"][op.priority] += 1
        if op.kind != 0 and not op.dispatched_ever:
            self.never_applied_reqs.append(op.req_id)

    # ----- dispatch -------------------------------------------------------
    def _drain_kn(self, nm: str, arrivals, t1: float,
                  dispatches: list[OpRecord]) -> None:
        """Interleave this round's arrivals with the KN's queue drain in
        event-time order; collect dispatched ops for the batch."""
        q = self.queues.get(nm)
        if q is None:
            q = self.queues[nm] = _KnQueue(self.cfg.priorities)
        free = self.free_at.get(nm, self.t0)
        credit = self.credit.get(nm)
        if credit is None:
            self._refresh_credit()
            credit = self.credit.get(nm, 1e-3)
        ai, na = 0, len(arrivals)
        while True:
            head = q.peek()
            next_arr = arrivals[ai].submit_t if ai < na else _INF
            if head is not None:
                dis_t = max(free, head.enq_t)
                if dis_t <= next_arr and dis_t < t1:
                    op = q.pop()
                    dis_t = max(free, op.enq_t)
                    if dis_t >= op.deadline:
                        self._queue_expired(op)
                        continue
                    op.dispatch_t = dis_t
                    if op.first_dispatch_t < 0:
                        op.first_dispatch_t = dis_t
                    if (self.cfg.hedge_after_s is not None
                            and op.kind == 0
                            and dis_t - op.submit_t
                            >= self.cfg.hedge_after_s):
                        op.hedged = True
                    free = dis_t + credit
                    dispatches.append(op)
                    continue
            if next_arr < t1:
                self._enqueue(nm, arrivals[ai])
                ai += 1
                continue
            break
        self.free_at[nm] = free
        for op in q.expire(t1):
            self._queue_expired(op)

    def _queue_expired(self, op: OpRecord) -> None:
        """An op's deadline passed while it sat in the queue -- the
        attempt never reached the data plane."""
        self.counters["queue_expired"] += 1
        if op.hedged is False and op.kind == 0 \
                and self.cfg.hedge_after_s is not None \
                and op.submit_t + self.cfg.hedge_after_s < op.deadline:
            done = self._issue_hedge(op, op.submit_t
                                     + self.cfg.hedge_after_s)
            if done is not None and done <= op.deadline:
                op.hedged = op.hedge_win = True
                self.counters["hedge_wins"] += 1
                self._complete(op, done)
                return
        self._attempt_timeout(op, op.deadline)

    def _issue_hedge(self, op: OpRecord, t_issue: float) -> float | None:
        """Model a duplicate read on the least-loaded other KN: it
        occupies that KN's service credit and completes via the miss
        path (index probe + value fetch on top of the owner's RT
        estimate -- the hedge target serves off the shared pool)."""
        best, bt = None, _INF
        for nm, kn in self.c.kns.items():
            if nm == op.kn or not (kn.alive and kn.available):
                continue
            ft = self.free_at.get(nm, self.t0)
            if ft < bt:
                best, bt = nm, ft
        if best is None:
            return None
        self.counters["hedges"] += 1
        disp = max(t_issue, bt)
        self.free_at[best] = disp + self.credit.get(best, 1e-3)
        rts = self.rts_est.get(best, 2.0) + 2.0
        return disp + self.model.service_time(rts)

    # ----- execution ------------------------------------------------------
    def _resolve_batch(self, dispatches: list[OpRecord]) -> None:
        pool = self.c.pool
        run: list[OpRecord] = []
        for op in dispatches:
            op.dispatched_ever = True
            if op.kind != 0 and op.attempts > 1 \
                    and pool.req_applied(op.req_id):
                # an earlier attempt of this write durably applied: the
                # retry deduplicates against the staged oplog instead of
                # re-executing (exactly-once)
                op.deduped = True
                self.counters["dedup_hits"] += 1
                done = op.dispatch_t \
                    + self.model.service_time(self.cfg.dedup_rts)
                self._settle(op, done)
            else:
                run.append(op)
        if not run:
            return
        n = len(run)
        kinds = np.fromiter((op.kind for op in run), np.uint8, n)
        keys = np.fromiter((op.key for op in run), np.int64, n)
        rids = np.fromiter((op.req_id if op.kind else -1 for op in run),
                           np.int64, n)
        payloads = [op.payload for op in run]
        self.c.reset_stats()
        self.counters["executed"] += n
        try:
            res = self.c.execute_batch(
                kinds, keys, values=lambda i: payloads[i], req_ids=rids,
                collect_values=self.cfg.record_values)
        except KNCrash as e:
            self._handle_crash(e, run)
            return
        # measured RTs/op per KN this round (Table 5 reconciliation:
        # service times come from the live RT counters, not a constant)
        fp = getattr(self.c.pool, "faults", None)
        for nm, kn in self.c.kns.items():
            st = kn.stats
            if st.ops:
                meas = st.rts / st.ops
                if fp is not None:
                    # a gray (fail-slow) KN serves correctly but slowly:
                    # its measured RTs inflate, so the EWMA -> credits ->
                    # hedging machinery sees the degradation organically
                    meas *= fp.slow_factor(nm, self._round_end)
                prev = self.rts_est.get(nm)
                self.rts_est[nm] = meas if prev is None \
                    else 0.7 * prev + 0.3 * meas
        self._refresh_credit()
        vals = res.values if self.cfg.record_values else None
        for i, op in enumerate(run):
            rts = self.rts_est.get(op.kn, 2.0)
            done = op.dispatch_t + self.model.service_time(rts)
            if vals is not None and op.kind == 0:
                op.value = vals[i]
            if op.hedged:
                hd = self._issue_hedge(
                    op, op.submit_t + self.cfg.hedge_after_s)
                if hd is not None and hd < done:
                    op.hedge_win = True
                    self.counters["hedge_wins"] += 1
                    done = hd
            self._settle(op, done)

    def _settle(self, op: OpRecord, done: float) -> None:
        if done <= op.deadline:
            self._complete(op, done)
            return
        # the attempt applied (or executed) but the client's timer fired
        # first: an indeterminate timeout from the client's view
        self.counters["late_applied"] += 1
        self._attempt_timeout(op, op.deadline)

    def _handle_crash(self, e: KNCrash, run: list[OpRecord]) -> None:
        """A KN fail-stopped mid-batch: every in-flight op of the batch
        is indeterminate (some prefix durably applied, the rest did
        not).  Clients time out and retry; write retries deduplicate
        against whatever the recovery plane kept, so each request still
        applies exactly once."""
        self.counters["crashes"] += 1
        self._log("kn_crash", self._round_end, node=e.kn, point=e.point)
        handler = self.on_crash or RequestPlane.default_recover
        handler(self, e)
        for op in run:
            self._attempt_timeout(op, op.deadline)

    @staticmethod
    def default_recover(plane: "RequestPlane", e: KNCrash) -> None:
        """Transient crash + immediate crash-consistent recovery: run
        ``DPMPool.recover_kn`` (torn tails discarded, their request IDs
        unregistered, sealed-but-unmerged entries replayed) and charge
        the detection window to the victim's serving clock.  Scenarios
        that want full failover pass their own ``on_crash``."""
        pool = plane.c.pool
        if pool.faults is not None and pool.faults.armed:
            pool.faults.disarm()
        pool.recover_kn(e.kn)
        t = max(plane.free_at.get(e.kn, plane.t0), plane._round_end)
        plane.free_at[e.kn] = t + plane.model.detect_s
        plane._log("kn_recovered", plane._round_end, node=e.kn)

    # ----- outcomes -------------------------------------------------------
    def _complete(self, op: OpRecord, done: float) -> None:
        op.status = COMPLETED
        op.done_t = done
        self._open_writes.discard(op.req_id)
        self.counters["completed"] += 1
        self.counters["completed_by_prio"][op.priority] += 1
        self.latencies.append(done - op.arrival)

    def _attempt_timeout(self, op: OpRecord, t_detect: float) -> None:
        self.counters["attempt_timeouts"] += 1
        if op.attempts > self.cfg.max_retries:
            self._fail(op, t_detect)
            return
        self.counters["retries"] += 1
        back = self.cfg.backoff_s * (2.0 ** (op.attempts - 1))
        back *= 1.0 + 0.25 * float(self.rng.random())
        op.attempts += 1
        op.submit_t = t_detect + back
        op.deadline = op.submit_t + self.cfg.deadline_s
        op.dispatch_t = -1.0
        heapq.heappush(self.pending, (op.submit_t, self._tick(), op))

    def _fail(self, op: OpRecord, t: float) -> None:
        op.status = FAILED
        op.done_t = t
        self._open_writes.discard(op.req_id)
        self.counters["failed"] += 1
        if op.kind != 0 and not op.dispatched_ever:
            self.never_applied_reqs.append(op.req_id)

    # ----- linearizability history ----------------------------------------
    def history(self) -> list:
        """The run as a linearizability history (``core.
        linearizability.Op``), honoring indeterminacy:

          * completed ops are definite (reads only meaningful with
            ``record_values=True``; hedge-win reads are skipped -- the
            modeled hedge returns no value);
          * failed/censored *writes that reached the data plane* are
            indeterminate (``status="maybe"``: the checker may include
            or exclude them);
          * shed and never-dispatched ops are guaranteed no-ops and are
            excluded (their request IDs are in ``never_applied_reqs``
            for the no-op assertion)."""
        from .linearizability import Op
        out = []
        for op in self.records:
            if op.status == COMPLETED:
                if op.kind == 0:
                    if self.cfg.record_values and not op.hedge_win:
                        out.append(Op("read", op.key, op.value,
                                      op.arrival, op.done_t))
                elif op.kind == 1:
                    out.append(Op("write", op.key, op.payload,
                                  op.arrival, op.done_t))
                else:
                    out.append(Op("write", op.key, None,
                                  op.arrival, op.done_t))
            elif op.status in (FAILED, INFLIGHT) and op.kind != 0 \
                    and op.dispatched_ever:
                val = op.payload if op.kind == 1 else None
                out.append(Op("write", op.key, val, op.arrival, _INF,
                              status="maybe"))
        return out
