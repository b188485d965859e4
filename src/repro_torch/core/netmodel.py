"""Calibrated network / DPM cost model (the paper's testbed, Sec. 5):
the port's copy of ``NetModel`` and ``DEFAULT_MODEL``.

The functional plane counts RTs an op exactly; this model converts RT
counts and byte volumes into throughput and latency the way the paper's
InfiniBand testbed would (FDR ConnectX-3 at 56 Gbps a port, 3 us
one-sided verbs, Optane DC at 32 GB/s read and 11.2 GB/s write, DPM merge
throughput scaling with DPM threads, 8 KN threads). The open-loop
arrival processes of the request plane (``ArrivalProcess``,
``PhasedArrival``) are ported too, draw for draw:
tests/test_torch_requestplane.py holds their arrays and the generators'
states after each call to the reference's.
"""

from __future__ import annotations

import dataclasses
import warnings

import numpy as np


@dataclasses.dataclass(frozen=True)
class NetModel:
    """Cost model parameters. All rates per second, sizes in bytes."""

    rt_latency_s: float = 3e-6          # one-sided RDMA verb RT
    rpc_latency_s: float = 12e-6        # two-sided RPC RT (metadata server)
    kn_link_bw: float = 7e9             # per-KN NIC bandwidth (FDR)
    dpm_link_bw: float = 7e9            # DPM pool NIC bandwidth (shared)
    pm_read_bw: float = 32e9            # PM device read bandwidth
    pm_write_bw: float = 11.2e9         # PM device write bandwidth
    kn_cpu_ops: float = 1.5e6           # request-processing capacity per KN (8 thr)
    # DPM-side merge capacity: ops/s per DPM thread (measured in Fig. 4 style
    # microbench; PM is ~16% below DRAM at 4 threads).
    merge_ops_per_thread_dram: float = 1.75e6   # 4 thr ~= log-write max (Fig. 4)
    merge_ops_per_thread_pm: float = 1.47e6     # ~16% below DRAM at 4 thr
    dpm_threads: int = 4
    # Clover metadata-server capacity (4 worker threads, two-sided RPCs).
    clover_ms_ops: float = 2.6e6
    header_bytes: int = 64              # per-message header/verb overhead
    # effective data-reorganization rate for shared-nothing resharding
    # (read + rewrite + index rebuild; calibrated to the paper's ~11 s
    # for 1/16th of a 32 GB dataset)
    reorg_bw: float = 190e6
    # ---- failure / reconfiguration timing (Figs. 6-8) ---------------------
    # heartbeat-miss failure detection at the M-node (paper Sec. 3.6)
    detect_s: float = 0.04
    # ownership-handoff metadata publish after a reconfiguration merge
    # (new owners fetch the map + start serving)
    handoff_s: float = 0.05
    # Clover: all clients refresh metadata-server membership on failure
    clover_refresh_s: float = 0.068

    # ---- throughput model -------------------------------------------------
    def op_net_bytes(self, rts_per_op: float, value_bytes: int,
                     value_rt_fraction: float = 0.55) -> float:
        """Average wire bytes per op: each RT carries a header; a fraction of
        RTs carry the value payload (index probes carry a bucket line)."""
        per_rt = self.header_bytes + value_rt_fraction * value_bytes \
            + (1.0 - value_rt_fraction) * 64.0
        return max(rts_per_op, 1e-3) * per_rt

    def kn_capacity(self, rts_per_op: float, value_bytes: int) -> float:
        """Single-KN throughput cap = min(CPU, NIC)."""
        net = self.kn_link_bw / self.op_net_bytes(rts_per_op, value_bytes)
        return min(self.kn_cpu_ops, net)

    def dpm_net_capacity(self, rts_per_op: float, value_bytes: int) -> float:
        """Aggregate cap imposed by the DPM pool NIC (all KNs share it)."""
        return self.dpm_link_bw / self.op_net_bytes(rts_per_op, value_bytes)

    def merge_capacity(self, on_pm: bool = False,
                       threads: int | None = None) -> float:
        thr = self.dpm_threads if threads is None else threads
        per = self.merge_ops_per_thread_pm if on_pm \
            else self.merge_ops_per_thread_dram
        return per * thr

    def cluster_throughput(self, *, num_kns: int, rts_per_op: float,
                           value_bytes: int, write_fraction: float,
                           load_shares: list[float] | None = None,
                           on_pm: bool = False,
                           metadata_server_cap: float | None = None,
                           ms_load_fraction: float = 1.0,
                           top_key_share: float = 0.0) -> float:
        """Closed-loop aggregate throughput (ops/s) for the cluster.

        ``load_shares``: per-KN request fractions; the system saturates
        when the busiest KN saturates. ``top_key_share``: effective load
        share of the hottest single-owner key (share / replication
        factor) -- paper Sec. 3.4: max single-key throughput is bounded
        by one KN's capacity. ``ms_load_fraction``: fraction of ops that
        touch Clover's metadata server (misses + writes)."""
        kn_cap = self.kn_capacity(rts_per_op, value_bytes)
        if load_shares is None:
            load_shares = [1.0 / num_kns] * num_kns
        busiest = max(load_shares)
        balanced = kn_cap / busiest if busiest > 0 else float("inf")
        caps = [balanced, self.dpm_net_capacity(rts_per_op, value_bytes)]
        if write_fraction > 0:
            caps.append(self.merge_capacity(on_pm=on_pm) / write_fraction)
        if metadata_server_cap is not None:
            caps.append(metadata_server_cap
                        / max(ms_load_fraction, 1e-2))
        if top_key_share > 0:
            caps.append(self.kn_cpu_ops / top_key_share)
        return min(caps)

    def kn_local_throughput(self, rts_per_op: float,
                            inflight: int = 32,
                            base_s: float = 1e-6) -> float:
        """Closed-loop peak throughput measured *within* a KN (paper
        Fig. 3 microbench: workload generated locally, no client hop):
        limited by inflight ops / per-op latency, capped by CPU."""
        lat = base_s + rts_per_op * self.rt_latency_s
        return min(inflight / lat, 16 * 1.2e6)   # 16 threads in Fig. 3

    # ---- latency model ----------------------------------------------------
    # client<->KN hop over 10GbE + KN request processing
    client_hop_s: float = 15e-6

    def service_time(self, rts_per_op: float,
                     two_sided_rts: float = 0.0) -> float:
        """In-service latency of one op once it reaches the head of a
        KN's queue: the client hop plus its RDMA round-trips (Table 5 RT
        counts) plus any two-sided RPCs."""
        return (self.client_hop_s + rts_per_op * self.rt_latency_s
                + two_sided_rts * self.rpc_latency_s)

    def request_latency(self, rts_per_op: float, *,
                        queue_depth: float = 0.0,
                        service_rate: float | None = None,
                        two_sided_rts: float = 0.0) -> float:
        """End-to-end request latency (s) = queue wait + service.

        ``queue_depth`` is the number of ops ahead of this one in its
        KN's bounded FIFO; ``service_rate`` is the KN's drain rate
        (ops/s, e.g. ``kn_capacity``).  With ``service_rate=None`` the
        wait models back-to-back service of the queued ops at this op's
        own service time -- the single-server M/M/1-style view the old
        ``queue_factor`` heuristic approximated."""
        svc = self.service_time(rts_per_op, two_sided_rts)
        depth = max(queue_depth, 0.0)
        if service_rate is not None and service_rate > 0.0:
            wait = depth / service_rate
        else:
            wait = depth * svc
        return wait + svc

    def op_latency(self, rts_per_op: float, queue_factor: float = 1.0,
                   two_sided_rts: float = 0.0) -> float:
        """Deprecated shim over :meth:`request_latency`.

        The old closed-loop model inflated service latency by an ad-hoc
        ``queue_factor``; the open-loop request plane derives the wait
        from a real queue depth instead.  A factor of ``q`` is exactly a
        queue of ``q - 1`` ops each costing one service time, so the
        shim delegates with ``queue_depth = queue_factor - 1`` and stays
        numerically identical to the old formula."""
        warnings.warn(
            "NetModel.op_latency(queue_factor=...) is deprecated; use "
            "request_latency(queue_depth=..., service_rate=...) with a "
            "queue depth from the open-loop request plane",
            DeprecationWarning, stacklevel=2)
        return self.request_latency(rts_per_op,
                                    queue_depth=max(queue_factor, 1.0) - 1.0,
                                    two_sided_rts=two_sided_rts)



# --------------------------------------------------------------------------
# Open-loop arrival processes (the offered-load side of the request
# plane).  A closed-loop client waits for each response before issuing
# the next request and therefore cannot overload the service; real
# traffic does not wait.  Both processes are seeded-deterministic.
# --------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class ArrivalProcess:
    """Poisson or bursty (two-state modulated Poisson) arrivals.

    ``kind="poisson"``: exponential inter-arrivals at ``rate``.
    ``kind="bursty"``: an on/off modulated Poisson process -- bursts of
    mean length ``burst_s`` arrive at ``rate * burst_factor``, separated
    by quiet periods whose length keeps the long-run mean at ``rate``
    (so a bursty process is load-comparable to a Poisson one)."""

    rate: float                      # long-run mean ops/s
    kind: str = "poisson"            # "poisson" | "bursty"
    burst_factor: float = 4.0        # peak rate multiplier inside a burst
    burst_s: float = 0.2             # mean burst duration

    def __post_init__(self):
        if self.kind not in ("poisson", "bursty"):
            raise ValueError(f"unknown arrival kind {self.kind!r}")
        if self.kind == "bursty" and self.burst_factor <= 1.0:
            raise ValueError("burst_factor must exceed 1.0")

    def _phase_rate(self, t: float) -> float:
        """Instantaneous rate at time ``t`` (deterministic phase
        schedule: bursts tile the timeline so every seed sees the same
        on/off windows and runs stay replayable)."""
        if self.kind == "poisson":
            return self.rate
        # duty cycle keeping the long-run mean at `rate`:
        #   on_frac * burst_factor + (1 - on_frac) * low = 1, low = 0.1
        low = 0.1
        on_frac = (1.0 - low) / (self.burst_factor - low)
        period = self.burst_s / max(on_frac, 1e-9)
        in_burst = (t % period) < self.burst_s
        return self.rate * (self.burst_factor if in_burst else low)

    def arrivals(self, rng: np.random.Generator, t0: float,
                 t1: float) -> np.ndarray:
        """Arrival timestamps in [t0, t1), sorted ascending.  Sampled by
        thinning against the max phase rate, so Poisson statistics hold
        within each phase."""
        peak = self.rate * (self.burst_factor
                            if self.kind == "bursty" else 1.0)
        if peak <= 0.0 or t1 <= t0:
            return np.empty(0, np.float64)
        n = rng.poisson(peak * (t1 - t0))
        if n == 0:
            return np.empty(0, np.float64)
        ts = np.sort(t0 + rng.random(n) * (t1 - t0))
        if self.kind == "poisson":
            return ts
        keep = rng.random(n) < np.array(
            [self._phase_rate(t) / peak for t in ts.tolist()])
        return ts[keep]

    def scaled(self, factor: float) -> "ArrivalProcess":
        """The same process at ``rate * factor`` (the request plane's
        op-scaling: utilization is rate/capacity, so scaling both by the
        same factor preserves queueing behavior)."""
        return dataclasses.replace(self, rate=self.rate * factor)


@dataclasses.dataclass(frozen=True)
class PhasedArrival:
    """A piecewise arrival schedule: ``phases`` is a tuple of
    (duration_s, ArrivalProcess) segments laid end to end from ``t0``;
    past the last segment the final process keeps running.  Lets one
    open-loop run carry queue backlog across load phases (baseline ->
    overload -> recovery), which is exactly what graceful-degradation
    SLOs measure."""

    phases: tuple
    t0: float = 0.0

    @property
    def rate(self) -> float:
        tot = sum(d for d, _ in self.phases)
        if tot <= 0.0:
            return 0.0
        return sum(d * p.rate for d, p in self.phases) / tot

    def phase_at(self, t: float) -> ArrivalProcess:
        rel = t - self.t0
        for d, p in self.phases:
            if rel < d:
                return p
            rel -= d
        return self.phases[-1][1]

    def arrivals(self, rng: np.random.Generator, t0: float,
                 t1: float) -> np.ndarray:
        out = []
        edge = self.t0
        for i, (d, p) in enumerate(self.phases):
            lo, hi = edge, edge + d
            if i == len(self.phases) - 1:
                hi = max(hi, t1)
            a, b = max(t0, lo), min(t1, hi)
            if b > a:
                out.append(p.arrivals(rng, a, b))
            edge += d
        if not out:
            return np.empty(0, np.float64)
        return np.concatenate(out)

    def scaled(self, factor: float) -> "PhasedArrival":
        return PhasedArrival(tuple((d, p.scaled(factor))
                                   for d, p in self.phases), self.t0)


DEFAULT_MODEL = NetModel()
