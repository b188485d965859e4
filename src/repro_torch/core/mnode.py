"""M-node: monitoring/management policy engine (paper Sec. 3.5, Table 4);
the port's copy of the reference's, decision for decision.

Every decision epoch the M-node collects latency stats (from clients),
KN occupancy (CPU working time per epoch), and per-key access
frequencies, then emits at most one membership change per epoch (plus a
grace period) and replication-factor changes:

  SLO        KN occupancy   key freq    action
  satisfied  low            -           remove KN
  violated   high           -           add new KN
  violated   normal         high        replicate key
  satisfied  normal         low         de-replicate key
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field


@dataclass(frozen=True)
class PolicyConfig:
    avg_latency_slo: float = 1.2e-3
    tail_latency_slo: float = 16e-3
    over_util_lower: float = 0.20      # all KNs above -> cluster over-utilized
    under_util_upper: float = 0.10     # any KN below  -> candidate for removal
    hotness_sigmas: float = 3.0        # freq > mean + k*std -> hot
    coldness_sigmas: float = 1.0       # freq < mean - k*std -> cold
    grace_period_s: float = 90.0
    epoch_s: float = 10.0
    min_kns: int = 1
    max_kns: int = 16


@dataclass
class EpochStats:
    now: float
    avg_latency: float
    p99_latency: float
    occupancy: dict[str, float]             # KN -> [0,1]
    key_freq: dict[int, float]              # sampled hot-key frequencies (ops/s)
    replication: dict[int, int]             # key -> current factor R


@dataclass
class Action:
    kind: str            # "add_kn" | "remove_kn" | "replicate" | "dereplicate"
    node: str | None = None
    key: int | None = None
    factor: int | None = None


class PolicyEngine:
    def __init__(self, cfg: PolicyConfig):
        self.cfg = cfg
        self._last_membership_change = -math.inf
        # (epoch time, action kind) per decision -- the scenario
        # harness's churn/storm accounting
        self.decision_log: list[tuple[float, str]] = []

    def slo_violated(self, s: EpochStats) -> bool:
        return (s.avg_latency > self.cfg.avg_latency_slo
                or s.p99_latency > self.cfg.tail_latency_slo)

    def decide(self, s: EpochStats) -> list[Action]:
        cfg = self.cfg
        actions: list[Action] = []
        if not s.occupancy:
            return actions
        in_grace = (s.now - self._last_membership_change) < cfg.grace_period_s
        violated = self.slo_violated(s)
        occ = s.occupancy
        min_occ_kn = min(occ, key=occ.get)
        all_over = min(occ.values()) > cfg.over_util_lower

        freqs = list(s.key_freq.values())
        mean = sum(freqs) / len(freqs) if freqs else 0.0
        std = (sum((f - mean) ** 2 for f in freqs) / len(freqs)) ** 0.5 \
            if freqs else 0.0
        hot = {k for k, f in s.key_freq.items()
               if std > 0 and f > mean + cfg.hotness_sigmas * std}
        cold = {k for k, f in s.key_freq.items()
                if f < mean - cfg.coldness_sigmas * std}

        if violated:
            if all_over and not in_grace:
                if len(occ) < cfg.max_kns:
                    actions.append(Action("add_kn"))
                    self._last_membership_change = s.now
            elif hot:
                # replicate hot keys; R grows with latency-to-SLO ratio
                ratio = max(s.avg_latency / cfg.avg_latency_slo,
                            s.p99_latency / cfg.tail_latency_slo)
                for k in sorted(hot):
                    cur = s.replication.get(k, 1)
                    target = min(len(occ),
                                 max(cur + 1, math.ceil(cur * ratio)))
                    if target > cur:
                        actions.append(Action("replicate", key=k,
                                              factor=target))
        else:
            if occ[min_occ_kn] < cfg.under_util_upper and not in_grace \
                    and len(occ) > cfg.min_kns:
                actions.append(Action("remove_kn", node=min_occ_kn))
                self._last_membership_change = s.now
            else:
                for k, r in s.replication.items():
                    if r > 1 and k in cold:
                        actions.append(Action("dereplicate", key=k))
        self.decision_log.extend((s.now, a.kind) for a in actions)
        return actions

    def note_failure(self, now: float) -> None:
        """Failures force a membership change outside the grace logic."""
        self._last_membership_change = now
