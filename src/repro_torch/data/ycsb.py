"""YCSB-style workload generator (paper Sec. 5 'Workloads').

Five request mixes over 8 B keys / 1 KB values with bounded-zipfian key
popularity (the paper's coefficients: 0.5 low, 0.99 moderate -- the
YCSB default -- and 2.0 high skew). np.random.zipf needs a > 1, so we
sample from the exact bounded distribution p(k) ~ 1/rank^s via inverse
CDF, with a splitmix scramble so popular ranks are spread over the
keyspace (YCSB's 'scrambled zipfian').

``distribution="latest"`` selects YCSB's latest distribution instead:
popularity is zipfian over *recency of insertion* -- rank 0 is the most
recently inserted key -- so read-mostly insert mixes behave like
YCSB-D (reads chase the insert frontier).  The recency window tracks
``_next_insert`` as inserts grow the keyspace; no scramble is applied
(recent keys are the hot set by construction).

The streams are the reference generator's, draw for draw; the scramble
is computed with the vectorized mixer so that a keyspace of tens of
millions of keys builds in seconds.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..core.hashring import mix64_batch

MIXES = {
    "read_only": (1.0, 0.0, 0.0),          # (read, update, insert)
    "read_mostly_update": (0.95, 0.05, 0.0),
    "read_mostly_insert": (0.95, 0.0, 0.05),
    "write_heavy_update": (0.5, 0.5, 0.0),
    "write_heavy_insert": (0.5, 0.0, 0.5),
}


@dataclass
class Workload:
    num_keys: int
    zipf: float = 0.99
    mix: str = "read_only"
    value_bytes: int = 1024
    scramble: bool = True
    seed: int = 0
    distribution: str = "zipfian"        # "zipfian" | "latest"

    def __post_init__(self):
        if self.distribution not in ("zipfian", "latest"):
            raise ValueError(f"unknown distribution "
                             f"{self.distribution!r}")
        ranks = np.arange(1, self.num_keys + 1, dtype=np.float64)
        w = ranks ** (-self.zipf)
        self._cdf = np.cumsum(w) / w.sum()
        self._rng = np.random.default_rng(self.seed)
        self._next_insert = self.num_keys
        if self.scramble and self.distribution == "zipfian":
            perm = (mix64_batch(np.arange(self.num_keys))
                    % np.uint64(1 << 62)).astype(np.int64)
            self._scramble = np.argsort(perm)
        else:
            self._scramble = None

    def _sample_keys(self, n: int) -> np.ndarray:
        u = self._rng.random(n)
        ranks = np.searchsorted(self._cdf, u)
        if self.distribution == "latest":
            # zipf over recency: rank 0 == newest inserted key
            return np.maximum(self._next_insert - 1 - ranks, 0)
        if self._scramble is not None:
            ranks = self._scramble[ranks]
        return ranks

    def ops(self, n: int):
        """Yield n (kind, key) pairs; kind in {'read','update','insert'}."""
        r, u, ins = MIXES[self.mix]
        kinds = self._rng.choice(3, size=n, p=[r, u, ins])
        keys = self._sample_keys(n)
        out = []
        for kind, key in zip(kinds, keys):
            if kind == 2:
                out.append(("insert", self._next_insert))
                self._next_insert += 1
            else:
                out.append(("read" if kind == 0 else "update", int(key)))
        return out

    def ops_arrays(self, n: int):
        """Batched ``ops``: (kinds, keys) arrays with kind 0 == read,
        1 == write (update or insert). Consumes the generator's RNG
        exactly like ``ops`` so the two produce identical streams."""
        r, u, ins = MIXES[self.mix]
        kinds3 = self._rng.choice(3, size=n, p=[r, u, ins])
        keys = self._sample_keys(n).astype(np.int64)
        is_ins = kinds3 == 2
        n_ins = int(is_ins.sum())
        if n_ins:
            keys[is_ins] = np.arange(self._next_insert,
                                     self._next_insert + n_ins)
            self._next_insert += n_ins
        return (kinds3 != 0).astype(np.uint8), keys

    def initial_load(self):
        return ((k, f"v{k}") for k in range(self.num_keys))

    def hot_keys(self, top: int = 8) -> list[int]:
        """The `top` most popular keys under this zipf."""
        ranks = np.arange(top)
        if self.distribution == "latest":
            return [max(int(self._next_insert - 1 - r), 0)
                    for r in ranks]
        if self._scramble is not None:
            ranks = self._scramble[ranks]
        return [int(k) for k in ranks]

    def timed(self, t: float, rng, n: int):
        """TimedSimulation adapter: (kind, key) with read/write only."""
        ops = self.ops(n)
        return [("read" if k == "read" else "write", key)
                for k, key in ops]

    def timed_batched(self, t: float, rng, n: int):
        """TimedSimulation adapter for the batched data plane:
        (kinds, keys) arrays, same stream as ``timed``."""
        return self.ops_arrays(n)
