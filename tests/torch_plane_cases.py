"""Twin clusters and plain values for the parity tests of the planes
around the cluster (the timed simulation, the open-loop request plane,
the scenario harness, the linearizability checker): the reference's
``DinomoCluster`` and the port's (``device="cpu"``), built with the same
arguments and seed, and the planes' results as plain Python values, so
that a twin run compares with ``==``. Every comparison is exact: nothing
in these planes reads a clock."""

import dataclasses
import enum

import numpy as np

from repro.core import cluster as jcl
from repro.core import mnode as jm
from repro_torch.core import cluster as tcl
from repro_torch.core import mnode as tm
from torch_cluster_cases import cluster_state, mirror_equals_host


def plain(x):
    """``x`` with both packages' dataclasses as (class name, fields),
    numpy arrays as (dtype, shape, values), sets sorted and enum members
    as their values: equal across the packages exactly when the two
    objects are."""
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return (type(x).__name__,
                tuple((f.name, plain(getattr(x, f.name)))
                      for f in dataclasses.fields(x)))
    if isinstance(x, np.ndarray):
        return ("ndarray", x.dtype.str, x.shape, x.tolist())
    if isinstance(x, np.generic):
        return x.item()
    if isinstance(x, enum.Enum):
        return x.value
    if isinstance(x, dict):
        return {plain(k): plain(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(plain(v) for v in x)
    if isinstance(x, (set, frozenset)):
        return sorted(plain(v) for v in x)
    return x


def assert_same(a, b, what="") -> None:
    """``plain(a) == plain(b)``, naming the first part that differs."""
    pa, pb = plain(a), plain(b)
    if pa == pb:
        return
    if isinstance(pa, dict) and isinstance(pb, dict):
        assert pa.keys() == pb.keys(), what
        for k in pa:
            assert pa[k] == pb[k], f"{what}: {k}"
    if isinstance(pa, (list, tuple)) and isinstance(pb, (list, tuple)):
        assert len(pa) == len(pb), what
        for i, (u, v) in enumerate(zip(pa, pb)):
            assert u == v, f"{what}: item {i}"
    assert pa == pb, what


class Twin:
    """The reference's cluster and the port's (on the CPU), built alike;
    ``ref`` and ``port``. ``policy``: the fields of a PolicyConfig, built
    in each package."""

    def __init__(self, variant="dinomo", policy=None, **kw):
        self.ref = jcl.DinomoCluster(
            jcl.VARIANTS[variant], **kw,
            policy=jm.PolicyConfig(**policy) if policy else None)
        self.port = tcl.DinomoCluster(
            tcl.VARIANTS[variant], device="cpu", **kw,
            policy=tm.PolicyConfig(**policy) if policy else None)

    @property
    def clusters(self):
        return (self.ref, self.port)

    def load(self, num_keys: int, warm: bool = False) -> None:
        for c in self.clusters:
            c.load(((k, f"v{k}") for k in range(num_keys)), warm=warm)

    def check(self) -> None:
        """The whole states equal, and the port's card copy of its
        index (the plain version here) equal to its host index."""
        a, b = cluster_state(self.ref), cluster_state(self.port)
        for k in a:
            assert a[k] == b[k], k
        mirror_equals_host(self.port.pool)


def sim_state(sim) -> dict:
    """What a timed simulation has decided and recorded: every TimePoint
    field, the event timeline, the outages, the clock and epoch, the
    epoch's key-frequency accumulator, the M-node's decisions and the
    generator's state."""
    return {
        "trace": plain(sim.trace),
        "event_log": plain(sim.event_log),
        "outages": plain(sim.outages),
        "now": sim.now,
        "next_epoch": sim._next_epoch,
        "epoch_total": sim._epoch_total,
        "freq": (sim._ef_keys.tolist(), sim._ef_cnts.tolist()),
        "decisions": plain(sim.c.mnode.decision_log),
        "rng": sim.rng.bit_generator.state,
    }


def assert_sims_equal(a, b, what="") -> None:
    """Two simulations' records equal, part by part."""
    sa, sb = sim_state(a), sim_state(b)
    for k in sa:
        assert sa[k] == sb[k], f"{what}: {k}"
