"""Operation-level analysis of an eager run: the port's counterpart of the
reference's ``launch/hlo_analysis.py``.

The reference reads the post-SPMD HLO text that XLA compiles and derives
the roofline terms from it, multiplying loop bodies by their trip
counts. The port has no compiled program to read: a step is a sequence
of aten operations. ``analyze(fn, *args)`` runs ``fn`` once (on meta
tensors for the dry run, where nothing is computed and every operation
still dispatches with its shapes) under
``torch.utils.flop_counter.FlopCounterMode`` and a ``TorchDispatchMode``
that sees every aten operation, and reports:

  * flops             -- FlopCounterMode's count of the matrix products
                         (mm, bmm, addmm, baddbmm, convolutions, SDPA):
                         2 x output elements x contracted dim, the
                         reference's dot rule; a loop runs its body every
                         time, so there is no trip count to recover
  * traffic bytes     -- per operation, the bytes of its tensor operands
                         plus those of its outputs (the elements a tensor
                         reaches, so an expanded view counts once); views
                         bill nothing, and an operation on a view reads the
                         view, not its buffer (the eager counterpart of
                         ``_fusion_operand_bytes``' slice rule); nothing is
                         fused, so every intermediate is written and read
  * traffic_breakdown -- the traffic by aten operation
  * peak_bytes        -- the most bytes held at once by storages that the
                         run made (each storage tracked by weakref from the
                         operation that made it until it is freed): the
                         run's working set beyond its arguments
  * collectives       -- empty, and collective_bytes 0: one device runs no
                         collective; kept so that the records carry the
                         reference's fields

Both packages count the plain attention's products, since the reference
lowers ``mha_ref`` (or its blocked versions) off the TPU and the port
runs them on meta: Sq x Sk scores a head, the masked half of a causal
attention included. The card's causal kernel skips the tiles above the
diagonal and does about half that work.
"""

from __future__ import annotations

import math
import weakref
from dataclasses import dataclass, field
from typing import Any

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import FlopCounterMode

# operations that allocate without reading or writing data
_NO_TRAFFIC = ("empty", "empty_like", "empty_strided", "new_empty",
               "new_empty_strided", "lift_fresh")


@dataclass
class Totals:
    flops: float = 0.0
    bytes: float = 0.0
    collective_bytes: float = 0.0
    collectives: dict = field(default_factory=dict)
    traffic_breakdown: dict = field(default_factory=dict)
    peak_bytes: int = 0
    ops: int = 0
    # what fn returned (not part of a record)
    outputs: Any = field(default=None, repr=False)


def tensor_bytes(t: torch.Tensor) -> int:
    """The bytes of the elements ``t`` reaches: its dims of stride 0 (an
    expanded view) count once."""
    n = math.prod(s for s, st in zip(t.shape, t.stride()) if st != 0)
    return n * t.element_size()


class _Meter(TorchDispatchMode):
    def __init__(self, totals: Totals):
        super().__init__()
        self.totals = totals
        self.traffic: dict[str, float] = {}
        self.tracked: weakref.WeakSet = weakref.WeakSet()
        self.known: weakref.WeakSet = weakref.WeakSet()
        self.live = 0

    def know(self, tensors) -> None:
        """Storages that exist before the run: never counted as made."""
        for t in tensors:
            self.known.add(t.untyped_storage())

    def _free(self, nbytes: int) -> None:
        self.live -= nbytes

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        self.totals.ops += 1
        outs = [t for t in tree_leaves(out) if isinstance(t, torch.Tensor)]
        for t in outs:
            st = t.untyped_storage()
            if st in self.tracked or st in self.known:
                continue
            self.tracked.add(st)
            nbytes = st.nbytes()
            self.live += nbytes
            weakref.finalize(st, self._free, nbytes)
            self.totals.peak_bytes = max(self.totals.peak_bytes, self.live)
        name = func.overloadpacket.__name__
        if func.is_view or name in _NO_TRAFFIC:
            return out
        ins = [t for t in tree_leaves((args, kwargs))
               if isinstance(t, torch.Tensor)]
        b = sum(tensor_bytes(t) for t in ins + outs)
        self.totals.bytes += b
        self.traffic[name] = self.traffic.get(name, 0.0) + b
        return out


def analyze(fn, *args) -> Totals:
    """Run ``fn(*args)`` once under the counters; its result is kept in
    ``outputs``."""
    totals = Totals()
    meter = _Meter(totals)
    meter.know(t for t in tree_leaves(args) if isinstance(t, torch.Tensor))
    with FlopCounterMode(display=False) as flops, meter:
        totals.outputs = fn(*args)
    totals.flops = float(flops.get_total_flops())
    totals.traffic_breakdown = dict(sorted(meter.traffic.items(),
                                           key=lambda kv: -kv[1]))
    return totals
