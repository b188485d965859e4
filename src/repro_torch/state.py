"""Carry DPM state across planes as plain numpy arrays.

``from_jax_arrays`` builds the port's CLHT / LogSegment / ValueHeap from
the fields of the reference's dataclasses given as numpy arrays (take
them with ``np.array(x)``, a writable copy), and ``to_numpy`` gives the
same fields back, so two planes can start from one state and be compared
field by field. This module imports no JAX.
"""

from __future__ import annotations

import numpy as np
import torch

from .core.clht import CLHT
from .core.log import LogSegment, ValueHeap
from .device import resolve_device
from .kernels.clht_probe.clht_probe import pack_table


def _t(a, dev) -> torch.Tensor:
    """An int32 copy of ``a`` on ``dev`` (never a view of the caller's
    array: the port updates its state in place)."""
    return torch.tensor(np.asarray(a, dtype=np.int32), device=dev)


def from_jax_arrays(*, table: dict | None = None, seg: dict | None = None,
                    heap: dict | None = None, device=None):
    """Build (table, seg, heap) on ``device`` from dicts of the reference's
    field names to numpy arrays (``num_buckets`` may be an int); an
    argument left out gives None in its place."""
    dev = resolve_device(device)
    out_table = out_seg = out_heap = None
    if table is not None:
        out_table = CLHT(
            lines=pack_table(_t(table["keys"], dev), _t(table["ptrs"], dev),
                             _t(table["nxt"], dev)),
            overflow_head=_t(table["overflow_head"], dev).reshape(()),
            num_buckets=int(table["num_buckets"]))
    if seg is not None:
        out_seg = LogSegment(keys=_t(seg["keys"], dev),
                             ptrs=_t(seg["ptrs"], dev),
                             seal=_t(seg["seal"], dev),
                             count=int(seg["count"]),
                             merged=int(seg["merged"]))
    if heap is not None:
        out_heap = ValueHeap(data=_t(heap["data"], dev),
                             head=int(heap["head"]))
    return out_table, out_seg, out_heap


def to_numpy(obj) -> dict:
    """The reference's fields of a port CLHT / LogSegment / ValueHeap as
    numpy arrays (int32; the host registers as 0-d arrays)."""
    np32 = lambda t: t.detach().cpu().numpy().astype(np.int32)
    if isinstance(obj, CLHT):
        return {"keys": np32(obj.keys), "ptrs": np32(obj.ptrs),
                "nxt": np32(obj.nxt),
                "overflow_head": np32(obj.overflow_head),
                "num_buckets": np.array(obj.num_buckets)}
    if isinstance(obj, LogSegment):
        return {"keys": np32(obj.keys), "ptrs": np32(obj.ptrs),
                "seal": np32(obj.seal), "count": np.int32(obj.count),
                "merged": np.int32(obj.merged)}
    if isinstance(obj, ValueHeap):
        return {"data": np32(obj.data), "head": np.int32(obj.head)}
    raise TypeError(f"not a DPM structure: {type(obj).__name__}")
