"""The system under test: the port's device DPM pool.

A pool is a P-CLHT index (``core/clht.py``), one log segment and one value
heap (``core/log.py``) in device memory. Writes go through
``kernels/log_merge/ops.py:log_append_merge`` and reads through
``kernels/clht_probe/ops.py:kvs_lookup``, the calls that the window times.
The modules are looked up at each call, so a test can put a broken
version of a call in their place.
"""

from __future__ import annotations

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if os.path.join(ROOT, "src") not in sys.path:
    sys.path.insert(0, os.path.join(ROOT, "src"))

import torch  # noqa: E402

from repro_torch.core import clht, log  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.clht_probe import ops as probe_ops  # noqa: E402
from repro_torch.kernels.log_merge import ops as merge_ops  # noqa: E402


class PortStore:
    """One device DPM pool of the port, made anew by ``create``."""

    def __init__(self, cfg: dict, device):
        self.records = 1 << cfg["records_log2"]
        self.buckets = 1 << cfg["buckets_log2"]
        self.overflow = 1 << cfg["overflow_buckets_log2"]
        self.segment = 1 << cfg["segment_entries_log2"]
        self.heap_rows = 1 << cfg["heap_rows_log2"]
        self.lanes = cfg["value_lanes"]
        self.device = torch.device(device)
        self.table = self.seg = self.heap = None

    def build(self) -> None:
        """Build the kernel library, or load it from ``build/`` in the
        checkout where an earlier run built it."""
        if self.device.type == "cuda":
            _build.build()

    @staticmethod
    def counters() -> dict:
        """Keys or entries handed to each kernel so far (``_build.work``)."""
        return dict(_build.work)

    def create(self) -> None:
        self.table = clht.clht_init(self.buckets, self.overflow,
                                    device=self.device)
        self.seg = log.segment_init(self.segment, device=self.device)
        self.heap = log.heap_init(self.heap_rows, self.lanes,
                                  device=self.device)

    def release(self) -> None:
        self.table = self.seg = self.heap = None

    def write(self, keys: torch.Tensor, values: torch.Tensor) -> torch.Tensor:
        """Append and merge one batch; returns each write's ok flag."""
        (self.table, self.seg, self.heap, _, _,
         ok) = merge_ops.log_append_merge(self.table, self.seg, self.heap,
                                          keys, values)
        return ok

    def read(self, keys: torch.Tensor):
        """One batch of reads; returns (value rows, found flags)."""
        vals, _, found = probe_ops.kvs_lookup(self.table, self.heap, keys)
        return vals, found
