"""Spans and counters inside the DPM pool's batched calls, off by default.

A span is a named interval of host time with the span that was open when
it began (its parent); a counter is a host integer. They mark where the
work of ``kernels/clht_probe/ops.py:kvs_lookup`` and
``kernels/log_merge/ops.py:log_append_merge`` happens:

==========================================  ==============================
``dinomo.kvs_lookup``                       one read batch (root)
``dinomo.kvs_lookup.probe``                 ``bucket_of`` and kernel B's
                                            launch
``dinomo.kvs_lookup.walk_test`` (wait)      ``_needs_chain_walk``: its
                                            ``nonzero`` waits for kernel B
``dinomo.kvs_lookup.chain_walk``            ``clht_lookup`` on the keys
                                            that missed a chained bucket,
                                            the row gather, the scatters
``dinomo.log_append_merge``                 one write batch (root)
``dinomo.log_append_merge.append``          ``heap_append``, ``log_append``
``dinomo.log_append_merge.merge``           ``log_merge``: the sort,
                                            kernel C, the un-permute
``dinomo.log_merge.group_starts`` (wait)    ``sort_by_bucket``: the group
                                            starts' ``nonzero``
``dinomo.log_merge.group_end`` (wait)       ``sort_by_bucket``: the entry
                                            count copied to the device
``dinomo.log_append_merge.slow_test``       ``merge_segment_fast``: the
(wait)                                      ``nonzero`` of the entries
                                            whose bucket was full
``dinomo.log_append_merge.slow_path``       ``clht_insert`` (kernel D) on
                                            those entries
==========================================  ==============================

Counters: ``dinomo.kvs_lookup.keys`` (keys read) and
``dinomo.kvs_lookup.walked_keys`` (keys handed to the chain walk).

Every blocking host sync inside the two calls is a span marked ``wait``,
so the count of wait spans is the count of host syncs. ``NAMES`` and
``COUNTERS`` list every name the program uses.

The facility is off until ``enable()``. Off, ``span`` returns one shared
null context and ``count`` returns at once: no clock is read and nothing
is kept. On, each span keeps ``(name, parent, start_ns, end_ns, wait)``
on ``time.perf_counter_ns``, in memory until ``reset()``; ``summary()``
folds them by name. On while the torch profiler runs, each span also
opens a ``record_function`` range of its name, so the program's stages
sit in the profiler's trace on the clock of the device's operations.
The switch is ``enable()`` / ``disable()`` alone: no environment
variable and no argument of any call.

The always-on counters elsewhere in the port stay as they are:
``kernels/_build.py``'s ``launches`` and ``work``, and
``core/transition.py``'s ``ENGINE_WALL``, ``PLAN_STATS`` and
``MERGE_PLAN_STATS``; their readers need them on.
"""

from __future__ import annotations

import contextlib
import time

import torch

NAMES = (
    "dinomo.kvs_lookup",
    "dinomo.kvs_lookup.probe",
    "dinomo.kvs_lookup.walk_test",
    "dinomo.kvs_lookup.chain_walk",
    "dinomo.log_append_merge",
    "dinomo.log_append_merge.append",
    "dinomo.log_append_merge.merge",
    "dinomo.log_merge.group_starts",
    "dinomo.log_merge.group_end",
    "dinomo.log_append_merge.slow_test",
    "dinomo.log_append_merge.slow_path",
)
COUNTERS = ("dinomo.kvs_lookup.keys", "dinomo.kvs_lookup.walked_keys")

_NULL = contextlib.nullcontext()
_clock = time.perf_counter_ns
_profiling = torch.autograd._profiler_enabled
_on = False
_records: list = []           # every _Span entered since reset()
_open: list[int] = []         # indices of the open spans, innermost last
_counts: dict[str, int] = {}


class _Span:
    __slots__ = ("name", "parent", "t0", "t1", "wait", "range")

    def __init__(self, name: str, wait: bool):
        self.name, self.wait, self.t1, self.range = name, wait, 0, None

    def __enter__(self):
        if _profiling():
            self.range = torch.autograd.profiler.record_function(self.name)
            self.range.__enter__()
        self.parent = _open[-1] if _open else -1
        _open.append(len(_records))
        _records.append(self)
        self.t0 = _clock()
        return self

    def __exit__(self, *exc):
        self.t1 = _clock()
        _open.pop()
        if self.range is not None:
            self.range.__exit__(*exc)
        return False


def span(name: str, wait: bool = False):
    """A context that records ``name`` while the facility is on; ``wait``
    marks a span in which the host blocks on the device."""
    if not _on:
        return _NULL
    return _Span(name, wait)


def count(name: str, n: int) -> None:
    """Adds the host integer ``n`` to counter ``name`` while on."""
    if not _on:
        return
    if not isinstance(n, int):
        raise TypeError(f"count {name!r}: a host int, not {type(n).__name__}")
    _counts[name] = _counts.get(name, 0) + n


def enable() -> None:
    global _on
    _on = True


def disable() -> None:
    global _on
    _on = False


def enabled() -> bool:
    return _on


def reset() -> None:
    """Drops every span and counter kept so far."""
    if _open:
        raise RuntimeError("reset inside an open span")
    _records.clear()
    _counts.clear()


def records() -> list[tuple]:
    """The closed spans, as (name, parent index, start_ns, end_ns, wait)
    in the order they opened."""
    return [(r.name, r.parent, r.t0, r.t1, r.wait) for r in _records if r.t1]


def summary() -> dict:
    """``{"spans": {name: {calls, total_s, self_s, wait_s, waits}},
    "counters": {name: n}}`` over the closed spans. ``self_s`` is a
    span's duration less what its child spans cover; ``wait_s`` and
    ``waits`` are the seconds and the number of wait spans in it (a wait
    span counts itself, and nothing inside it)."""
    recs = [(r.name, r.parent, r.t0, r.t1, r.wait) for r in _records]
    n = len(recs)
    child_ns = [0] * n
    wait_ns = [0] * n
    waits = [0] * n
    out: dict[str, dict] = {}
    for i in range(n - 1, -1, -1):     # children come after their parent
        name, parent, t0, t1, wait = recs[i]
        if not t1:
            continue
        dur = t1 - t0
        if wait:
            wait_ns[i], waits[i] = dur, 1
        if parent >= 0:
            child_ns[parent] += dur
            wait_ns[parent] += wait_ns[i]
            waits[parent] += waits[i]
        s = out.setdefault(name, {"calls": 0, "total_s": 0.0, "self_s": 0.0,
                                  "wait_s": 0.0, "waits": 0})
        s["calls"] += 1
        s["total_s"] += dur / 1e9
        s["self_s"] += (dur - child_ns[i]) / 1e9
        s["wait_s"] += wait_ns[i] / 1e9
        s["waits"] += waits[i]
    return {"spans": out, "counters": dict(_counts)}
