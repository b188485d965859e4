"""Reading a torch.profiler trace of the traced slice.

The device's busy time is the union of its operations' intervals (kernels,
copies, memsets), so operations that overlap are counted once. A call's
device time is the union of the operations that start inside the
benchmark's span around it (each span ends in a synchronize, and the
next call is issued after it, so no operation of one call starts inside
another's span). An idle gap is named by what the host was doing at its
middle: the benchmark's span, the innermost operator and the innermost
runtime call that contain that instant.
"""

from __future__ import annotations

import bisect
import dataclasses

SPAN = "portbench."          # prefix of the benchmark's own spans
WINDOW = SPAN + "traced"     # the span around the whole traced slice
TOP = 10


@dataclasses.dataclass
class Event:
    name: str
    start_ns: int
    end_ns: int


@dataclasses.dataclass
class Call:
    kind: str                # the span's name after the prefix
    device_s: float          # union of its operations' intervals


@dataclasses.dataclass
class Trace:
    window_s: float
    busy_s: float
    launches: int            # device operations in the window
    calls: list[Call]
    device_ops: list         # [[name, seconds], ...], most time first
    idle_gaps: list          # [[host activity, seconds], ...]

    def calls_of(self, kind: str) -> list[Call]:
        return [c for c in self.calls if c.kind == kind]


def events_of(prof) -> tuple[list[Event], list[Event]]:
    """(device events, host events) of a finished torch.profiler run."""
    device, host = [], []
    for e in prof.profiler.kineto_results.events():
        ev = Event(e.name(), e.start_ns(), e.end_ns())
        if ev.end_ns <= ev.start_ns and not ev.name.startswith(SPAN):
            continue
        if str(e.device_type()).endswith("CUDA"):
            # the profiler mirrors each span onto the device's timeline;
            # only operations count there
            if not ev.name.startswith(SPAN):
                device.append(ev)
        else:
            host.append(ev)
    return device, host


def union(intervals) -> list[tuple[int, int]]:
    """Sorted, merged [start, end) intervals."""
    out: list[list[int]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def covered_ns(intervals) -> int:
    return sum(e - s for s, e in union(intervals))


def _label(active: list[Event]) -> str:
    span = op = rt = None
    for ev in active:
        if ev.name.startswith(SPAN):
            if ev.name != WINDOW:
                span = ev
        elif ev.name.startswith("cuda"):
            if rt is None or ev.start_ns >= rt.start_ns:
                rt = ev
        elif op is None or ev.start_ns >= op.start_ns:
            op = ev
    parts = [x.name for x in (span, op, rt) if x is not None]
    return " > ".join(parts) if parts else "host: outside any call"


def host_activity(host: list[Event], instants: list[int]) -> list[str]:
    """What the host was doing at each of the sorted ``instants``: one
    sweep over the host events in order of their start."""
    order = sorted(host, key=lambda ev: ev.start_ns)
    active: list[Event] = []
    out, i = [], 0
    for t in instants:
        while i < len(order) and order[i].start_ns <= t:
            active.append(order[i])
            i += 1
        active = [ev for ev in active if ev.end_ns > t]
        out.append(_label(active))
    return out


def summarize(device: list[Event], host: list[Event]) -> Trace | None:
    """The trace of the slice inside the ``WINDOW`` span; None if the
    trace holds no device operation there."""
    win = [ev for ev in host if ev.name == WINDOW]
    if not win:
        return None
    w0, w1 = win[0].start_ns, win[0].end_ns
    ops = [ev for ev in device if w0 <= ev.start_ns < w1]
    if not ops:
        return None
    ops.sort(key=lambda ev: ev.start_ns)
    starts = [ev.start_ns for ev in ops]
    busy = union((ev.start_ns, min(ev.end_ns, w1)) for ev in ops)

    calls = []
    for ev in host:
        if ev.name.startswith(SPAN) and ev.name != WINDOW:
            lo = bisect.bisect_left(starts, ev.start_ns)
            hi = bisect.bisect_right(starts, ev.end_ns)
            calls.append(Call(ev.name[len(SPAN):], covered_ns(
                (o.start_ns, o.end_ns) for o in ops[lo:hi]) / 1e9))

    by_name: dict[str, float] = {}
    for ev in ops:
        by_name[ev.name] = by_name.get(ev.name, 0.0) + (
            ev.end_ns - ev.start_ns) / 1e9
    top_ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]

    edges = [w0] + [x for s, e in busy for x in (s, e)] + [w1]
    spans = [(g0, g1) for g0, g1 in zip(edges[::2], edges[1::2]) if g1 > g0]
    gaps: dict[str, float] = {}
    for (g0, g1), who in zip(spans, host_activity(
            host, [(g0 + g1) // 2 for g0, g1 in spans])):
        gaps[who] = gaps.get(who, 0.0) + (g1 - g0) / 1e9
    top_gaps = sorted(gaps.items(), key=lambda kv: -kv[1])[:TOP]

    return Trace(window_s=(w1 - w0) / 1e9,
                 busy_s=sum(e - s for s, e in busy) / 1e9,
                 launches=len(ops), calls=calls,
                 device_ops=[[n[:120], s] for n, s in top_ops],
                 idle_gaps=[[n[:160], s] for n, s in top_gaps])
