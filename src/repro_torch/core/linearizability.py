"""Linearizability checker for key-value histories (paper Sec. 3.2): the
port's copy of the reference's checker, verdict for verdict (pure
Python; tests/test_torch_linearizability.py holds the two equal).

DINOMO guarantees linearizable reads/writes. Because ownership
partitioning gives every key an independent, single-owner timeline,
linearizability decomposes per key (locality property of
linearizability, Herlihy & Wing): we check each key's sub-history with
an exhaustive Wing-Gong search (histories in tests are small).

Events carry real-time invocation/response intervals; concurrent
operations may be ordered either way, sequential ones must respect
real time.

Open-loop histories add *indeterminate* operations (``status=
"maybe"``): a write whose client timed out may or may not have taken
effect.  An indeterminate op has no response, so it never real-time-
precedes anything, and the checker may either linearize it (its effect
landed after invocation) or exclude it entirely (it never applied) --
the standard treatment of info/timeout ops in Jepsen-style checkers.
Shed operations are guaranteed clean no-ops and should simply be left
out of the history (the request plane asserts their request IDs never
registered).

Fenced operations (``status="fenced"``) are writes a stale-epoch owner
attempted after an ownership handoff: the DPM fence rejected them as
guaranteed no-ops (``FencedWrite``), so the checker *drops* them from
the history before searching.  This is deliberately stronger than
``"maybe"``: if a fence ever leaked and a reader observed a zombie's
value, no linearization can explain the read and the history fails --
whereas an indeterminate op could legally be linearized, masking the
leak."""

from __future__ import annotations

import math
from dataclasses import dataclass
from itertools import permutations


@dataclass(frozen=True)
class Op:
    kind: str          # "read" | "write"
    key: int
    value: object      # written value, or value returned by the read
    invoke: float
    respond: float
    client: str = "c0"
    # "ok" (definite) | "maybe" (indeterminate) | "fenced" (guaranteed
    # no-op: a stale-epoch write the DPM fence rejected)
    status: str = "ok"


def _eff_respond(op: Op) -> float:
    """Indeterminate ops have no observed response: they constrain no
    real-time order (their linearization point can be arbitrarily
    late)."""
    return math.inf if op.status != "ok" else op.respond


def _check_sequence(ops: list[Op], initial) -> bool:
    """Is this total order a legal sequential KV execution?"""
    cur = initial
    for op in ops:
        if op.kind == "write":
            cur = op.value
        else:
            if op.value != cur:
                return False
    return True


def _respects_realtime(order: list[Op]) -> bool:
    for i, a in enumerate(order):
        for b in order[i + 1:]:
            if _eff_respond(b) < a.invoke:   # b finished before a started
                return False
    return True


def check_key_history(ops: list[Op], initial=None,
                      max_exhaustive: int = 8) -> bool:
    """True iff the per-key history is linearizable.  Ops with
    ``status="maybe"`` may be included or excluded by the search;
    ``status="fenced"`` ops are guaranteed no-ops and are dropped."""
    ops = sorted((o for o in ops if o.status != "fenced"),
                 key=lambda o: o.invoke)
    if any(o.status != "ok" for o in ops) or len(ops) > max_exhaustive:
        return _dfs(ops, initial)
    for perm in permutations(ops):
        order = list(perm)
        if _respects_realtime(order) and _check_sequence(order, initial):
            return True
    return False


def _dfs(pending: list[Op], value) -> bool:
    if not pending:
        return True
    # candidates: ops whose invocation precedes every other response
    min_resp = min(_eff_respond(o) for o in pending)
    for i, op in enumerate(pending):
        if op.invoke > min_resp:
            continue
        if op.kind == "read" and op.value != value:
            continue
        rest = pending[:i] + pending[i + 1:]
        nxt = op.value if op.kind == "write" else value
        if _dfs(rest, nxt):
            return True
    # exclusion branches: an indeterminate op may simply never have
    # taken effect -- drop it and retry (exclusions commute, and test
    # histories are small, so the duplicate exploration is acceptable)
    for i, op in enumerate(pending):
        if op.status != "ok":
            if _dfs(pending[:i] + pending[i + 1:], value):
                return True
    return False


def check_history(ops: list[Op], initial=None) -> dict[int, bool]:
    """Check a full multi-key history; returns per-key verdicts.
    ``initial`` may be a scalar (same initial value for all keys), a
    dict keyed by key, or a callable key -> value."""
    by_key: dict[int, list[Op]] = {}
    for op in ops:
        by_key.setdefault(op.key, []).append(op)
    def init_of(k):
        if callable(initial):
            return initial(k)
        if isinstance(initial, dict):
            return initial.get(k)
        return initial
    return {k: check_key_history(v, init_of(k)) for k, v in by_key.items()}
