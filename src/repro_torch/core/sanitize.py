"""Runtime ownership-write sanitizer (``REPRO_SANITIZE=1``).

The port's copy of the reference's ``core/sanitize.py``, behaviour for
behaviour. It reads the same ``REPRO_SANITIZE`` variable as the
reference, so that one environment runs both packages' sanitizer cases;
the variable turns on a write barrier and never chooses a device.

DINOMO's ownership-partitioning invariant (paper Sec. 3): every key has
exactly one owner KN, and only that owner's request/window/merge/
recovery machinery may mutate the per-KN soft state backing it.  The
reference's static passes prove shape (plan functions cannot
mutate); this module proves *attribution at runtime*: under
``REPRO_SANITIZE=1`` every array-backed KN cache is wrapped in a
write-barrier ndarray subclass, and any mutation performed outside the
owning KN's declared execution context raises
:class:`OwnershipViolation` at the exact offending store.

Contexts are declared by the engine, not inferred from the call stack
(stack inspection per element store would be ruinously slow):

- ``owned(kn_name)`` -- the scalar read/write paths, the per-KN batched
  windows, and the replicated-op executor push the KN whose state they
  are entitled to mutate.
- ``management()`` -- reconfiguration, recovery, (de)replication, warm
  load, and the shared-everything Clover plane (which has no ownership
  partition to enforce) may touch any KN's soft state.

Everything is free when disabled: ``owned``/``management`` return a
shared no-op context manager and no cache is ever wrapped, so the
default (non-sanitizing) runs execute the exact same code paths.

Mechanics worth knowing before editing:

- Guard propagation follows *views only*.  ``__array_finalize__`` keeps
  the owner tag iff the new array actually shares memory with its
  parent (``base is not None`` + ``may_share_memory``).  Copies --
  fancy-index gathers, ufunc results, ``np.concatenate`` growth -- come
  out unguarded, which is load-bearing: the pure planners gather cache
  vectors into scratch copies and mutate those freely.
- Cache classes rebind their arrays wholesale when they grow
  (``_ensure`` -> ``np.concatenate``), which would silently shed the
  guard; ``guard_cache`` therefore swaps the instance onto a dynamic
  subclass whose ``__setattr__`` re-wraps any plain ndarray being
  bound while the instance carries an owner tag.
"""

from __future__ import annotations

import os

import numpy as np

__all__ = ["OwnershipViolation", "enabled", "enable", "disable",
           "owned", "management", "current", "GuardedArray",
           "guard_cache", "MANAGEMENT"]

#: context tag that may mutate any KN's state (reconfig/recovery/load)
MANAGEMENT = "*"

_ENABLED = os.environ.get("REPRO_SANITIZE", "0") not in ("", "0")
_CTX: list[str] = []       # stack of owner tags; last entry wins


class OwnershipViolation(AssertionError):
    """A per-KN array was mutated outside its owner's context."""


def enabled() -> bool:
    return _ENABLED


def enable() -> None:
    global _ENABLED
    _ENABLED = True


def disable() -> None:
    global _ENABLED
    _ENABLED = False
    _CTX.clear()


def current() -> str | None:
    """The innermost active context tag (a KN name or ``MANAGEMENT``)."""
    return _CTX[-1] if _CTX else None


class _Ctx:
    __slots__ = ("tag",)

    def __init__(self, tag: str):
        self.tag = tag

    def __enter__(self):
        _CTX.append(self.tag)
        return self

    def __exit__(self, *exc):
        _CTX.pop()
        return False


class _NullCtx:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL = _NullCtx()


def owned(kn_name: str):
    """Declare that the enclosed block acts on behalf of ``kn_name``."""
    return _Ctx(str(kn_name)) if _ENABLED else _NULL


def management():
    """Declare a management block (reconfig/recovery/replication/load)
    entitled to mutate any KN's soft state."""
    return _Ctx(MANAGEMENT) if _ENABLED else _NULL


class GuardedArray(np.ndarray):
    """ndarray with an owner write barrier.

    ``_repro_owner`` is the owning KN's name, or None for an unguarded
    instance (copies and ufunc results degrade to unguarded -- only
    true views of a guarded buffer keep the barrier)."""

    def __array_finalize__(self, obj):
        owner = getattr(obj, "_repro_owner", None)
        if owner is not None and self.base is not None \
                and np.may_share_memory(self, obj):
            self._repro_owner = owner
        else:
            self._repro_owner = None

    def _check_write(self) -> None:
        owner = self._repro_owner
        if owner is None:
            return
        ctx = _CTX[-1] if _CTX else None
        if ctx == owner or ctx == MANAGEMENT:
            return
        raise OwnershipViolation(
            f"write to KN {owner!r}-owned array from context "
            f"{ctx!r} (expected {owner!r} or management)")

    # ----- mutation entry points -------------------------------------------
    def __setitem__(self, idx, value):
        self._check_write()
        np.ndarray.__setitem__(self, idx, value)

    def fill(self, value):
        self._check_write()
        np.ndarray.fill(self, value)

    def sort(self, *a, **kw):
        self._check_write()
        np.ndarray.sort(self, *a, **kw)

    def __array_ufunc__(self, ufunc, method, *inputs, **kw):
        # in-place ufuncs (+=, np.add.at, explicit out=) hit the
        # barrier; all guarded operands are then unwrapped to plain
        # views (the numpy-documented delegation pattern -- ndarray's
        # own __array_ufunc__ refuses mixed-override operands), so
        # computed results come out as plain, unguarded ndarrays.
        out = kw.get("out")
        if out is not None:
            outs = out if isinstance(out, tuple) else (out,)
            for o in outs:
                if isinstance(o, GuardedArray):
                    o._check_write()
            kw["out"] = tuple(
                o.view(np.ndarray) if isinstance(o, GuardedArray) else o
                for o in outs)
        elif method == "at" and inputs and \
                isinstance(inputs[0], GuardedArray):
            inputs[0]._check_write()
        inputs = tuple(
            i.view(np.ndarray) if isinstance(i, GuardedArray) else i
            for i in inputs)
        return getattr(ufunc, method)(*inputs, **kw)


_SUBCLASSES: dict[type, type] = {}


def _guarded_subclass(cls: type) -> type:
    sub = _SUBCLASSES.get(cls)
    if sub is None:
        def __setattr__(self, name, value):
            owner = getattr(self, "_repro_owner", None)
            if owner is not None and isinstance(value, np.ndarray) \
                    and not isinstance(value, GuardedArray):
                g = value.view(GuardedArray)
                g._repro_owner = owner
                value = g
            object.__setattr__(self, name, value)

        sub = type("Guarded" + cls.__name__, (cls,),
                   {"__setattr__": __setattr__})
        _SUBCLASSES[cls] = sub
    return sub


def guard_cache(cache, owner: str):
    """Bind every ndarray attribute of an array-backed cache to
    ``owner`` behind the write barrier.  Dict-backed caches (the
    reference oracles) have no bulk arrays and are returned unchanged.
    Idempotent; returns the cache either way."""
    d = getattr(cache, "__dict__", None)
    if d is None or not any(isinstance(v, np.ndarray) for v in d.values()):
        return cache
    owner = str(owner)
    object.__setattr__(cache, "_repro_owner", owner)
    cls = type(cache)
    if cls not in _SUBCLASSES.values():
        cache.__class__ = _guarded_subclass(cls)
    for nm, v in list(d.items()):
        if nm == "_repro_owner" or not isinstance(v, np.ndarray):
            continue
        if isinstance(v, GuardedArray):
            v._repro_owner = owner     # re-tag in place
        else:
            setattr(cache, nm, v)      # re-route through the barrier wrap
    return cache
