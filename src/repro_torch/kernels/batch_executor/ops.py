"""Kernel E, the fused batch executor (``csrc/fused_window.cu``): one KN
window of the DAC state machine as one launch over the KN's state on the
card.

``fused_window`` runs up to ``n`` ops of a window -- value and shortcut
hits, Eq. 1 promotions with the make-space loop, prefetch-resolved misses,
staged write fills -- and stops before the first op it cannot decide
exactly (``ref.py``'s cut reasons). It takes and returns what the
reference's ``repro.kernels.batch_executor.fused_window`` does:

    state = (kind, count, stamp, length, ptr, wrote, hist, regs), int32:
            six (S,) arrays (S a power of two), hist (CNT_HIST_MAX + 1,),
            regs (NUM_REGS,)
    ops, keys, wptr, pm_ptr, pm_len, seg0: (W,) int32, the first n live
    -> (n_exec, state', events, out_ptr, cut)

The state is updated in place and returned (the reference donates it);
``n_exec`` and ``cut`` are 0-dim int32 tensors, ``events`` and ``out_ptr``
(W,) int32, all views of one buffer, ``WindowOut.packed`` = [n_exec, cut,
regs (8), events (W), out_ptr (W)], so a caller brings everything back in
one copy.

CPU tensors run the plain version (``ref.fused_window_ref``); CUDA tensors
run the kernel, over two victim min-trees built from the state
(``build_trees``; pass them as ``trees`` to keep them between dispatches
of one resident state, as ``core.jit_engine`` does). Anything else raises.
"""

from __future__ import annotations

import numpy as np
import torch

from ...device import on_cuda
from .. import _build
from .ref import CNT_HIST_MAX, NUM_REGS, fused_window_ref

HEADER = 2 + NUM_REGS          # n_exec, cut, the registers
S_MAX = 1 << 30                # slots the kernel's int32 tree keys address
CUT_BAD_KEY = -1               # the kernel's cut for a key outside [0, S)


class WindowOut(tuple):
    """(n_exec, state', events, out_ptr, cut), with ``packed``: the one
    int32 buffer the scalars, events and out_ptr are views of."""

    packed: torch.Tensor

    def __new__(cls, items, packed):
        self = super().__new__(cls, items)
        self.packed = packed
        return self


def _views(packed: torch.Tensor, state, w: int) -> WindowOut:
    return WindowOut((packed[0], state, packed[HEADER:HEADER + w],
                      packed[HEADER + w:HEADER + 2 * w], packed[1]), packed)


def _check(state, window, n: int):
    if len(state) != 8:
        raise ValueError(f"expected 8 state arrays, got {len(state)}")
    s = state[0].shape[0]
    if s < 2 or s & (s - 1) or s > S_MAX:
        raise ValueError(f"slot count {s} must be a power of two in "
                         f"[2, 2^30]")
    for t in state[:6]:
        if t.shape != (s,):
            raise ValueError(f"state arrays must be ({s},), got "
                             f"{tuple(t.shape)}")
    if state[6].shape != (CNT_HIST_MAX + 1,) or \
            state[7].shape != (NUM_REGS,):
        raise ValueError("hist must be (CNT_HIST_MAX + 1,) and regs "
                         "(NUM_REGS,)")
    w = window[0].shape[0]
    for t in window:
        if t.shape != (w,):
            raise ValueError(f"window arrays must be ({w},), got "
                             f"{tuple(t.shape)}")
    if not 0 <= n <= w:
        raise ValueError(f"n={n} outside [0, {w}]")
    return s, w


def build_trees(state):
    """The LRU and LFU min-trees of a CUDA state ((2S, 2) int32 each: heap
    order, root 1, leaf k at S + k), built on the card; None for a CPU
    state (the plain version scans instead)."""
    kind, count, stamp = state[0], state[1], state[2]
    if not on_cuda(kind, count, stamp):
        return None
    s = kind.shape[0]
    if s < 2 or s & (s - 1) or s > S_MAX:
        raise ValueError(f"slot count {s} must be a power of two in "
                         f"[2, 2^30]")
    for t, name in ((kind, "kind"), (count, "count"), (stamp, "stamp")):
        _build.require(t, name, torch.int32, 1)
    lru = torch.empty((2 * s, 2), dtype=torch.int32, device=kind.device)
    lfu = torch.empty_like(lru)
    _build.run("fused_window_build", kind.data_ptr(), count.data_ptr(),
               stamp.data_ptr(), s, lru.data_ptr(), lfu.data_ptr(),
               _build.stream(kind), kernel="fused_window")
    return lru, lfu


def fused_window(state, ops, keys, wptr, pm_ptr, pm_len, seg0, n, cap,
                 write_bytes, vmax, trees=None) -> WindowOut:
    """Run up to ``n`` window ops (see the module docstring). ``cap`` and
    ``write_bytes`` are the cache's capacity and the staged writes' value
    size, ``vmax`` the promote threshold table (``build_promote_table``).
    ``trees`` (CUDA only) are ``build_trees(state)``, kept valid by the
    launch; without them the call builds its own. The callers' int32
    guards (``core.jit_engine``) keep every value in range."""
    window = (ops, keys, wptr, pm_ptr, pm_len, seg0)
    n, cap, write_bytes = int(n), int(cap), int(write_bytes)
    s, w = _check(state, window, n)
    if not 0 < cap < 2**31 or not 0 <= write_bytes < 2**31:
        raise ValueError(f"cap {cap} or write_bytes {write_bytes} outside "
                         f"int32")
    if not on_cuda(*state, *window, vmax):
        return _plain(state, window, n, cap, write_bytes, vmax)
    for t, name in zip((*state, *window, vmax),
                       ("kind", "count", "stamp", "length", "ptr", "wrote",
                        "hist", "regs", "ops", "keys", "wptr", "pm_ptr",
                        "pm_len", "seg0", "vmax")):
        _build.require(t, name, torch.int32, 1)
    if trees is None:
        trees = build_trees(state)
    for t in trees:
        _build.require(t, "trees", torch.int32, 2, align=8)
        if t.shape != (2 * s, 2):
            raise ValueError(f"trees must be ({2 * s}, 2)")
    packed = torch.empty(HEADER + 2 * w, dtype=torch.int32,
                         device=ops.device)
    launch(state, trees, window, n, cap, write_bytes, vmax, packed)
    return _views(packed, state, w)


def launch(state, trees, window, n: int, cap: int, write_bytes: int, vmax,
           packed) -> None:
    """The kernel launch alone, on checked CUDA tensors (the wrapper's
    last step; ``chip_smoke.py`` also times it by itself)."""
    w = window[0].shape[0]
    _build.launch("fused_window", "fused_window_launch", n,
                  *(t.data_ptr() for t in state), state[0].shape[0],
                  trees[0].data_ptr(), trees[1].data_ptr(),
                  *(t.data_ptr() for t in window), n, w, cap, write_bytes,
                  vmax.data_ptr(), vmax.shape[0], packed.data_ptr(),
                  _build.stream(packed))


def _plain(state, window, n, cap, write_bytes, vmax) -> WindowOut:
    """The plain version on CPU tensors, with the kernel's in-place and
    packed conventions."""
    arrs = tuple(t.numpy() for t in state)
    ne, st, ev, op, cut = fused_window_ref(
        arrs, *(t.numpy() for t in window), n, cap, write_bytes,
        vmax.numpy())
    for a, b in zip(arrs, st):
        a[...] = b
    w = window[0].shape[0]
    packed = np.empty(HEADER + 2 * w, np.int32)
    packed[0], packed[1] = ne, cut
    packed[2:HEADER] = st[7]
    packed[HEADER:HEADER + w] = ev
    packed[HEADER + w:] = op
    return _views(torch.from_numpy(packed), state, w)
