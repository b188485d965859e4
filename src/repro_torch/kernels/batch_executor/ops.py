"""Kernel E, the fused batch executor (``csrc/fused_window.cu``): the KN
windows of the DAC state machine, every KN's window of one step in one
launch over the KNs' states on the card, and the three small kernels that
move a resident state's changed slots between the card and the host.

``fused_window`` runs up to ``n`` ops of one window -- value and shortcut
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
regs (8), events (W), out_ptr (W), dirty count], so a caller brings
everything back in one copy.

``fused_windows`` takes a list of ``WindowJob``s (one KN's window each, on
distinct states) and runs them in one launch, one block a job; its
``Launch`` holds each job's ``WindowOut``, all views of one buffer. A job
may carry a dirty record (``new_dirty``): the launch then adds every slot
its window wrote (the ops' keys and the victims) to it, once each.
``gather_dirty`` packs those slots' five fields with the histogram and
the registers into one buffer for the copy back and empties the record;
``scatter_slots`` writes such a buffer's slots into a state and repairs
its trees; ``guard_maxima`` reduces a state to the three maxima the
jit engine's int32 guards read.

CPU tensors run the plain versions (``ref.py``); CUDA tensors run the
kernels, over two victim min-trees built from the state (``build_trees``;
pass them in the job to keep them between dispatches of one resident
state, as ``core.jit_engine`` does). Anything else raises.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ...device import on_cuda
from .. import _build
from .ref import (CNT_HIST_MAX, NUM_REGS, dirty_slots_ref, fused_window_ref,
                  guard_maxima_ref)

HEADER = 2 + NUM_REGS          # n_exec, cut, the registers
S_MAX = 1 << 30                # slots the kernel's int32 tree keys address
CUT_BAD_KEY = -1               # the kernel's cut for a key outside [0, S)
DESC = 32                      # int64 fields of a job's launch descriptor
META = CNT_HIST_MAX + 1 + NUM_REGS   # hist and registers, ahead of slots
FIELDS = 5                     # a moved slot: kind, count, stamp, length, ptr
_STATE_NAMES = ("kind", "count", "stamp", "length", "ptr", "wrote", "hist",
                "regs")
_WINDOW_NAMES = ("ops", "keys", "wptr", "pm_ptr", "pm_len", "seg0")


class WindowOut(tuple):
    """(n_exec, state', events, out_ptr, cut), with ``packed``: the one
    int32 buffer the scalars, events and out_ptr are views of (its last
    entry the job's dirty count after the launch)."""

    packed: torch.Tensor

    def __new__(cls, items, packed):
        self = super().__new__(cls, items)
        self.packed = packed
        return self


class Launch(list):
    """One launch's WindowOuts, in job order; ``packed`` is the buffer
    they are all views of (each job's block ``HEADER + 2 W + 1`` long);
    ``trees`` holds each job's trees, so that trees built for a job
    without them outlive the launch."""

    packed: torch.Tensor
    trees: list


class WindowJob(NamedTuple):
    """One KN's window for ``fused_windows``: its state (updated in
    place), the six (W,) window arrays, the live count, the cache's
    capacity, the staged writes' value size, the promote table; and, on
    the card, the state's trees and dirty record (optional)."""

    state: tuple
    window: tuple
    n: int
    cap: int
    write_bytes: int
    vmax: torch.Tensor
    trees: tuple | None = None
    dirty: torch.Tensor | None = None


def _views(packed: torch.Tensor, state, w: int) -> WindowOut:
    return WindowOut((packed[0], state, packed[HEADER:HEADER + w],
                      packed[HEADER + w:HEADER + 2 * w], packed[1]), packed)


def _check_slots(s: int) -> None:
    if s < 2 or s & (s - 1) or s > S_MAX:
        raise ValueError(f"slot count {s} must be a power of two in "
                         f"[2, 2^30]")


def _check_state(state) -> int:
    if len(state) != 8:
        raise ValueError(f"expected 8 state arrays, got {len(state)}")
    s = state[0].shape[0]
    _check_slots(s)
    for t in state[:6]:
        if t.shape != (s,):
            raise ValueError(f"state arrays must be ({s},), got "
                             f"{tuple(t.shape)}")
    if state[6].shape != (CNT_HIST_MAX + 1,) or \
            state[7].shape != (NUM_REGS,):
        raise ValueError("hist must be (CNT_HIST_MAX + 1,) and regs "
                         "(NUM_REGS,)")
    return s


def _check(state, window, n: int):
    s = _check_state(state)
    if len(window) != 6:
        raise ValueError(f"expected 6 window arrays, got {len(window)}")
    w = window[0].shape[0]
    for t in window:
        if t.shape != (w,):
            raise ValueError(f"window arrays must be ({w},), got "
                             f"{tuple(t.shape)}")
    if not 0 <= n <= w:
        raise ValueError(f"n={n} outside [0, {w}]")
    return s, w


def dirty_words(s: int) -> int:
    return (s + 31) // 32


def new_dirty(s: int, device) -> torch.Tensor:
    """An empty dirty record for a state of ``s`` slots: [count, bitmap
    (one bit a slot, int32 words), list (s)], int32."""
    return torch.zeros(1 + dirty_words(s) + s, dtype=torch.int32,
                       device=device)


def build_trees(state):
    """The LRU and LFU min-trees of a CUDA state ((2S, 2) int32 each: heap
    order, root 1, leaf k at S + k), built on the card; None for a CPU
    state (the plain version scans instead)."""
    kind, count, stamp = state[0], state[1], state[2]
    if not on_cuda(kind, count, stamp):
        return None
    s = kind.shape[0]
    _check_slots(s)
    for t, name in ((kind, "kind"), (count, "count"), (stamp, "stamp")):
        _build.require(t, name, torch.int32, 1)
    lru = torch.empty((2 * s, 2), dtype=torch.int32, device=kind.device)
    lfu = torch.empty_like(lru)
    _build.run("fused_window_build", kind.data_ptr(), count.data_ptr(),
               stamp.data_ptr(), s, lru.data_ptr(), lfu.data_ptr(),
               _build.stream(kind), kernel="fused_window")
    return lru, lfu


def fused_window(state, ops, keys, wptr, pm_ptr, pm_len, seg0, n, cap,
                 write_bytes, vmax, trees=None, dirty=None) -> WindowOut:
    """Run up to ``n`` window ops (see the module docstring). ``cap`` and
    ``write_bytes`` are the cache's capacity and the staged writes' value
    size, ``vmax`` the promote threshold table (``build_promote_table``).
    ``trees`` (CUDA only) are ``build_trees(state)``, kept valid by the
    launch; without them the call builds its own. The callers' int32
    guards (``core.jit_engine``) keep every value in range."""
    job = WindowJob(state, (ops, keys, wptr, pm_ptr, pm_len, seg0), n, cap,
                    write_bytes, vmax, trees, dirty)
    return fused_windows([job])[0]


def fused_windows(jobs) -> Launch:
    """Run each job's window (``WindowJob``) over its state, all in one
    launch on the card (one block a job); the states must be distinct.
    Returns the jobs' WindowOuts in order."""
    jobs, shapes, cuda = _jobs(jobs)
    if not cuda:
        return _plain(jobs, shapes)
    desc, out = _describe(jobs, shapes)
    launch(desc, sum(sh[2] for sh in shapes))
    return out


def prepare(jobs):
    """(descriptor tensor, Launch of the outputs, live ops) of CUDA jobs:
    what ``launch`` takes, for a caller that times the launch alone."""
    jobs, shapes, cuda = _jobs(jobs)
    if not cuda:
        raise ValueError("prepare: the jobs' tensors must be on the card")
    desc, out = _describe(jobs, shapes)
    return desc, out, sum(sh[2] for sh in shapes)


def _jobs(jobs):
    """The jobs checked: (jobs, per job (S, W, n, cap, write_bytes),
    whether they lie on the card)."""
    jobs = [WindowJob(*j) for j in jobs]
    if not jobs:
        raise ValueError("fused_windows: no job")
    shapes = []
    tensors = []
    for j in jobs:
        n, cap, wb = int(j.n), int(j.cap), int(j.write_bytes)
        s, w = _check(j.state, j.window, n)
        if not 0 < cap < 2**31 or not 0 <= wb < 2**31:
            raise ValueError(f"cap {cap} or write_bytes {wb} outside int32")
        if j.dirty is not None and \
                j.dirty.shape != (1 + dirty_words(s) + s,):
            raise ValueError("dirty must be new_dirty(S)")
        shapes.append((s, w, n, cap, wb))
        tensors += [*j.state, *j.window, j.vmax]
        if j.dirty is not None:
            tensors.append(j.dirty)
    return jobs, shapes, on_cuda(*tensors)


def _describe(jobs, shapes):
    """The launch descriptor of CUDA jobs on the card, and the Launch of
    views of their one output buffer (trees built where a job has none)."""
    desc = np.zeros((len(jobs), DESC), np.int64)
    sizes = [HEADER + 2 * w + 1 for _, w, _, _, _ in shapes]
    packed = torch.empty(sum(sizes), dtype=torch.int32,
                         device=jobs[0].state[0].device)
    out = Launch()
    out.trees = []
    off = 0
    for i, (j, (s, w, n, cap, wb)) in enumerate(zip(jobs, shapes)):
        for t, name in zip((*j.state, *j.window, j.vmax),
                           (*_STATE_NAMES, *_WINDOW_NAMES, "vmax")):
            _build.require(t, name, torch.int32, 1)
        if j.vmax.shape[0] < 1:
            raise ValueError("vmax must hold at least one row")
        trees = j.trees if j.trees is not None else build_trees(j.state)
        for t in trees:
            _build.require(t, "trees", torch.int32, 2, align=8)
            if t.shape != (2 * s, 2):
                raise ValueError(f"trees must be ({2 * s}, 2)")
        if j.dirty is not None:
            _build.require(j.dirty, "dirty", torch.int32, 1)
        block = packed[off:off + sizes[i]]
        desc[i, :8] = [t.data_ptr() for t in j.state]
        desc[i, 8] = s
        desc[i, 9:11] = [t.data_ptr() for t in trees]
        desc[i, 11] = 0 if j.dirty is None else j.dirty.data_ptr()
        desc[i, 12:18] = [t.data_ptr() for t in j.window]
        desc[i, 18:24] = (n, w, cap, wb, j.vmax.data_ptr(), j.vmax.shape[0])
        desc[i, 24] = block.data_ptr()
        out.append(_views(block, j.state, w))
        out.trees.append(trees)
        off += sizes[i]
    out.packed = packed
    return torch.from_numpy(desc).to(packed.device), out


def launch(desc: torch.Tensor, ops: int) -> None:
    """The kernel launch alone, over a (jobs, DESC) int64 descriptor
    tensor on the card (the wrapper's last step; ``chip_smoke.py`` also
    times it by itself); ``ops`` is the jobs' live ops, for the work
    count."""
    _build.launch("fused_window", "fused_windows_launch", ops,
                  desc.data_ptr(), desc.shape[0], _build.stream(desc))


def _plain(jobs, shapes) -> Launch:
    """The plain version on CPU tensors, job by job, with the kernel's
    in-place, packed and dirty-record conventions."""
    out = Launch()
    out.trees = [j.trees for j in jobs]
    blocks = []
    for j, (s, w, n, cap, wb) in zip(jobs, shapes):
        arrs = tuple(t.numpy() for t in j.state)
        before = tuple(a.copy() for a in arrs[:6])
        ne, st, ev, op, cut = fused_window_ref(
            arrs, *(t.numpy() for t in j.window), n, cap, wb, j.vmax.numpy())
        for a, b in zip(arrs, st):
            a[...] = b
        packed = np.empty(HEADER + 2 * w + 1, np.int32)
        packed[0], packed[1] = ne, cut
        packed[2:HEADER] = st[7]
        packed[HEADER:HEADER + w] = ev
        packed[HEADER + w:HEADER + 2 * w] = op
        packed[-1] = 0
        if j.dirty is not None:
            packed[-1] = _note_dirty(j.dirty.numpy(), s,
                                     dirty_slots_ref(before, st[:6]))
        blocks.append(packed)
    packed = torch.from_numpy(np.concatenate(blocks))
    off = 0
    for j, blk, (s, w, *_) in zip(jobs, blocks, shapes):
        out.append(_views(packed[off:off + blk.size], j.state, w))
        off += blk.size
    out.packed = packed
    return out


def _note_dirty(dirty: np.ndarray, s: int, slots: np.ndarray) -> int:
    """Add ``slots`` to a dirty record (numpy view) once each; returns
    its new count."""
    nw = dirty_words(s)
    bits = dirty[1:1 + nw].view(np.uint32)
    lst = dirty[1 + nw:]
    cnt = int(dirty[0])
    for k in slots.tolist():
        b = np.uint32(1 << (k & 31))
        if not bits[k >> 5] & b:
            bits[k >> 5] |= b
            lst[cnt] = k
            cnt += 1
    dirty[0] = cnt
    return cnt


def gather_dirty(state, dirty: torch.Tensor, n: int) -> torch.Tensor:
    """The ``n`` slots of a dirty record (``n`` its count, which the
    launch that last wrote it returned) with their fields, as one
    int32 buffer [hist, regs, keys (n), kind, count, stamp, length, ptr
    (n each)]; the record is emptied and the slots' ``wrote`` flags
    cleared (what a scatter-back to the host leaves on the card)."""
    s = _check_state(state)
    n = int(n)
    if dirty.shape != (1 + dirty_words(s) + s,) or not 0 <= n <= s:
        raise ValueError(f"dirty must be new_dirty({s}) and n in [0, {s}]")
    if not on_cuda(*state, dirty):
        d = dirty.numpy()
        arrs = [t.numpy() for t in state]
        nw = dirty_words(s)
        if n != int(d[0]):
            raise ValueError(f"n={n} is not the record's count {int(d[0])}")
        keys = d[1 + nw:1 + nw + n].copy()
        out = np.concatenate([arrs[6], arrs[7], keys,
                              *(a[keys] for a in arrs[:5])]).astype(np.int32)
        d[1:1 + nw] = 0
        arrs[5][keys] = 0
        d[0] = 0
        return torch.from_numpy(out)
    for t, name in zip((*state, dirty), (*_STATE_NAMES, "dirty")):
        _build.require(t, name, torch.int32, 1)
    out = torch.empty(META + (1 + FIELDS) * n, dtype=torch.int32,
                      device=dirty.device)
    _build.launch("fused_window_gather", "fused_window_gather", n,
                  *(t.data_ptr() for t in state), s, dirty.data_ptr(), n,
                  out.data_ptr(), _build.stream(out))
    return out


def scatter_slots(state, trees, rec: torch.Tensor) -> None:
    """Write a slot buffer (``gather_dirty``'s layout) into ``state``:
    the histogram, the registers and each slot's five fields (``wrote``
    is left as it is); on the card, ``trees`` are repaired to match."""
    s = _check_state(state)
    n, r = divmod(rec.shape[0] - META, 1 + FIELDS)
    if rec.dim() != 1 or r or n < 0:
        raise ValueError("rec must be META + 6 n int32")
    if not on_cuda(*state, rec):
        arrs = [t.numpy() for t in state]
        h = rec.numpy()
        arrs[6][:] = h[:CNT_HIST_MAX + 1]
        arrs[7][:] = h[CNT_HIST_MAX + 1:META]
        keys = h[META:META + n]
        if n and (keys.min() < 0 or keys.max() >= s):
            raise ValueError(f"a slot outside [0, {s})")
        for j in range(FIELDS):
            arrs[j][keys] = h[META + (1 + j) * n:META + (2 + j) * n]
        return
    for t, name in zip((*state, rec), (*_STATE_NAMES, "rec")):
        _build.require(t, name, torch.int32, 1)
    for t in trees:
        _build.require(t, "trees", torch.int32, 2, align=8)
        if t.shape != (2 * s, 2):
            raise ValueError(f"trees must be ({2 * s}, 2)")
    _build.launch("fused_window_scatter", "fused_window_scatter", n,
                  *(t.data_ptr() for t in state), s, trees[0].data_ptr(),
                  trees[1].data_ptr(), rec.data_ptr(), n,
                  _build.stream(rec))


def guard_maxima(state, nslots: int) -> torch.Tensor:
    """(3,) int32: the largest count, ptr and length over the live slots
    (kind != 0) of [0, nslots); -2^31 where no slot is live."""
    s = _check_state(state)
    nslots = int(nslots)
    if not 0 <= nslots <= s:
        raise ValueError(f"nslots {nslots} outside [0, {s}]")
    kind, count, length, ptr = state[0], state[1], state[3], state[4]
    if not on_cuda(kind, count, length, ptr):
        return torch.from_numpy(guard_maxima_ref(
            kind.numpy(), count.numpy(), ptr.numpy(), length.numpy(),
            nslots))
    for t, name in ((kind, "kind"), (count, "count"), (length, "length"),
                    (ptr, "ptr")):
        _build.require(t, name, torch.int32, 1)
    out = torch.empty(3, dtype=torch.int32, device=kind.device)
    _build.launch("fused_window_guards", "fused_window_guards", nslots,
                  kind.data_ptr(), count.data_ptr(), length.data_ptr(),
                  ptr.data_ptr(), nslots, out.data_ptr(), _build.stream(out))
    return out
