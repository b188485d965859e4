"""Kernel E, the fused batch executor: the KN windows of the DAC state
machine, every KN's window of one step in one launch
(``csrc/fused_window.cu``), and their plain versions.

``fused_windows`` (ops.py) is the wrapper ``core.jit_engine`` dispatches
(``fused_window`` its one-window form, ``gather_dirty``, ``scatter_slots``
and ``guard_maxima`` the moves of a resident state's changed slots);
``fused_window_ref`` (ref.py) is the port's copy of the reference's numpy
oracle, defining the per-op contract bit for bit. ``build_promote_table``
discretizes the float Eq. 1 decision into an integer threshold table so
the kernel stays float-free; ``init_state`` packs host DAC arrays into the
state tuple.
"""

from .ops import (CUT_BAD_KEY, FIELDS, HEADER, META, Launch, WindowJob,
                  WindowOut, build_trees, fused_window, fused_windows,
                  gather_dirty, guard_maxima, new_dirty, scatter_slots)
from .ref import (CNT_HIST_MAX, CUT_EMA, CUT_NONE, CUT_PREFETCH,
                  CUT_SEGCACHE, CUT_SPILL, CUT_TABLE, EV_MISS_ABSENT,
                  EV_MISS_FILL, EV_PROMOTE, EV_SHORTCUT_HIT,
                  EV_VALUE_HIT, EV_WRITE, NUM_REGS, OP_READ, OP_WRITE,
                  PM_ABSENT, PM_INVALID, R_CLOCK, R_DEMOTIONS,
                  R_EMA_DIRTY, R_EVICTIONS, R_NSHORT, R_NVALS, R_USED,
                  R_ZSHORT, SHORTCUT_BYTES, TABLE_N,
                  VALUE_OVERHEAD_BYTES, build_promote_table,
                  dirty_slots_ref, fused_window_ref, fused_windows_ref,
                  guard_maxima_ref, init_state)

__all__ = [
    "fused_window", "fused_window_ref", "fused_windows",
    "fused_windows_ref", "gather_dirty", "scatter_slots", "guard_maxima",
    "new_dirty", "dirty_slots_ref", "guard_maxima_ref",
    "build_promote_table", "build_trees", "init_state", "CUT_BAD_KEY",
    "FIELDS", "HEADER", "META", "Launch", "WindowJob", "WindowOut",
    "CNT_HIST_MAX",
    "CUT_EMA", "CUT_NONE", "CUT_PREFETCH", "CUT_SEGCACHE", "CUT_SPILL",
    "CUT_TABLE", "EV_MISS_ABSENT", "EV_MISS_FILL", "EV_PROMOTE",
    "EV_SHORTCUT_HIT", "EV_VALUE_HIT", "EV_WRITE", "NUM_REGS", "OP_READ",
    "OP_WRITE", "PM_ABSENT", "PM_INVALID", "R_CLOCK", "R_DEMOTIONS",
    "R_EMA_DIRTY", "R_EVICTIONS", "R_NSHORT", "R_NVALS", "R_USED",
    "R_ZSHORT", "SHORTCUT_BYTES", "TABLE_N", "VALUE_OVERHEAD_BYTES",
]
