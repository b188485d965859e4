"""Kernel 4, the planned cache-transition space machine
(``csrc/cache_transition.cu``).

``core.transition.plan_dac_window`` plans a whole per-KN window of DAC
cache transitions by scanning the ops' byte flows over the cache's
occupancy: each fill decides value-vs-shortcut against the running
``used``, each promote decides Eq. 1 through the free-space /
zero-shortcut fast paths, and make-space consumes a frozen queue of LRU
demotion victims (only the final victim of a make-space may re-insert
as a 32-byte shortcut). This kernel computes the same space machine
over encoded op rows: the planner's device-side twin.

Op encoding (one row of 8 int32 lanes per op):
    lane 0  code   0 neutral / 1 promote / 2 fill / 3 delete
    lane 1  rm     bytes the op's prior-entry removal frees
    lane 2  vb     bytes a value entry for this op would occupy
    lane 3  zhit   1 iff a promote's hit decrements the zero count
    lane 4  zfill  1 iff a shortcut landing adds a zero-count entry
    lanes 5-7      reserved (zero)

Per-op outputs:
    dec    promote: 1 iff Eq. 1 fast paths promote; fill: 1 iff the
           entry lands as a value; else 0
    nvic   victims consumed through this op
    used   occupancy after the op

CPU tensors run the plain version (``ref.cache_transition_ref``); CUDA
tensors run the kernel.
"""

from __future__ import annotations

import torch

from ...device import on_cuda
from .. import _build
from .ref import cache_transition_ref

OP_LANES = 8
INT32_MAX = 2**31 - 1


def cache_transition(ops: torch.Tensor, victims: torch.Tensor, used0, z0,
                     *, cap: int, block: int = 256, top: int | None = None):
    """Run the transition space machine over a window of encoded ops.

    ops:     (N, 8) int32 op rows (see module docstring); N must be a
             multiple of ``block``
    victims: (V,) int32 frozen LRU victim queue (gross bytes each)
    used0, z0: starting occupancy / zero-shortcut count
    cap:     cache capacity

    Returns (dec, nvic, used): (N,) int32 decision per op, victims
    consumed through each op, occupancy after each op.

    The reference computes in int32 and wraps; this raises instead
    where the capacity plus the largest insert does not fit in int32, or
    the starting state does not.
    ``top``: the rows' largest value size (lane 2), where the caller
    holds the rows on the host; without it the check reads it back from
    the card."""
    n = ops.shape[0]
    assert n % block == 0, "pad ops to a multiple of the block"
    if ops.dim() != 2 or ops.shape[1] != OP_LANES or victims.dim() != 1:
        raise ValueError(f"expected ops (N, {OP_LANES}) and victims (V,); "
                         f"got {tuple(ops.shape)}, {tuple(victims.shape)}")
    if top is None:
        top = int(ops[:, 2].max()) if n else 0
    if cap + max(top, 0) > INT32_MAX:
        raise OverflowError(f"cap {cap} plus the largest insert {top} "
                            f"does not fit in int32")
    if not all(-INT32_MAX - 1 <= int(x) <= INT32_MAX for x in (used0, z0)):
        raise OverflowError(f"used0 {used0} or z0 {z0} is outside int32")
    if not on_cuda(ops, victims):
        return cache_transition_ref(ops, victims, used0, z0, cap=cap)
    _build.require(ops, "ops", torch.int32, 2, align=16)
    _build.require(victims, "victims", torch.int32, 1)
    dec = torch.empty(n, dtype=torch.int32, device=ops.device)
    nvic = torch.empty(n, dtype=torch.int32, device=ops.device)
    used = torch.empty(n, dtype=torch.int32, device=ops.device)
    if n:
        launch(ops, victims, int(used0), int(z0), cap, dec, nvic, used)
    return dec, nvic, used


def launch(ops, victims, used0: int, z0: int, cap: int, dec, nvic, used):
    """The kernel launch alone, on checked CUDA tensors (the wrapper's
    last step; ``chip_smoke.py`` also times it by itself)."""
    _build.launch("cache_transition", "cache_transition_launch",
                  ops.shape[0], ops.data_ptr(), ops.shape[0],
                  victims.data_ptr(), victims.shape[0], used0, z0, cap,
                  dec.data_ptr(), nvic.data_ptr(), used.data_ptr(),
                  _build.stream(ops))
