"""Window encoding and gather for the cache_transition kernel.

``encode_window`` lowers a window of KVS ops (op kind + each key's
prior entry state, exactly the vectors ``core.transition`` gathers from
``ArrayDAC``) into the kernel's 8-lane op rows under the steady regime
-- promotes for shortcut reads, class-adaptive fills for writes,
byte-frees for deletes -- so the kernel and the numpy planner compute
the same decisions from the same inputs. A read that misses is a
neutral row: the planner's miss fill is not encoded.

``gather_window`` feeds it from an ``ArrayDAC`` and a window through the
planner's own passes A and B (``core.transition.prior_state``), with the
frozen LRU victim queue the planner's make-space consumes.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ...core.dac import SHORTCUT_BYTES as SB
from ...core.dac import VALUE_OVERHEAD_BYTES, ArrayDAC
from ...core.transition import prior_state
from ...device import resolve_device
from .cache_transition import OP_LANES, cache_transition


def encode_window(opk: np.ndarray, kd: np.ndarray, pc: np.ndarray,
                  plen: np.ndarray, *, value_bytes: int,
                  block: int = 256) -> np.ndarray:
    """(N,) op kinds (0 read / 1 write / 2 delete) + per-key prior
    state -> (N_padded, 8) int32 kernel op rows (padding rows are
    neutral)."""
    n = opk.shape[0]
    pad = (-n) % block
    rows = np.zeros((n + pad, OP_LANES), np.int32)
    pvb = plen + VALUE_OVERHEAD_BYTES
    is_rd = opk == 0
    is_wr = opk == 1
    is_dl = opk == 2
    promo = is_rd & (kd == 1)
    rows[:n, 0] = np.where(promo, 1,
                           np.where(is_wr, 2, np.where(is_dl, 3, 0)))
    rm = np.where(kd == 2, pvb, np.where(kd == 1, SB, 0))
    rows[:n, 1] = np.where(is_wr | is_dl, rm, 0)
    rows[:n, 2] = np.where(promo, pvb,
                           np.where(is_wr, value_bytes
                                    + VALUE_OVERHEAD_BYTES, 0))
    rows[:n, 3] = (promo & (pc == 0)).astype(np.int32)
    rows[:n, 4] = (is_wr & (kd == 0)).astype(np.int32)
    return rows


def plan_window_transitions(opk, kd, pc, plen, victims, used0, z0, *,
                            cap: int, value_bytes: int, block: int = 256,
                            device=None):
    """Encode a window and run the space machine over it on ``device``
    (the card unless the caller asks for the CPU).

    Returns (dec, nvic, used) truncated back to the window length (see
    cache_transition for the output semantics). The int32 guard reads
    the encoded rows on the host, so the card's launch reads nothing
    back."""
    dev = resolve_device(device)
    rows = encode_window(opk, kd, pc, plen, value_bytes=value_bytes,
                         block=block)
    dec, nvic, used = cache_transition(
        torch.from_numpy(rows).to(dev),
        torch.from_numpy(np.asarray(victims, np.int32)).to(dev),
        used0, z0, cap=cap, block=block,
        top=int(rows[:, 2].max()) if rows.size else 0)
    n = opk.shape[0]
    return dec[:n], nvic[:n], used[:n]


def victim_queue(cache: ArrayDAC, rows: np.ndarray):
    """The frozen LRU victim queue: ``cache``'s value entries by
    ascending stamp (the order the planner's make-space consumes them),
    as (keys, gross bytes = length + 40), long enough for every
    make-space of ``rows``. A victim frees at least its gross bytes less
    a 32-byte re-insert, so an insert of vb bytes consumes at most
    ceil(vb / that) of them; the queue holds the sum over the rows (all
    value entries when there are fewer)."""
    vals = np.flatnonzero(cache.kind == ArrayDAC.KIND_VALUE)
    if not vals.size:
        return vals, np.zeros(0, np.int64)
    stamps = cache.stamp[vals]
    net = max(1, int(cache.length[vals].min()) + VALUE_OVERHEAD_BYTES - SB)
    vb = rows[np.isin(rows[:, 0], (1, 2)), 2].astype(np.int64)
    over = max(0, cache.used - cache.capacity)
    need = int((-(-vb // net)).sum()) + -(-over // net)
    if need < vals.size:
        part = np.argpartition(stamps, need)[:need]
        sel = part[np.argsort(stamps[part], kind="stable")]
    else:
        sel = np.argsort(stamps, kind="stable")
    keys = vals[sel]
    return keys, cache.length[keys] + VALUE_OVERHEAD_BYTES


@dataclass
class Window:
    """The kernel's inputs for one window: the op rows, the victim
    queue (keys and gross bytes), the starting occupancy and
    zero-shortcut count, and which reads filled after a miss (encoded as
    neutral rows)."""
    rows: np.ndarray
    victim_keys: np.ndarray
    victims: np.ndarray
    used0: int
    z0: int
    fill_miss: np.ndarray


def gather_window(cache, kn, keys, opk, pos, probe_map, dkeys, dbuckets,
                  pool, value_bytes, include_refills=False, *,
                  block: int = 256) -> Window | None:
    """The kernel's inputs for a window, as ``plan_dac_window`` sees it:
    each op's prior (kind, count, length) from the planner's passes A
    and B under the regime the plan was made in (``include_refills``:
    the plan's refill retry), the frozen victim queue, ``cache.used``
    and ``cache._zero_shortcuts``. Call it with the planner's arguments
    before the plan is applied. None where the planner would replay."""
    ps = prior_state(cache, kn, keys, opk, pos, probe_map, dkeys,
                     dbuckets, pool, value_bytes, include_refills)
    if ps is None:
        return None
    rows = encode_window(opk, ps.kd, ps.pc, ps.plen,
                         value_bytes=value_bytes, block=block)
    vkeys, victims = victim_queue(cache, rows)
    return Window(rows, vkeys, victims, cache.used, cache._zero_shortcuts,
                  ps.fillm)


CAUSES = ("read_miss", "touched_victim", "queue_dry", "other")


def twin_verdict(win: Window, plan, keys, dec, nvic, used, cap: int) -> str:
    """Hold the kernel's outputs on a gathered window against the plan's
    decisions over its planned prefix (``plan.ops`` ops): final
    occupancy, victims consumed, promotions, and each promote's and
    fill's landing (``plan.to_val``). Returns "agree", or the first
    cause that explains a disagreement:

      read_miss       a read filled after a miss (a neutral row here)
      touched_victim  a victim the kernel consumed was touched by the
                      window at or before that op (the planner skips it)
      queue_dry       the victim queue ran out (occupancy above cap)
      other           none of these: a fault of the twin
    """
    m = plan.ops
    dec, nvic, used = (np.asarray(x)[:m] for x in (dec, nvic, used))
    code = win.rows[:m, 0]
    act = (code == 1) | (code == 2)
    if (int(used[-1]) == plan.used_final
            and int(nvic[-1]) == len(plan.victims)
            and int(dec[code == 1].sum()) == plan.promotions
            and np.array_equal(dec[act].astype(bool), plan.to_val[act])):
        return "agree"
    if win.fill_miss[:m].any():
        return "read_miss"
    first = {}
    for j, k in enumerate(np.asarray(keys)[:m].tolist()):
        first.setdefault(k, j)
    consumed = win.victim_keys[:int(nvic[-1])].tolist()
    at = np.searchsorted(nvic, np.arange(len(consumed)), side="right")
    if any(first.get(k, m) <= j for k, j in zip(consumed, at.tolist())):
        return "touched_victim"
    if (used > cap).any():
        return "queue_dry"
    return "other"


def miss_free_prefix(win: Window, plan) -> int:
    """Ops of the plan's prefix before its first read that filled after a
    miss: the longest prefix the encoding represents in full (plan it as
    its own window to hold the twin to it)."""
    fills = np.flatnonzero(win.fill_miss[:plan.ops])
    return int(fills[0]) if fills.size else plan.ops
