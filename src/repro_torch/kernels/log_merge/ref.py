"""Plain versions and oracles of the log_merge kernel: kernel C's function
in torch (``log_merge_sorted_ref``), the entry-at-a-time line merge
(``log_merge_ref``), the planned-layout oracle (``merge_window_plan_ref``,
numpy) and the un-fused write path (``log_append_merge_ref``)."""

from __future__ import annotations

import numpy as np
import torch

from ...core.clht import EMPTY, SLOTS, clht_insert
from ...core.log import SEALED, heap_append, log_append


def log_merge_sorted_ref(lines: torch.Tensor, starts: torch.Tensor,
                         bucket_ids: torch.Tensor, keys: torch.Tensor,
                         ptrs: torch.Tensor):
    """Kernel C's function in torch, on any device: entries sorted by
    bucket, group g = entries [starts[g], starts[g+1]). Each group applies
    its entries in order to its bucket's line (match -> overwrite the
    pointer; else claim the first empty slot; else ok=0; negative keys
    change nothing). Vectorized across groups, one round per position in
    a group. Updates ``lines`` in place; returns (old, ok) int32."""
    e = keys.shape[0]
    dev = keys.device
    old = torch.full((e,), EMPTY, dtype=torch.int32, device=dev)
    ok = torch.zeros(e, dtype=torch.int32, device=dev)
    if e == 0:
        return old, ok
    starts = starts.long()
    sizes = starts[1:] - starts[:-1]
    n_groups = sizes.shape[0]
    gb = bucket_ids[starts[:-1]].long().clamp(0, lines.shape[0] - 1)
    cur = lines[gb]                                   # (G, LINE) copy
    gid = torch.repeat_interleave(torch.arange(n_groups, device=dev), sizes)
    rank = torch.arange(e, device=dev) - starts[:-1][gid]
    by_rank = torch.argsort(rank, stable=True)
    bounds = [0] + torch.bincount(rank).cumsum(0).tolist()
    for r in range(len(bounds) - 1):
        idx = by_rank[bounds[r]:bounds[r + 1]]       # one entry per group
        g = gid[idx]
        key, ptr = keys[idx], ptrs[idx]
        line = cur[g]
        match = line[:, :SLOTS] == key[:, None]
        empty = line[:, :SLOTS] == EMPTY
        m_any = match.any(dim=1)
        target = torch.where(m_any, match.to(torch.int32).argmax(dim=1),
                             empty.to(torch.int32).argmax(dim=1))
        live = key >= 0
        ok_r = (m_any | empty.any(dim=1)) & live
        prev = line.gather(1, (SLOTS + target)[:, None]).squeeze(1)
        old[idx] = torch.where(m_any & live, prev, EMPTY)
        ok[idx] = ok_r.to(torch.int32)
        g, t = g[ok_r], target[ok_r]
        cur[g, t] = key[ok_r]
        cur[g, SLOTS + t] = ptr[ok_r]
    lines[gb] = cur
    return old, ok


def log_merge_ref(lines, bucket_ids, keys, ptrs):
    """Entry-at-a-time oracle of ``log_merge``: a new copy of the lines
    and per-entry (old, ok) int32, in log order."""
    rows = lines.tolist()
    e = len(keys)
    old = [EMPTY] * e
    ok = [0] * e
    for i, (b, k, p) in enumerate(zip(bucket_ids.tolist(), keys.tolist(),
                                      ptrs.tolist())):
        row = rows[b]
        slot_keys = row[:SLOTS]
        if k in slot_keys:
            s = slot_keys.index(k)
            old[i] = row[SLOTS + s]
            row[SLOTS + s] = p
            ok[i] = 1
        elif EMPTY in slot_keys:
            s = slot_keys.index(EMPTY)
            row[s] = k
            row[SLOTS + s] = p
            ok[i] = 1
    dev = lines.device
    return (torch.tensor(rows, dtype=torch.int32, device=dev),
            torch.tensor(old, dtype=torch.int32, device=dev),
            torch.tensor(ok, dtype=torch.int32, device=dev))


def _tensors(dev, *arrays):
    return tuple(torch.from_numpy(a).to(dev) for a in arrays)


def merge_window_plan_ref(lines, bucket_ids, keys, ptrs):
    """Planned-layout oracle at the packed-bucket-line level: resolves
    the whole window's outcome as grouped last-wins updates and ranked
    slot claims instead of ``log_merge_ref``'s entry-at-a-time replay.
    Decision-for-decision identical to ``log_merge_ref`` (the line model
    has no chains, so a full bucket simply fails its claims). numpy
    inside; tensors in and out."""
    dev = lines.device
    lines = lines.cpu().numpy().copy()
    keys = keys.cpu().numpy().astype(np.int64)
    ptrs = ptrs.cpu().numpy().astype(np.int64)
    bucket_ids = bucket_ids.cpu().numpy().astype(np.int64)
    slots = SLOTS
    e = keys.shape[0]
    old = np.full((e,), -1, np.int32)
    ok = np.zeros((e,), np.int32)
    if not e:
        return _tensors(dev, lines, old, ok)
    # group entries by (bucket, key): last ptr wins, per-entry old
    # follows the within-window duplicate chain
    comp = bucket_ids * (np.int64(1) << 32) + keys
    order = np.argsort(comp, kind="stable")
    sc = comp[order]
    sp = ptrs[order]
    first = np.ones(e, bool)
    first[1:] = sc[1:] != sc[:-1]
    last = np.ones(e, bool)
    last[:-1] = first[1:]
    uk = keys[order][first]
    ub = bucket_ids[order][first]
    ufinal = sp[last]
    ufirst = order[first]
    # match against the pre-window lines
    rows = lines[ub]
    hit = rows[:, :slots] == uk[:, None]
    found = hit.any(axis=1)
    mslot = np.argmax(hit, axis=1)
    ucur = np.where(found, rows[np.arange(uk.size), slots + mslot], -1)
    # ranked empty-slot claims per bucket, first-occurrence order
    ab = ~found
    claim_slot = np.full(uk.size, -1, np.int64)
    if ab.any():
        emp = rows[:, :slots] == -1
        ord_ab = np.lexsort((ufirst, ub))
        ord_ab = ord_ab[ab[ord_ab]]
        gb = ub[ord_ab]
        gfirst = np.ones(ord_ab.size, bool)
        gfirst[1:] = gb[1:] != gb[:-1]
        gstart = np.flatnonzero(gfirst)
        rank = (np.arange(ord_ab.size, dtype=np.int64)
                - gstart[np.cumsum(gfirst) - 1])
        # the rank-th empty slot of the row, -1 when it runs out
        for gi, r in zip(ord_ab.tolist(), rank.tolist()):
            sl = np.flatnonzero(emp[gi])
            if r < sl.size:
                claim_slot[gi] = sl[r]
    # per-entry old/ok: failed claims fail every occurrence of the key
    usucc = found | (claim_slot >= 0)
    gid = np.cumsum(first) - 1
    prev = np.empty(e, np.int64)
    prev[first] = ucur
    if e > 1:
        dup = ~first
        prev[dup] = sp[:-1][dup[1:]]
    old[order] = np.where(usucc[gid], prev, -1).astype(np.int32)
    ok[order] = usucc[gid].astype(np.int32)
    # land the final layout: one scatter per side
    tgt = np.where(found, mslot, claim_slot)
    sel = usucc
    lines[ub[sel], tgt[sel]] = uk[sel].astype(np.int32)
    lines[ub[sel], slots + tgt[sel]] = ufinal[sel].astype(np.int32)
    return _tensors(dev, lines, old, ok)


def log_append_merge_ref(table, seg, heap, keys, values):
    """Oracle of the fused log_append_merge: the un-fused path --
    heap_append, log_append, then the strictly sequential clht_insert
    over the pending window. Updates the state in place when the batch
    fits; returns (table, seg, heap, ptrs, old, ok)."""
    n = keys.shape[0]
    dev = keys.device
    if seg.count + n > seg.capacity:
        none = torch.full((n,), EMPTY, dtype=torch.int32, device=dev)
        return (table, seg, heap, none, none.clone(),
                torch.zeros(n, dtype=torch.bool, device=dev))
    start = seg.count
    heap, ptrs = heap_append(heap, values)
    seg, _ = log_append(seg, keys, ptrs)
    lo, hi = seg.merged, seg.count
    table, old, ok, _ = clht_insert(table, seg.keys[lo:hi], seg.ptrs[lo:hi],
                                    seg.seal[lo:hi] == SEALED)
    seg.merged = seg.count
    return (table, seg, heap, ptrs, old[start - lo:], ok[start - lo:])
