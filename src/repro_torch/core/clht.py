"""P-CLHT-style hash index (paper Sec. 4, 'DPM metadata index'), in torch.

A chaining hash table whose buckets are one cache line with 3 key/value
slots: lock-free reads, log-free in-place writes, one cache-line access
per lookup in the common case.

The canonical table is one packed bucket line per bucket,
``lines: (total_buckets, LINE) int32``:

    line[b, 0:3]  slot keys       (-1 == empty)
    line[b, 3:6]  slot pointers   (rows of the value heap)
    line[b, 6]    chain link into the overflow region (-1 == none)
    line[b, 7]    pad

8 int32 are one 32-byte sector, so a probe reads one line, as the paper
reads one cache line. ``keys``, ``ptrs`` and ``nxt`` are views of the
lines with the reference's shapes. Buckets ``[num_buckets, total)`` form
the overflow region, handed out in order from ``overflow_head``.

Functions that change the table update it in place and return it.
``clht_insert`` runs the sequential insert: the plain version below on
CPU tensors, the hand-written kernel ``csrc/clht_insert.cu`` on CUDA
tensors.
"""

from __future__ import annotations

import dataclasses

import torch

from ..device import on_cuda, resolve_device
from ..kernels import _build

EMPTY = -1
SLOTS = 3          # one cache line, as in P-CLHT
MAX_CHAIN = 8      # bounded chain walk
LINE = 8           # int32 per packed bucket line
LINK = 2 * SLOTS   # lane of the chain link
MAX_ENTRIES = 1 << 29   # kernel D packs an entry index into 30 bits

_M32 = 0xFFFFFFFF


def _mix32(x: torch.Tensor) -> torch.Tensor:
    """32-bit finalizer (xxhash-style), exact in int64: every product is
    masked to its low 32 bits (which int64 wraparound keeps) before the
    next shift. Returns the uint32 value as int64."""
    x = x.to(torch.int64) & _M32
    x = ((x ^ (x >> 16)) * 0x7FEB352D) & _M32
    x = ((x ^ (x >> 15)) * 0x846CA68B) & _M32
    return x ^ (x >> 16)


def bucket_of(keys: torch.Tensor, num_buckets: int) -> torch.Tensor:
    """Primary bucket id (int32) of each key; num_buckets is 2^k."""
    return (_mix32(keys) & (num_buckets - 1)).to(torch.int32)


@dataclasses.dataclass
class CLHT:
    lines: torch.Tensor          # (total_buckets, LINE) int32
    overflow_head: torch.Tensor  # () int32: next free overflow bucket
    num_buckets: int

    @property
    def keys(self) -> torch.Tensor:    # (total_buckets, SLOTS) view
        return self.lines[:, :SLOTS]

    @property
    def ptrs(self) -> torch.Tensor:    # (total_buckets, SLOTS) view
        return self.lines[:, SLOTS:LINK]

    @property
    def nxt(self) -> torch.Tensor:     # (total_buckets,) view
        return self.lines[:, LINK]

    @property
    def total_buckets(self) -> int:
        return self.lines.shape[0]


def clht_init(num_buckets: int, overflow_buckets: int | None = None, *,
              device=None) -> CLHT:
    assert num_buckets & (num_buckets - 1) == 0, "num_buckets must be 2^k"
    dev = resolve_device(device)
    if overflow_buckets is None:
        overflow_buckets = max(num_buckets // 2, 8)
    total = num_buckets + overflow_buckets
    return CLHT(
        lines=torch.full((total, LINE), EMPTY, dtype=torch.int32,
                         device=dev),
        overflow_head=torch.tensor(num_buckets, dtype=torch.int32,
                                   device=dev),
        num_buckets=num_buckets)


# --------------------------------------------------------------------------
# Batched lookup (lock-free read): walk the chain up to MAX_CHAIN buckets.
# --------------------------------------------------------------------------
def clht_lookup(table: CLHT, keys: torch.Tensor):
    """Returns (ptrs int32, found bool, probes int32): probes counts bucket
    lines touched -- the paper's 'RTs for an index traversal'."""
    keys = keys.to(torch.int32)
    cur = bucket_of(keys, table.num_buckets).long()
    b = keys.shape[0]
    ptr = torch.full((b,), EMPTY, dtype=torch.int32, device=keys.device)
    found = torch.zeros(b, dtype=torch.bool, device=keys.device)
    probes = torch.zeros(b, dtype=torch.int32, device=keys.device)
    active = torch.ones(b, dtype=torch.bool, device=keys.device)
    for _ in range(MAX_CHAIN):
        rows = table.lines[cur]                          # (B, LINE)
        hit = (rows[:, :SLOTS] == keys[:, None]) & active[:, None]
        hit_any = hit.any(dim=1)
        slot_ptr = torch.where(hit, rows[:, SLOTS:LINK], 0).sum(dim=1)
        ptr = torch.where(hit_any & ~found, slot_ptr.to(torch.int32), ptr)
        probes += active.to(torch.int32)
        found |= hit_any
        nxt = rows[:, LINK]
        active = active & ~hit_any & (nxt != EMPTY)
        cur = torch.where(active, nxt.long(), cur)
    return ptr, found, probes


# --------------------------------------------------------------------------
# Sequential insert/update (the merge path), applied strictly in log order.
# Plain version: Python over the lines, one key at a time.
# --------------------------------------------------------------------------
def _locate(table: CLHT, key: int, b0: int):
    """Walk the chain of ``key`` from its primary bucket ``b0``: returns
    (match_b, match_s, empty_b, empty_s, tail_b) with -1 for 'not found'."""
    mb = ms = eb = es = -1
    cur = tail = b0
    for _ in range(MAX_CHAIN):
        line = table.lines[cur].tolist()
        row = line[:SLOTS]
        if mb == -1 and key in row:
            mb, ms = cur, row.index(key)
        if eb == -1 and EMPTY in row:
            eb, es = cur, row.index(EMPTY)
        tail = cur
        if line[LINK] == EMPTY:
            break
        cur = line[LINK]
    return mb, ms, eb, es, tail


def _insert_one(table: CLHT, key: int, ptr: int, b0: int, head: int):
    """Insert/update one entry in place: update in place > fill the first
    empty slot > link a new overflow bucket. Returns (head, old_ptr, ok,
    fresh) with ``head`` the advanced overflow cursor."""
    mb, ms, eb, es, tail = _locate(table, key, b0)
    is_update = mb >= 0
    has_empty = eb >= 0
    can_overflow = head < table.total_buckets
    if is_update:
        tb, ts = mb, ms
    elif has_empty:
        tb, ts = eb, es
    else:
        tb, ts = head, 0
    ok = is_update or has_empty or can_overflow
    old = int(table.lines[tb, SLOTS + ts]) if is_update else EMPTY
    if ok:
        table.lines[tb, ts] = key
        table.lines[tb, SLOTS + ts] = ptr
    if not is_update and not has_empty and can_overflow:
        table.lines[tail, LINK] = head
        head += 1
    return head, old, ok, ok and not is_update


def clht_insert_plain(table: CLHT, keys: torch.Tensor, ptrs: torch.Tensor,
                      mask: torch.Tensor | None = None):
    """Plain version of ``clht_insert`` (any device): a Python loop of
    ``_insert_one`` in log order."""
    n = keys.shape[0]
    if mask is None:
        mask = torch.ones(n, dtype=torch.bool, device=keys.device)
    bids = bucket_of(keys, table.num_buckets).tolist()
    old = [EMPTY] * n
    ok = [False] * n
    fresh = 0
    head = int(table.overflow_head)
    for i, (k, p, m) in enumerate(zip(keys.tolist(), ptrs.tolist(),
                                      mask.tolist())):
        if m:
            head, old[i], ok[i], f = _insert_one(table, k, p, bids[i], head)
            fresh += f
    table.overflow_head.fill_(head)
    dev = keys.device
    return (table, torch.tensor(old, dtype=torch.int32, device=dev),
            torch.tensor(ok, dtype=torch.bool, device=dev),
            torch.tensor(fresh, dtype=torch.int32, device=dev))


def clht_insert(table: CLHT, keys: torch.Tensor, ptrs: torch.Tensor,
                mask: torch.Tensor | None = None):
    """Merge a batch of (key, ptr) entries *in order* into the table, in
    place (paper: 'merges the write operations in a log segment in order
    into the metadata index').

    Returns (table, old_ptrs, ok, num_new): ``old_ptrs[i]`` is the value
    pointer replaced by entry i (-1 for a fresh insert or a masked entry),
    ``ok[i]`` False for masked entries and where the overflow region ran
    out, ``num_new`` (0-d int32) the count of fresh inserts. CPU tensors
    take the plain loop; CUDA tensors the kernel ``csrc/clht_insert.cu``,
    which walks the chains in parallel (its header says how)."""
    keys = keys.to(torch.int32)
    ptrs = ptrs.to(torch.int32)
    if not on_cuda(table.lines, keys, ptrs):
        return clht_insert_plain(table, keys, ptrs, mask)
    keys = keys.contiguous()
    ptrs = ptrs.contiguous()
    n = keys.shape[0]
    _build.require(table.lines, "lines", torch.int32, 2, align=16)
    _build.require(table.overflow_head, "overflow_head", torch.int32, 0)
    for t, name in ((keys, "keys"), (ptrs, "ptrs")):
        _build.require(t, name, torch.int32, 1)
    if mask is not None:
        mask = mask.to(torch.bool).contiguous()
        _build.require(mask, "mask", torch.bool, 1, align=1)
    if n >= MAX_ENTRIES:
        raise ValueError(f"clht_insert: {n} entries; the kernel takes fewer "
                         f"than {MAX_ENTRIES}")
    dev = keys.device
    old = torch.empty(n, dtype=torch.int32, device=dev)
    ok = torch.empty(n, dtype=torch.int32, device=dev)
    num_new = torch.zeros((), dtype=torch.int32, device=dev)
    if n:
        _insert_kernel(table, keys, ptrs, mask, old, ok, num_new)
    return table, old, ok.to(torch.bool), num_new


def _insert_kernel(table: CLHT, keys, ptrs, mask, old, ok, num_new) -> None:
    """Kernel D's steps on the card, with no host sync: key1 = (bucket,
    key) and its stable sort; the marks (group, previous occurrence, the
    group's last ptr, key2) and key2's stable sort; the plan (which
    entries link a bucket); the inclusive count of its link flags; the
    apply and fill. One launch of kernel D is counted, at the apply."""
    n, dev = keys.shape[0], keys.device
    stream = _build.stream(keys)
    mptr = None if mask is None else mask.data_ptr()
    key1 = torch.empty(n, dtype=torch.int64, device=dev)
    _build.run("clht_insert_prepare", keys.data_ptr(), mptr, n,
               table.num_buckets, key1.data_ptr(), stream)
    key1s, order1 = torch.sort(key1, stable=True)
    grp, prev, last_ptr, flags, status1, status2 = torch.empty(
        (6, n), dtype=torch.int32, device=dev)
    key2 = torch.empty(n, dtype=torch.int64, device=dev)
    _build.run("clht_insert_mark", key1s.data_ptr(), order1.data_ptr(),
               ptrs.data_ptr(), n, grp.data_ptr(), prev.data_ptr(),
               last_ptr.data_ptr(), key2.data_ptr(), flags.data_ptr(),
               status1.data_ptr(), status2.data_ptr(), stream)
    key2s, order2 = torch.sort(key2, stable=True)
    _build.run("clht_insert_plan", table.lines.data_ptr(), table.num_buckets,
               keys.data_ptr(), ptrs.data_ptr(), key2s.data_ptr(),
               order2.data_ptr(), n, grp.data_ptr(), last_ptr.data_ptr(),
               flags.data_ptr(), status1.data_ptr(), stream)
    incl = torch.cumsum(flags, 0, dtype=torch.int32)
    _build.launch(
        "clht_insert", "clht_insert_launch", n,
        table.lines.data_ptr(), table.total_buckets, table.num_buckets,
        table.overflow_head.data_ptr(), keys.data_ptr(), ptrs.data_ptr(),
        mptr, n, key2s.data_ptr(), order2.data_ptr(), grp.data_ptr(),
        prev.data_ptr(), last_ptr.data_ptr(), flags.data_ptr(),
        incl.data_ptr(), status2.data_ptr(), old.data_ptr(), ok.data_ptr(),
        num_new.data_ptr(), stream)


def clht_delete(table: CLHT, keys: torch.Tensor,
                mask: torch.Tensor | None = None):
    """Delete a batch of keys in order, in place. Returns (table, old_ptrs,
    found). A Python loop on any device: no serving path deletes."""
    n = keys.shape[0]
    if mask is None:
        mask = torch.ones(n, dtype=torch.bool, device=keys.device)
    bids = bucket_of(keys, table.num_buckets).tolist()
    old = [EMPTY] * n
    found = [False] * n
    for i, (k, m) in enumerate(zip(keys.tolist(), mask.tolist())):
        mb, ms, _, _, _ = _locate(table, k, bids[i])
        if m and mb >= 0:
            old[i] = int(table.lines[mb, SLOTS + ms])
            found[i] = True
            table.lines[mb, ms] = EMPTY
            table.lines[mb, SLOTS + ms] = EMPTY
    dev = keys.device
    return (table, torch.tensor(old, dtype=torch.int32, device=dev),
            torch.tensor(found, dtype=torch.bool, device=dev))
