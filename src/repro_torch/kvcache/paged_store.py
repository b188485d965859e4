"""Paged KV-cache store on DINOMO principles.

The KV cache is a page pool (shared ground truth, like the DPM pool);
serving workers hold ownership of pages, not the pages themselves:

  * OP: a consistent-hash ring maps page ids to their owning worker; the
    owner computes decode attention over its pages (the
    paged_decode_attention kernel) and the partials merge across owners.
    Adding or removing a worker re-maps ring ranges only: the pool never
    moves, and the merge's associativity gives the same logits for any
    ownership layout.
  * DAC: each worker decides which owned pages to copy into its local
    cache (value entries) or to reference in the pool (shortcuts), with
    the paper's Eq. 1, fed by page touches.
  * Selective replication: hot pages (shared prompt prefixes) are shared
    across sequences by refcount (prefix_cache.py).
  * Log-structured appends: a token's KV goes to its sequence's tail
    page; full pages are sealed and never change again.

The pool is device tensors, updated in place; the controller is the
host control plane (allocation, rings, DAC) -- the paper's KN/DPM split.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from ..core.dac import DAC
from ..core.hashring import HashRing
from ..device import resolve_device
from ..kernels.decode_attention.ops import merge_partials, \
    paged_decode_partial
from ..kernels.decode_attention.ref import normalize


@dataclass
class PagePool:
    """One slab per layer, stacked: (L, NP, PS, KH, D) for k and v."""
    k: torch.Tensor
    v: torch.Tensor

    @property
    def num_pages(self) -> int:
        return self.k.shape[1]

    @property
    def page_size(self) -> int:
        return self.k.shape[2]


def pool_init(layers: int, num_pages: int, page_size: int, kv_heads: int,
              head_dim: int, dtype=torch.bfloat16, device=None) -> PagePool:
    """A zeroed pool on ``device`` (the card unless ``device="cpu"``)."""
    dev = resolve_device(device)
    shape = (layers, num_pages, page_size, kv_heads, head_dim)
    return PagePool(k=torch.zeros(shape, dtype=dtype, device=dev),
                    v=torch.zeros(shape, dtype=dtype, device=dev))


def pool_append(pool: PagePool, page_id: int, offset: int,
                k_tok: torch.Tensor, v_tok: torch.Tensor) -> PagePool:
    """Write one token's KV, (L, KH, D) each, into page ``page_id`` at
    ``offset``: the log-structured write. In place: the pool's tensors
    are updated and the same pool is returned (the reference returns a
    new one)."""
    pool.k[:, page_id, offset] = k_tok.to(pool.k.dtype)
    pool.v[:, page_id, offset] = v_tok.to(pool.v.dtype)
    return pool


@dataclass
class Sequence:
    sid: int
    pages: list[int] = field(default_factory=list)
    length: int = 0
    shared_prefix_pages: int = 0      # leading pages borrowed via prefix


class PagedKVController:
    """Host control plane: allocation, ownership, DAC, reconfiguration."""

    def __init__(self, num_pages: int, page_size: int,
                 workers: list[str], cache_pages_per_worker: int = 64,
                 vnodes: int = 32):
        self.page_size = page_size
        self.free = list(range(num_pages - 1, -1, -1))
        self.refcount = np.zeros(num_pages, np.int32)
        self.sequences: dict[int, Sequence] = {}
        self.ring = HashRing(workers, vnodes=vnodes)
        # per-worker DAC over pages: a value is a locally cached page
        # copy, a shortcut just the page id (one remote gather)
        page_bytes = 1            # abstract units: capacity in pages
        self.dac: dict[str, DAC] = {
            w: DAC(capacity_bytes=cache_pages_per_worker
                   * (DAC.value_bytes(page_bytes)))
            for w in workers}
        self.stats = {"appends": 0, "page_allocs": 0, "reconfigs": 0}

    # ----- allocation (log-structured appends) -------------------------
    def new_sequence(self, sid: int) -> Sequence:
        seq = Sequence(sid)
        self.sequences[sid] = seq
        return seq

    def _alloc_page(self) -> int:
        if not self.free:
            raise RuntimeError("page pool exhausted")
        pid = self.free.pop()
        self.refcount[pid] = 1
        self.stats["page_allocs"] += 1
        return pid

    def append_slot(self, sid: int) -> tuple[int, int]:
        """Where the next token's KV goes: (page_id, offset)."""
        seq = self.sequences[sid]
        off = seq.length % self.page_size
        if off == 0:
            seq.pages.append(self._alloc_page())
        seq.length += 1
        self.stats["appends"] += 1
        return seq.pages[-1], off

    def release(self, sid: int) -> None:
        seq = self.sequences.pop(sid)
        for pid in seq.pages:
            self.refcount[pid] -= 1
            if self.refcount[pid] == 0:
                self.free.append(pid)

    # ----- ownership (OP) ----------------------------------------------
    def owner_of(self, page_id: int) -> str:
        return self.ring.owner(("page", page_id))

    def page_tables(self, sids: list[int], pad_to: int | None = None):
        """Per-worker (page_table, page_pos) for a decode batch: worker w
        gets exactly the (seq, page) cells it owns. Returns
        {worker: (table (B,P), pos (B,P))} as numpy int32."""
        workers = self.ring.members
        maxp = max((len(self.sequences[s].pages) for s in sids),
                   default=1)
        p = pad_to or max(maxp, 1)
        tables = {w: np.full((len(sids), p), -1, np.int32)
                  for w in workers}
        poss = {w: np.zeros((len(sids), p), np.int32) for w in workers}
        for bi, sid in enumerate(sids):
            seq = self.sequences[sid]
            cursor = {w: 0 for w in workers}
            for j, pid in enumerate(seq.pages):
                w = self.owner_of(pid)
                c = cursor[w]
                tables[w][bi, c] = pid
                poss[w][bi, c] = j * self.page_size
                cursor[w] = c + 1
                self._touch(w, pid)
        return {w: (tables[w], poss[w]) for w in workers}

    def _touch(self, worker: str, page_id: int) -> None:
        """Feed DAC: a page touch is a read; a value hit is a local copy."""
        dac = self.dac[worker]
        if dac.lookup(page_id) is None:
            dac.note_miss_rts(1.0)
            dac.fill_after_miss(page_id, ptr=page_id, length=1)

    def local_copy_ratio(self, worker: str) -> float:
        dac = self.dac[worker]
        n = dac.num_values + dac.num_shortcuts
        return dac.num_values / n if n else 0.0

    # ----- reconfiguration (lightweight, zero page movement) ------------
    def add_worker(self, name: str) -> None:
        self.ring.add(name)
        self.dac[name] = DAC(capacity_bytes=next(iter(self.dac.values()))
                             .capacity) if self.dac else DAC(64 * 41)
        self.stats["reconfigs"] += 1

    def remove_worker(self, name: str) -> None:
        """Worker removal or failure: pages survive in the pool; only the
        ring changes. The departed worker's local copies (soft state) are
        dropped."""
        self.ring.remove(name)
        self.dac.pop(name, None)
        self.stats["reconfigs"] += 1

    @property
    def workers(self) -> list[str]:
        return self.ring.members


@dataclass
class StackedOwners:
    """The page tables of the owners that own at least one page of a
    decode batch, stacked in worker order as the rows of one
    paged_decode_attention call: owner i's batch occupies rows
    i * B .. (i + 1) * B - 1, each with its length."""
    page_table: torch.Tensor      # (O * B, P) int32
    page_pos: torch.Tensor        # (O * B, P) int32
    lengths: torch.Tensor         # (O * B,) int32
    owners: int


def stack_owners(tables: dict, lengths, device) -> StackedOwners | None:
    """``tables`` ({worker: (table (B, P), pos (B, P))}, numpy) and the
    batch's ``lengths`` as one StackedOwners on ``device``, sent in one
    copy; None when no owner holds a page."""
    owned = [(pt, pos) for pt, pos in tables.values() if (pt >= 0).sum()]
    if not owned:
        return None
    lens = np.asarray(lengths, np.int32).reshape(-1)
    rows, slots = len(owned) * owned[0][0].shape[0], owned[0][0].shape[1]
    flat = np.concatenate([np.concatenate([pt for pt, _ in owned]).ravel(),
                           np.concatenate([pos for _, pos in owned]).ravel(),
                           np.tile(lens, len(owned))]).astype(np.int32)
    dev = torch.as_tensor(flat, device=device)
    n = rows * slots
    return StackedOwners(dev[:n].view(rows, slots),
                         dev[n:2 * n].view(rows, slots), dev[2 * n:],
                         len(owned))


def owner_partials(q: torch.Tensor, pool: PagePool, layer: int,
                   stacked: StackedOwners) -> list:
    """Each owner's partials (acc, m, l) over its pages, in worker order,
    from one paged_decode_attention call over the stacked rows; q (B, H,
    D) is the same for every owner (a stride-0 view when B = 1)."""
    b = q.shape[0]
    rows = q.expand(stacked.owners, -1, -1) if b == 1 else \
        q.repeat(stacked.owners, 1, 1)
    acc, m, l = paged_decode_partial(rows, pool.k[layer], pool.v[layer],
                                     stacked.page_table, stacked.page_pos,
                                     stacked.lengths)
    return [(acc[i * b:(i + 1) * b], m[i * b:(i + 1) * b],
             l[i * b:(i + 1) * b]) for i in range(stacked.owners)]


def decode_over_owners(q: torch.Tensor, pool: PagePool, layer: int,
                       tables: dict[str, tuple[np.ndarray, np.ndarray]],
                       lengths) -> torch.Tensor:
    """Paged decode per owner, merged: the same result as one owner over
    all pages, which is why ownership remaps are free. The owners' partials
    come from one kernel launch over their stacked tables and merge in
    worker order, as the reference's per-owner calls do.

    q: (B, H, D); returns (B, H, D) in q's type."""
    stacked = stack_owners(tables, lengths, q.device)
    if stacked is None:
        raise ValueError("no owned pages")
    acc, m, l = merge_partials(owner_partials(q, pool, layer, stacked))
    return normalize(acc, m, l).to(q.dtype)
