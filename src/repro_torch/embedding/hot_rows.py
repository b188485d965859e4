"""Hot-row selective replication for huge embedding / expert tables: the
port's copy of the reference's ``embedding/hot_rows.py``.

The 256 k-row vocab tables (nemotron, seamless) and MoE expert banks
are pool-resident and row-sharded; token/expert popularity is zipfian,
which is the paper's hot-key problem verbatim. The M-node rule (freq >
mean + k*sigma, Table 4) selects rows whose *ownership* is replicated
to every reader: lookups of hot rows hit the local replica (0 remote
reads), cold rows take the sharded gather (1 remote read). De-
replication uses the coldness rule symmetrically.

The policy plane is numpy, the reference's code; the replica and the
lookup are plain torch on the table's device (the reference has no
kernel here either).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..device import resolve_device


@dataclass
class HotRowState:
    """hot_ids: (K,) int32 row ids (padded with -1); hot_rows: (K, d)
    replica, on the table's device."""
    hot_ids: torch.Tensor
    hot_rows: torch.Tensor


def select_hot_rows(counts: np.ndarray, k_sigma: float = 3.0,
                    max_rows: int = 256) -> np.ndarray:
    """Paper Table 4 hotness rule over access counts."""
    mean, std = counts.mean(), counts.std()
    if std == 0:
        return np.zeros((0,), np.int32)
    hot = np.nonzero(counts > mean + k_sigma * std)[0]
    if len(hot) > max_rows:
        hot = hot[np.argsort(counts[hot])[::-1][:max_rows]]
    return hot.astype(np.int32)


def select_cold_rows(counts: np.ndarray, hot_ids: np.ndarray,
                     k_sigma: float = 1.0) -> np.ndarray:
    """De-replication rule: currently-hot rows that went cold."""
    if len(hot_ids) == 0:
        return np.zeros((0,), np.int32)
    mean, std = counts.mean(), counts.std()
    cold = [i for i in hot_ids if counts[i] < mean - k_sigma * std]
    return np.asarray(cold, np.int32)


def _replica_rows(table: torch.Tensor, hot_ids: torch.Tensor):
    rows = table[torch.clamp(hot_ids, min=0).long()]
    return torch.where(hot_ids[:, None] >= 0, rows, torch.zeros_like(rows))


def build_replica(table, hot_ids: np.ndarray, pad_to: int,
                  device=None) -> HotRowState:
    """The replica of ``table``'s rows ``hot_ids``, padded to ``pad_to``
    slots (id -1, rows 0), on the table's device; a table that is not a
    tensor goes to ``device`` first (the card unless ``"cpu"``)."""
    if not isinstance(table, torch.Tensor):
        table = torch.as_tensor(np.asarray(table),
                                device=resolve_device(device))
    ids = np.full((pad_to,), -1, np.int32)
    ids[:len(hot_ids)] = hot_ids
    ids = torch.from_numpy(ids).to(table.device)
    return HotRowState(hot_ids=ids, hot_rows=_replica_rows(table, ids))


def lookup(table: torch.Tensor, state: HotRowState, ids):
    """Embedding lookup preferring the local hot replica.

    Returns (embeddings, hot_mask); ``hot_mask`` tells the caller which
    lookups avoided the remote gather (for RT accounting/benchmarks).
    Hot hits read the replicated ``hot_rows``; the rest gather from
    ``table``, which a sharded table would serve remotely."""
    ids = torch.as_tensor(ids, device=table.device)
    # position of each id within hot_ids (k small: one (..., K) compare)
    eq = ids[..., None] == state.hot_ids
    is_hot = eq.any(dim=-1)
    slot = torch.argmax(eq.to(torch.int32), dim=-1)   # the first match
    hot_val = state.hot_rows[slot]
    cold_ids = torch.where(is_hot, 0, ids)        # avoid gathering hot rows
    cold_val = table[cold_ids.long()]
    out = torch.where(is_hot[..., None], hot_val.to(cold_val.dtype),
                      cold_val)
    return out, is_hot


def refresh_after_update(table: torch.Tensor,
                         state: HotRowState) -> HotRowState:
    """After a (sparse) table update, re-snapshot replica rows -- the
    write path invalidation: replicas are rebuilt, not patched, because
    hot sets are tiny."""
    return HotRowState(hot_ids=state.hot_ids,
                       hot_rows=_replica_rows(table, state.hot_ids))
