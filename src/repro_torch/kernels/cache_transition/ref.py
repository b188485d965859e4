"""Plain versions of the cache_transition space machine: a torch loop
over tensors (any device) and a plain-python copy of the reference's
numpy oracle (the planner's structural-loop semantics restricted to the
kernel's op encoding)."""

from __future__ import annotations

import numpy as np
import torch

from ...core.dac import SHORTCUT_BYTES as SB


def cache_transition_ref(ops: torch.Tensor, victims: torch.Tensor, used0,
                         z0, *, cap: int):
    """Torch loop over the op rows with the carried (used, z,
    victim-cursor) state and the make-space rule, on ``ops``'s device.
    Returns (dec, nvic, used), (N,) int32 each."""
    dev = ops.device
    rows = ops.to(torch.int64)
    vic = victims.to(torch.int64)
    nv = vic.shape[0]
    n = rows.shape[0]
    u = torch.as_tensor(used0, dtype=torch.int64, device=dev).clone()
    z = torch.as_tensor(z0, dtype=torch.int64, device=dev).clone()
    vi = torch.zeros((), dtype=torch.int64, device=dev)
    dec = torch.zeros(n, dtype=torch.int32, device=dev)
    nvic = torch.zeros(n, dtype=torch.int32, device=dev)
    used = torch.zeros(n, dtype=torch.int32, device=dev)
    for j in range(n):
        code, rm, vb, zhit, zfill = rows[j, :5].unbind()
        is_pro = code == 1
        is_fill = code == 2
        # deletes and neutral ops only move bytes
        u_pass = u - torch.where((code == 3) | is_fill, rm, 0)
        z = z - torch.where(is_pro, zhit, 0)
        # Eq. 1 fast paths (promote): free space, else zero-count pool;
        # n_evict rounds toward -inf, as Python's and JAX's // do
        free = cap - u
        need = vb - SB
        n_evict = -torch.div(free - need, SB, rounding_mode="floor")
        pro_ok = is_pro & ((free >= need) | (z >= n_evict))
        # fill class: a value lands iff it fits after the removal
        fits = is_fill & (u_pass + vb <= cap)
        lands = pro_ok | fits
        ins = torch.where(lands, vb, torch.where(is_fill, SB, 0))
        u = torch.where(pro_ok, u_pass - SB, u_pass)
        z = z + torch.where(is_fill & ~fits, zfill, 0)
        # make-space: consume frozen victims until the insert fits; only
        # the final victim may re-insert as a shortcut
        while bool((u + ins > cap) & (vi < nv)):
            u = u - vic[vi]
            vi = vi + 1
            u = u + torch.where(u + SB + ins <= cap, SB, 0)
        u = u + ins
        dec[j] = lands
        nvic[j] = vi
        used[j] = u
    return dec, nvic, used


def cache_transition_np(ops: np.ndarray, victims: np.ndarray, used0: int,
                        z0: int, *, cap: int):
    """Plain-python reference (the planner's loop semantics)."""
    u, z, vi = int(used0), int(z0), 0
    nv = victims.shape[0]
    dec_out = np.zeros(ops.shape[0], np.int32)
    nvic_out = np.zeros(ops.shape[0], np.int32)
    used_out = np.zeros(ops.shape[0], np.int32)
    for j in range(ops.shape[0]):
        code, rm, vb, zhit, zfill = (int(x) for x in ops[j, :5])
        ins = 0
        if code == 1:                           # promote
            z -= zhit
            free = cap - u
            need = vb - SB
            if free >= need or z >= -((free - need) // SB):
                dec_out[j] = 1
                u -= SB
                ins = vb
        elif code == 2:                         # fill
            u -= rm
            if u + vb <= cap:
                dec_out[j] = 1
                ins = vb
            else:
                z += zfill
                ins = SB
        elif code == 3:                         # delete
            u -= rm
        while u + ins > cap and vi < nv:
            u -= int(victims[vi])
            vi += 1
            if u + SB + ins <= cap:
                u += SB
        u += ins
        nvic_out[j] = vi
        used_out[j] = u
    return dec_out, nvic_out, used_out
