"""Plain torch versions of the SSD scan (the port's copies of the
reference's ``ref.py`` and of ``ops.py:_ssd_chunked_jnp``).

``ssd_ref`` is the sequential recurrence, the oracle; ``ssd_chunked`` is
the chunked algorithm the kernel computes, which the wrapper runs on CPU
tensors; ``ssd_decode_step`` is one token of the recurrence, which the
decode path runs on every device.

``piece_state`` and ``carry`` lift the chunked algorithm's carried state
from chunks to pieces of a sequence (the ranks of a model axis, each
holding one piece): a piece scanned from a zero state is exact once
``carry`` adds what the pieces before it leave in its state, C_t .
exp(cum_t) . h_in, h_in folded from their final states and total decays.

Shapes: x (B, S, H, P); dt (B, S, H); a, d (H,); b, c (B, S, G, N) with
H % G == 0 (head h reads group h // (H / G)). Everything is computed in
f32 and y comes back in x's type.
"""

from __future__ import annotations

import torch


def ssd_ref(x, dt, a, b, c, d):
    """Returns y (B, S, H, P) in x's type and the final state
    (B, H, N, P) f32."""
    bsz, s, h, p = x.shape
    n = b.shape[3]
    hg = h // b.shape[2]
    bh = torch.repeat_interleave(b, hg, dim=2).float()     # (B, S, H, N)
    ch = torch.repeat_interleave(c, hg, dim=2).float()
    xf, dtf, af = x.float(), dt.float(), a.float()
    state = torch.zeros((bsz, h, n, p), dtype=torch.float32, device=x.device)
    ys = []
    for t in range(s):
        decay = torch.exp(dtf[:, t] * af[None, :])          # (B, H)
        state = state * decay[..., None, None] \
            + (dtf[:, t, :, None] * bh[:, t])[..., :, None] \
            * xf[:, t, :, None, :]
        ys.append(torch.einsum("bhn,bhnp->bhp", ch[:, t], state))
    y = torch.stack(ys, dim=1) + d.float()[None, None, :, None] * xf
    return y.to(x.dtype), state


def ssd_decode_step(state, xt, dtt, a, bt, ct, d):
    """One token: state (B, H, N, P), xt (B, H, P), dtt (B, H), bt, ct
    (B, G, N). Returns (y (B, H, P), state)."""
    hg = state.shape[1] // bt.shape[1]
    bt = torch.repeat_interleave(bt, hg, dim=1)
    ct = torch.repeat_interleave(ct, hg, dim=1)
    decay = torch.exp(dtt * a[None, :])
    state = state * decay[..., None, None] \
        + (dtt[..., None] * bt)[..., :, None] * xt[..., None, :]
    y = torch.einsum("bhn,bhnp->bhp", ct, state) + d[None, :, None] * xt
    return y, state


def ssd_chunked(x, dt, a, b, c, d, chunk: int):
    """The chunked SSD in plain torch: per chunk of ``chunk`` tokens the
    quadratic intra-chunk form, and the (N, P) states carried from chunk
    to chunk by a sequential loop. S must be a multiple of ``chunk``."""
    bsz, s, h, p = x.shape
    g, n = b.shape[2], b.shape[3]
    hg = h // g
    nc = s // chunk
    xf = x.float().reshape(bsz, nc, chunk, h, p)
    dtf = dt.float().reshape(bsz, nc, chunk, h)
    bf = torch.repeat_interleave(b, hg, dim=2).float() \
        .reshape(bsz, nc, chunk, h, n)
    cf = torch.repeat_interleave(c, hg, dim=2).float() \
        .reshape(bsz, nc, chunk, h, n)
    da = dtf * a.float()[None, None, None, :]               # (B, NC, L, H)
    cum = torch.cumsum(da, dim=2)
    cb = torch.einsum("bnihd,bnjhd->bnhij", cf, bf)         # (B, NC, H, L, L)
    ii = torch.arange(chunk, device=x.device)
    mask = ii[:, None] >= ii[None, :]
    cum_t = cum.transpose(2, 3)                             # (B, NC, H, L)
    # clamp: the i < j entries would overflow exp; they are masked anyway
    decay = torch.exp(torch.clamp(cum_t[..., :, None] - cum_t[..., None, :],
                                  max=0.0))
    smat = torch.where(mask, cb * decay * dtf.transpose(2, 3)[..., None, :],
                       0.0)
    y_intra = torch.einsum("bnhij,bnjhp->bnihp", smat, xf)
    last = cum[:, :, -1, :]                                 # (B, NC, H)
    w = torch.exp(last[:, :, None, :] - cum) * dtf          # (B, NC, L, H)
    chunk_states = torch.einsum("bnlhd,bnlhp->bnhdp", bf * w[..., None], xf)
    decs = torch.exp(last)[..., None, None]                 # (B, NC, H, 1, 1)
    h_in = torch.zeros((bsz, h, n, p), dtype=torch.float32, device=x.device)
    h_prevs = []
    # the chunks' operands split once, so that a step is two operations
    for dec, states in zip(decs.unbind(1), chunk_states.unbind(1)):
        h_prevs.append(h_in)
        h_in = h_in * dec + states
    h_prevs = torch.stack(h_prevs, dim=1)                   # (B, NC, H, N, P)
    y_inter = torch.exp(cum)[..., None] * torch.einsum(
        "bnlhd,bnhdp->bnlhp", cf, h_prevs)
    y = (y_intra + y_inter).reshape(bsz, s, h, p) \
        + d.float()[None, None, :, None] * x.float()
    return y.to(x.dtype)


def piece_state(x, dt, a, b):
    """The final state (B, H, N, P) f32 that a piece x (B, T, H, P) leaves
    when scanned from a zero state, and its total decay exp(sum_t dt_t a)
    (B, H) f32."""
    hg = x.shape[2] // b.shape[2]
    da = dt.float() * a.float()[None, None, :]              # (B, T, H)
    cum = torch.cumsum(da, dim=1)
    w = torch.exp(cum[:, -1:] - cum) * dt.float()           # (B, T, H)
    bh = torch.repeat_interleave(b, hg, dim=2).float()      # (B, T, H, N)
    state = torch.einsum("bthn,bthp->bhnp", bh * w[..., None], x.float())
    return state, torch.exp(cum[:, -1])


def carry(y, dt, a, c, states, decays, index: int):
    """y (B, T, H, P) of piece ``index`` scanned from a zero state, plus
    C_t . exp(cum_t) . h_in, where h_in is the state the pieces before it
    leave: ``states`` (M, B, H, N, P) and ``decays`` (M, B, H), every
    piece's ``piece_state``, folded in order (h = h * decay_j + state_j,
    j < index). Returns y's type. Every entry of ``states`` and ``decays``
    takes part in the result, those at or after ``index`` times 0, so that
    each rank's graph holds the gather that made them."""
    hg = y.shape[2] // c.shape[2]
    h_in = torch.zeros_like(states[0])
    for j in range(states.shape[0]):
        keep = float(j < index)
        h_in = h_in * (keep * decays[j] + (1.0 - keep))[..., None, None] \
            + keep * states[j]
    cum = torch.cumsum(dt.float() * a.float()[None, None, :], dim=1)
    ch = torch.repeat_interleave(c, hg, dim=2).float()      # (B, T, H, N)
    y_in = torch.exp(cum)[..., None] * torch.einsum("bthn,bhnp->bthp", ch,
                                                    h_in)
    return (y.float() + y_in).to(y.dtype)
