"""Mamba2 block (SSD, arXiv:2405.21060): in_proj -> [z | x | B | C | dt];
causal depthwise conv over (x | B | C); the SSD scan; gated RMSNorm;
out_proj. Decode keeps a (conv, ssm) recurrent state per layer.

The casts follow the reference's exactly, because prefill and decode
differ in them and their agreement depends on both: the prefill conv
multiplies and sums in bf16, term by term, then adds a bf16 bias, and
only its result goes to f32 for the silu; the decode conv runs in f32
over an f32 window (the conv state is f32 and the concat promotes).
``a_log``, ``dt_bias`` and ``d_skip`` are f32 parameters.

On a mesh of ranks (``distributed/act_sharding.py``) a rank holds S/M
positions of the sequence. Its conv reads the previous rank's last K - 1
positions of xBC (``act_sharding.halo``; zeros on the first rank, as the
one card's padding), and its SSD scan runs kernel 7 unchanged from a zero
state: the state that the ranks before it leave comes from one all_gather
of every rank's (final state, total decay) (``ref.piece_state``), folded
and added by ``ref.carry``. A decode step holds the rows layout: the
token whole on every model rank, and the (conv, ssm) state split by its
partition rules (``_conv_decode``, ``_ssd_decode``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..device import resolve_device
from ..distributed import act_sharding
from ..kernels.ssd_scan.ops import ssd
from ..kernels.ssd_scan.ref import carry, piece_state, ssd_decode_step
from .layers import PARAM_DTYPE, dense_init, randn, rmsnorm, rmsnorm_init


def mamba_init(gen: torch.Generator, cfg) -> dict:
    """One block's parameters, drawn from ``gen`` on its device."""
    d, din = cfg.d_model, cfg.d_inner
    g, n, h = cfg.ssm_groups, cfg.ssm_state, cfg.ssm_heads
    conv_dim = din + 2 * g * n
    dev = gen.device
    return {
        "in_proj": dense_init(gen, d, 2 * din + 2 * g * n + h),
        "conv_w": (randn((cfg.ssm_conv, conv_dim), gen)
                   * 0.1).to(PARAM_DTYPE),
        "conv_b": torch.zeros((conv_dim,), dtype=PARAM_DTYPE, device=dev),
        "a_log": torch.linspace(1.0, 16.0, h, dtype=torch.float32,
                                device=dev).log(),
        "dt_bias": torch.zeros((h,), dtype=torch.float32, device=dev),
        "d_skip": torch.ones((h,), dtype=torch.float32, device=dev),
        "norm_w": rmsnorm_init(din, dev),
        "out_proj": dense_init(gen, din, d),
    }


def _split(cfg, zxbcdt: torch.Tensor):
    din, g, n, h = cfg.d_inner, cfg.ssm_groups, cfg.ssm_state, cfg.ssm_heads
    z = zxbcdt[..., :din]
    xbc = zxbcdt[..., din:2 * din + 2 * g * n]
    dt = zxbcdt[..., 2 * din + 2 * g * n:]
    if dt.shape[-1] != h:
        raise ValueError(f"in_proj gives {dt.shape[-1]} dt columns, the "
                         f"config has {h} heads")
    return z, xbc, dt


def _causal_conv(xbc: torch.Tensor, w: torch.Tensor, b: torch.Tensor):
    """Depthwise causal conv of kernel size K in xbc's type: xbc (B, S, C),
    w (K, C); each tap's product and each partial sum rounded as the
    reference's bf16 arithmetic rounds them. On a mesh of ranks the K - 1
    positions before the rank's first are the previous rank's."""
    k, s = w.shape[0], xbc.shape[1]
    prev = act_sharding.halo(xbc, k - 1)
    pad = F.pad(xbc, (0, 0, k - 1, 0)) if prev is None \
        else torch.cat([prev, xbc], dim=1)
    out = pad[:, 0:s] * w[0]
    for i in range(1, k):
        out = out + pad[:, i:i + s] * w[i]
    return out + b


def mamba_block(p: dict, x: torch.Tensor, cfg, chunk: int = 64):
    """x: (B, S, d) -> (B, S, d). The scan is the ssd_scan kernel on the
    card; x, B and C reach it as views of the conv's output."""
    bsz, s, _ = x.shape
    din, g, n, h = cfg.d_inner, cfg.ssm_groups, cfg.ssm_state, cfg.ssm_heads
    zxbcdt = x @ p["in_proj"]
    z, xbc, dt = _split(cfg, zxbcdt)
    xbc = F.silu(_causal_conv(xbc, p["conv_w"], p["conv_b"]).float()) \
        .to(x.dtype)
    xs = xbc[..., :din].view(bsz, s, h, cfg.ssm_headdim)
    bmat = xbc[..., din:din + g * n].view(bsz, s, g, n)
    cmat = xbc[..., din + g * n:].view(bsz, s, g, n)
    dt = F.softplus(dt.float() + p["dt_bias"])
    a = -torch.exp(p["a_log"])
    y = ssd(xs, dt, a, bmat, cmat, p["d_skip"], chunk=chunk)
    index, m = act_sharding.model_coord()
    if m > 1 and act_sharding.ranks() is not None:
        state, decay = piece_state(xs, dt, a, bmat)
        y = carry(y, dt, a, cmat, act_sharding.gather_model(state),
                  act_sharding.gather_model(decay), index)
    y = y.reshape(bsz, s, din) * F.silu(z.float()).to(x.dtype)
    y = rmsnorm(p["norm_w"], y, cfg.norm_eps)
    return y @ p["out_proj"]


def mamba_state_init(cfg, batch: int, dtype=torch.float32,
                     device=None) -> dict:
    """Zero decode state: the conv window (B, K-1, C) in ``dtype`` and the
    SSD state (B, H, N, P) f32, on ``device`` (the card unless "cpu")."""
    dev = resolve_device(device)
    conv_dim = cfg.d_inner + 2 * cfg.ssm_groups * cfg.ssm_state
    return {
        "conv": torch.zeros((batch, cfg.ssm_conv - 1, conv_dim), dtype=dtype,
                            device=dev),
        "ssm": torch.zeros((batch, cfg.ssm_heads, cfg.ssm_state,
                            cfg.ssm_headdim), dtype=torch.float32,
                           device=dev),
    }


def mamba_decode(p: dict, x: torch.Tensor, cfg, state: dict):
    """x: (B, 1, d). Returns (y (B, 1, d), new state). On a mesh of ranks
    (the rows layout) ``state`` holds the rank's blocks of the (conv, ssm)
    state by their partition rules, and so does the new state."""
    bsz = x.shape[0]
    din, g, n, h = cfg.d_inner, cfg.ssm_groups, cfg.ssm_state, cfg.ssm_heads
    zxbcdt = x @ p["in_proj"]
    z, xbc, dt = _split(cfg, zxbcdt)
    xbc1, conv_state = _conv_decode(p, xbc, state["conv"], x.dtype)
    xs = xbc1[..., :din].reshape(bsz, h, cfg.ssm_headdim)
    bmat = xbc1[..., din:din + g * n].reshape(bsz, g, n)
    cmat = xbc1[..., din + g * n:].reshape(bsz, g, n)
    dtv = F.softplus(dt[:, 0].float() + p["dt_bias"])
    a = -torch.exp(p["a_log"])
    y, ssm = _ssd_decode(state["ssm"], xs.float(), dtv, a, bmat.float(),
                         cmat.float(), p["d_skip"])
    y = y.reshape(bsz, 1, din).to(x.dtype) \
        * F.silu(z.float()).to(x.dtype)
    y = rmsnorm(p["norm_w"], y, cfg.norm_eps)
    return y @ p["out_proj"], {"conv": conv_state, "ssm": ssm}


def _block_of(t: torch.Tensor, dim: int, size: int) -> torch.Tensor:
    """This model rank's block of ``size`` along ``dim`` of a whole t."""
    index, _ = act_sharding.model_coord()
    return t.narrow(dim, index * size, size)


def _conv_decode(p: dict, xbc: torch.Tensor, conv: torch.Tensor, dtype):
    """The conv's output for the token, silu'd, (B, C) whole, and the new
    conv window (B, K-1, C). The window is f32 (the conv state's type
    promotes the concat). Where the rules split the window's channels
    over the model axis, each rank convolves its channels and the outputs
    are gathered: (B, C) a layer. Where they split its K - 1 positions (a
    model axis that divides K - 1 and not the channels), each rank
    gathers the window's positions, convolves the whole window and keeps
    its block of the new one: (B, K-1, C) a layer, and the output is
    whole on every rank."""
    dim = act_sharding.cache_split("conv")
    w, b = p["conv_w"], p["conv_b"]
    positions = conv.shape[1]
    if dim == 2:
        c = conv.shape[2]
        xbc, w, b = (_block_of(xbc, 2, c), _block_of(w, 1, c),
                     _block_of(b, 0, c))
    elif dim == 1:
        conv = act_sharding.model_gather(conv, 1)
    wtype = torch.promote_types(conv.dtype, xbc.dtype)
    window = torch.cat([conv.to(wtype), xbc.to(wtype)], dim=1)
    out = torch.einsum("bkc,kc->bc", window.float(), w.float()) + b.float()
    out = F.silu(out).to(dtype)
    new = window[:, 1:]
    if dim == 2:
        out = act_sharding.model_gather(out, 1)
    elif dim == 1:
        new = _block_of(new, 1, positions)
    return out, new


def _ssd_decode(state, xs, dtv, a, bmat, cmat, d_skip):
    """``ssd_decode_step`` on the rank's block of the (B, H, N, P) state.
    Split on heads or on P, the rank updates its block and the outputs are
    gathered; split on N, C . h is a sum over the model axis. (B, H, P) a
    layer either way."""
    dim = act_sharding.cache_split("ssm")
    if dim is None:
        return ssd_decode_step(state, xs, dtv, a, bmat, cmat, d_skip)
    hg = xs.shape[1] // bmat.shape[1]
    bh = torch.repeat_interleave(bmat, hg, dim=1)           # (B, H, N)
    ch = torch.repeat_interleave(cmat, hg, dim=1)
    size = state.shape[dim]
    if dim == 1:
        y, state = ssd_decode_step(
            state, _block_of(xs, 1, size), _block_of(dtv, 1, size),
            _block_of(a, 0, size), _block_of(bh, 1, size),
            _block_of(ch, 1, size), _block_of(d_skip, 0, size))
        return act_sharding.model_gather(y, 1), state
    if dim == 3:
        y, state = ssd_decode_step(state, _block_of(xs, 2, size), dtv, a,
                                   bh, ch, d_skip)
        return act_sharding.model_gather(y, 2), state
    bh, ch = _block_of(bh, 2, size), _block_of(ch, 2, size)
    decay = torch.exp(dtv * a[None, :])
    state = state * decay[..., None, None] \
        + (dtv[..., None] * bh)[..., :, None] * xs[..., None, :]
    y = act_sharding.model_sum(torch.einsum("bhn,bhnp->bhp", ch, state))
    return y + d_skip[None, :, None] * xs, state
