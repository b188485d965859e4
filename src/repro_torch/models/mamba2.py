"""Mamba2 block (SSD, arXiv:2405.21060): in_proj -> [z | x | B | C | dt];
causal depthwise conv over (x | B | C); the SSD scan; gated RMSNorm;
out_proj. Decode keeps a (conv, ssm) recurrent state per layer.

The casts follow the reference's exactly, because prefill and decode
differ in them and their agreement depends on both: the prefill conv
multiplies and sums in bf16, term by term, then adds a bf16 bias, and
only its result goes to f32 for the silu; the decode conv runs in f32
over an f32 window (the conv state is f32 and the concat promotes).
``a_log``, ``dt_bias`` and ``d_skip`` are f32 parameters.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..device import resolve_device
from ..kernels.ssd_scan.ops import ssd
from ..kernels.ssd_scan.ref import ssd_decode_step
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
    reference's bf16 arithmetic rounds them."""
    k, s = w.shape[0], xbc.shape[1]
    pad = F.pad(xbc, (0, 0, k - 1, 0))
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
    """x: (B, 1, d). Returns (y (B, 1, d), new state)."""
    bsz = x.shape[0]
    din, g, n, h = cfg.d_inner, cfg.ssm_groups, cfg.ssm_state, cfg.ssm_heads
    zxbcdt = x @ p["in_proj"]
    z, xbc, dt = _split(cfg, zxbcdt)
    wtype = torch.promote_types(state["conv"].dtype, xbc.dtype)
    window = torch.cat([state["conv"].to(wtype), xbc.to(wtype)], dim=1)
    conv = torch.einsum("bkc,kc->bc", window.float(), p["conv_w"].float()) \
        + p["conv_b"].float()
    xbc1 = F.silu(conv).to(x.dtype)                         # (B, C)
    xs = xbc1[..., :din].reshape(bsz, h, cfg.ssm_headdim)
    bmat = xbc1[..., din:din + g * n].reshape(bsz, g, n)
    cmat = xbc1[..., din + g * n:].reshape(bsz, g, n)
    dtv = F.softplus(dt[:, 0].float() + p["dt_bias"])
    a = -torch.exp(p["a_log"])
    y, ssm = ssd_decode_step(state["ssm"], xs.float(), dtv, a,
                             bmat.float(), cmat.float(), p["d_skip"])
    y = y.reshape(bsz, 1, din).to(x.dtype) \
        * F.silu(z.float()).to(x.dtype)
    y = rmsnorm(p["norm_w"], y, cfg.norm_eps)
    return y @ p["out_proj"], {"conv": window[:, 1:], "ssm": ssm}
