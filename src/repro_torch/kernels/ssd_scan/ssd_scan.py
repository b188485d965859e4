"""Kernel 7, the Mamba2 SSD chunked scan (``csrc/ssd_scan.cu``): per
(batch, head) and chunk of L tokens, the intra-chunk quadratic form
S = (C.B^T) o exp(min(cum_i - cum_j, 0)) o dt_j (i >= j), the carried
(N, P) state and D.x, accumulated in f32. f32 inputs are computed in
f32; bf16 inputs (the model's) on the tensor cores, with S, B o w and the
state's copy for C.h rounded to bf16 as operands.

CPU tensors run the plain version (``ref.ssd_chunked``); CUDA tensors run
the kernel. Both run inside ``SSDScan``, an autograd function whose
backward differentiates the plain version, so y carries a graph on every
device.
"""

from __future__ import annotations

import torch

from ...device import on_cuda
from .. import _build
from .ref import ssd_chunked

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_CHUNK = 64          # the kernel's shared-memory tiles hold 64 tokens
MAX_STATE = 128         # ... and an (N, P) state with N up to 128
MAX_HEAD = 64           # ... and P up to 64


def _check(x, dt, a, b, c, d, chunk):
    if x.dim() != 4 or b.dim() != 4 or c.shape != b.shape:
        raise ValueError(f"expected x (B,S,H,P), b = c (B,S,G,N); got "
                         f"{tuple(x.shape)}, {tuple(b.shape)}, "
                         f"{tuple(c.shape)}")
    bsz, s, h, _ = x.shape
    if tuple(dt.shape) != (bsz, s, h) or tuple(a.shape) != (h,) \
            or tuple(d.shape) != (h,):
        raise ValueError("dt must be (B,S,H) and a, d (H,) for x (B,S,H,P)")
    if b.shape[:2] != x.shape[:2] or h % b.shape[2]:
        raise ValueError("b, c differ from x in batch or sequence, or H is "
                         "not a multiple of G")
    if chunk <= 0 or s % chunk:
        raise ValueError(f"sequence length {s} is not a multiple of the "
                         f"chunk {chunk}")


def _rows(t: torch.Tensor, name: str):
    """(batch, seq) strides of a (B, S, X, Y) tensor whose (X, Y) block
    is packed; raises otherwise."""
    if t.stride(3) != 1 or t.stride(2) != t.shape[3]:
        raise ValueError(f"{name}: the last two dims must be contiguous")
    return t.stride(0), t.stride(1)


def _run(x, dt, a, b, c, d, chunk: int) -> torch.Tensor:
    """y of the kernel on the card, of ssd_chunked on the CPU; records no
    graph."""
    if not on_cuda(x, dt, a, b, c, d):
        return ssd_chunked(x, dt, a, b, c, d, chunk)
    if x.dtype not in _DTYPES or b.dtype != x.dtype or c.dtype != x.dtype:
        raise TypeError(f"x, b, c: expected float32 or bfloat16 of one type; "
                        f"got {x.dtype}, {b.dtype}, {c.dtype}")
    for name, t in (("dt", dt), ("a", a), ("d", d)):
        _build.require(t, name, torch.float32, t.dim())
    bsz, s, h, p = x.shape
    g, n = b.shape[2], b.shape[3]
    if chunk > MAX_CHUNK:
        raise ValueError(f"chunk {chunk}: the kernel takes chunks of up to "
                         f"{MAX_CHUNK} tokens")
    if n > MAX_STATE or n % 4:
        raise ValueError(f"state size {n}: the kernel takes multiples of 4 "
                         f"up to {MAX_STATE}")
    if p > MAX_HEAD or p % 4:
        raise ValueError(f"head dim {p}: the kernel takes multiples of 4 up "
                         f"to {MAX_HEAD}")
    strides = [*_rows(x, "x"), *_rows(b, "b"), *_rows(c, "c")]
    y = torch.empty((bsz, s, h, p), dtype=x.dtype, device=x.device)
    _build.launch("ssd_scan", "ssd_scan_launch", bsz * s * h,
                  _DTYPES[x.dtype], x.data_ptr(), dt.data_ptr(),
                  a.data_ptr(), b.data_ptr(), c.data_ptr(), d.data_ptr(),
                  y.data_ptr(), bsz, s, h, g, n, p, chunk, *strides,
                  _build.stream(x))
    return y


class SSDScan(torch.autograd.Function):
    """Kernel 7 forward, plain backward: ``apply(x, dt, a, b, c, d,
    chunk)``. The forward launches the kernel (ssd_chunked on CPU
    tensors) and saves the six inputs as given, the strided views of one
    projection included. The backward recomputes ``ref.ssd_chunked`` on
    detached copies under autograd and returns ``torch.autograd.grad`` of
    that recompute for each input that needs one, shaped like it: the
    port of what the reference's train step differentiates,
    ``_ssd_chunked_jnp`` (src/repro/kernels/ssd_scan/ops.py:25, called at
    :83). The reference has no backward kernel, so neither has the
    port."""

    @staticmethod
    def forward(ctx, x, dt, a, b, c, d, chunk: int):
        ctx.save_for_backward(x, dt, a, b, c, d)
        ctx.chunk = chunk
        return _run(x, dt, a, b, c, d, chunk)

    @staticmethod
    def backward(ctx, grad):
        need = ctx.needs_input_grad[:6]
        inputs = [t.detach().requires_grad_(n)
                  for t, n in zip(ctx.saved_tensors, need)]
        with torch.enable_grad():
            y = ssd_chunked(*inputs, ctx.chunk)
            wrt = [t for t, n in zip(inputs, need) if n]
            got = iter(torch.autograd.grad(y, wrt, grad))
        return (*(next(got) if n else None for n in need), None)


def ssd_scan(x, dt, a, b, c, d, *, chunk: int = 64) -> torch.Tensor:
    """x: (B, S, H, P); dt: (B, S, H) (positive, post-softplus); a: (H,)
    (negative); b, c: (B, S, G, N); d: (H,). Returns y (B, S, H, P) in
    x's type, with a graph through ``SSDScan``. S must be a multiple of
    ``chunk``.

    On the card x, b and c are float32 or bfloat16 of one type and may be
    strided views as long as their last two dims are packed (the model
    hands it slices of one projection); dt, a and d are contiguous
    float32."""
    _check(x, dt, a, b, c, d, chunk)
    return SSDScan.apply(x, dt, a, b, c, d, chunk)
