"""Kernel 5, prefill attention: multi-head / grouped-query attention with
an online softmax in f32 and the causal mask of the reference's Pallas
kernel (``csrc/flash_attention.cu``: bf16 inputs through TMA and wgmma
on the tensor cores, f32 inputs on the CUDA cores), for head dims 16, 32,
64 and 128 (at 128 each tile is loaded as two 64-column halves).

CPU tensors run the plain version in ref.py; CUDA tensors run the kernel.
A causal call with Sq != Sk raises on both: there the reference's kernel
(top-left mask) and its oracle (bottom-right) disagree, and the model
never makes such a call.
"""

from __future__ import annotations

import torch

from ...device import on_cuda
from .. import _build
from .ref import mha_ref

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (16, 32, 64, 128)


def _check(q, k, v, causal):
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"expected q (B,H,Sq,D), k = v (B,KH,Sk,D); got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    b, h, sq, d = q.shape
    if k.shape[0] != b or k.shape[3] != d or h % k.shape[1]:
        raise ValueError("q and k/v differ in batch or head size, or H is "
                         "not a multiple of KH")
    if causal and sq != k.shape[2]:
        raise ValueError("causal attention needs Sq == Sk (the reference's "
                         "kernel and oracle disagree otherwise)")


def _strides(t: torch.Tensor, align: int):
    """(b, h, s) strides; raises unless D is contiguous and, in bytes,
    the data and every row start are ``align``-aligned."""
    if t.stride(3) != 1:
        raise ValueError("the head dimension must be contiguous")
    strides = (t.stride(0), t.stride(1), t.stride(2))
    if t.data_ptr() % align or any(s * t.element_size() % align
                                   for s in strides):
        raise ValueError(f"rows must be {align}-byte aligned")
    return strides


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True,
                    out: torch.Tensor | None = None) -> torch.Tensor:
    """q: (B, H, Sq, D); k, v: (B, KH, Sk, D) with H % KH == 0. Returns
    (B, H, Sq, D) in q's type, written into ``out`` when it is given.
    Any strides are taken as they are, as long as D is contiguous: the
    kernel reads and writes through them, so transposed views of the
    model layout need no copy."""
    _check(q, k, v, causal)
    b, h, sq, d = q.shape
    if out is None:
        out = torch.empty((b, h, sq, d), dtype=q.dtype, device=q.device)
    elif out.shape != q.shape or out.dtype != q.dtype:
        raise ValueError("out must match q in shape and type")
    if not on_cuda(q, k, v, out):
        out.copy_(mha_ref(q, k, v, causal=causal))
        return out
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"expected float32 or bfloat16 q, k, v of one type; "
                        f"got {q.dtype}, {k.dtype}, {v.dtype}")
    if d not in HEAD_DIMS:
        raise ValueError(f"head dim {d} not in {HEAD_DIMS}")
    # the bf16 kernel loads q, k and v with TMA, which needs 16-byte
    # aligned rows and strides, and writes pairs of outputs
    align = 16 if q.dtype == torch.bfloat16 else 4
    strides = [s for t in (q, k, v) for s in _strides(t, align)]
    strides += _strides(out, 4)
    _build.launch("flash_attention", "flash_attention_launch", b * h * sq,
                  _DTYPES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
                  out.data_ptr(), b, h, k.shape[1], sq, k.shape[2], d,
                  *strides, d ** -0.5, int(causal), _build.stream(q))
    return out
