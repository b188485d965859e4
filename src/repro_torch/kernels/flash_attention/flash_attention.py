"""Kernel 5, prefill attention: multi-head / grouped-query attention with
an online softmax in f32 and the causal mask of the reference's Pallas
kernel (``csrc/flash_attention.cu``), for head dims 16, 32, 64 and 128.
bf16 inputs run a warp-specialised Hopper kernel: a persistent grid, a
producer warpgroup loading Q and 128-key K/V tiles by TMA, and 2 or 3
consumer warpgroups of 64 query rows taking turns on the tensor cores
(``consumer_warpgroups`` picks their number from Sq and the head dim);
f32 inputs run on the CUDA cores.

CPU and meta tensors run a plain version in ref.py (``plain_attention``);
CUDA tensors run the kernel, at every length.
A causal call with Sq != Sk raises on both: there the reference's kernel
(top-left mask) and its oracle (bottom-right) disagree, and the model
never makes such a call.

Both run inside ``FlashAttention``, an autograd function whose backward
differentiates ``plain_attention``, so the output carries a graph on
every device. ``out=`` cannot carry one: with it, an input that requires grad
raises.
"""

from __future__ import annotations

import torch

from ...device import on_cuda
from ...distributed.act_sharding import head_sharding_active
from .. import _build
from .ref import blocked_mha, blocked_mha_heads, mha_ref

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (16, 32, 64, 128)
# the reference's attention goes blocked off the TPU above this many keys,
# where they are a multiple of the block
BLOCKED_ABOVE, BLOCK = 2048, 1024
# §Perf toggle: when an activation-sharding policy is installed and the
# head count divides the model axis, the plain version off the card is the
# head-major blocked attention. Off by default, as in the reference.
HEAD_SHARDED_ATTENTION = False


def set_head_sharded_attention(v: bool) -> None:
    global HEAD_SHARDED_ATTENTION
    HEAD_SHARDED_ATTENTION = v


def plain_attention(q, k, v, causal: bool) -> torch.Tensor:
    """The plain version of (B, H, Sq, D) / (B, KH, Sk, D) attention that
    the reference runs off the TPU (its ops.py:48-63): ``blocked_mha``
    (``blocked_mha_heads`` under ``HEAD_SHARDED_ATTENTION`` with
    ``head_sharding_active``) above BLOCKED_ABOVE keys where Sk % BLOCK is
    0, ``mha_ref`` otherwise."""
    sk = k.shape[2]
    if sk > BLOCKED_ABOVE and sk % BLOCK == 0:
        if HEAD_SHARDED_ATTENTION and head_sharding_active(q.shape[1]):
            return blocked_mha_heads(q, k, v, causal=causal, bk=BLOCK)
        return blocked_mha(q, k, v, causal=causal, bk=BLOCK)
    return mha_ref(q, k, v, causal=causal)


def consumer_warpgroups(sq: int, d: int) -> int:
    """The bf16 kernel's consumer warpgroups for Sq queries of head dim d:
    3 (192 query rows a block) at d <= 64, where a tile's exponentials take
    as long as its products and a third consumer keeps the tensor cores
    fed, unless 192-row blocks pad Sq by more than 1/16 beyond what
    128-row blocks pad (Sq 256: 384 rows against 256); else 2 (128 rows).
    """
    if d > 64:
        return 2
    rows3 = -(-sq // 192) * 192
    rows2 = -(-sq // 128) * 128
    return 3 if 16 * rows3 <= 17 * rows2 else 2


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


def _run(q, k, v, causal: bool, out: torch.Tensor) -> None:
    """Write attention of the (B, H, Sq, D) / (B, KH, Sk, D) views into
    ``out`` (B, H, Sq, D): the kernel on the card, plain_attention on CPU
    and meta tensors. Records no graph."""
    _check(q, k, v, causal)
    if out.shape != q.shape or out.dtype != q.dtype:
        raise ValueError("out must match q in shape and type")
    if not on_cuda(q, k, v, out):
        out.copy_(plain_attention(q, k, v, causal))
        return
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"expected float32 or bfloat16 q, k, v of one type; "
                        f"got {q.dtype}, {k.dtype}, {v.dtype}")
    b, h, sq, d = q.shape
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
                  *strides, d ** -0.5, int(causal),
                  consumer_warpgroups(sq, d), _build.stream(q))


def _heads_major(t: torch.Tensor, model_layout: bool) -> torch.Tensor:
    return t.transpose(1, 2) if model_layout else t


class FlashAttention(torch.autograd.Function):
    """Kernel 5 forward, plain backward. ``apply(q, k, v, causal,
    model_layout)``: q, k, v in (B, H, S, D) layout, or in the model's
    (B, S, H, D) with ``model_layout``, where the kernel reads their
    (B, H, S, D) views and writes a contiguous (B, S, H, D) output through
    its view (no transposed copy either way).

    The forward launches the kernel (plain_attention on CPU and meta
    tensors) and saves q, k and v as given, views included. The backward
    recomputes plain_attention on detached copies under autograd and
    returns ``torch.autograd.grad`` of that recompute, shaped like the
    inputs: the port of what the reference's train step differentiates,
    ``mha_ref`` (src/repro/kernels/flash_attention/ops.py:63) or, above
    2048 keys in blocks of 1024, ``blocked_mha_jnp`` (:61) or
    ``blocked_mha_heads`` (:58), whose memory grows with S * 1024 and not
    with S^2. The reference has no backward kernel, so neither has the
    port."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, model_layout: bool):
        ctx.save_for_backward(q, k, v)
        ctx.causal, ctx.model_layout = causal, model_layout
        if model_layout:
            out = torch.empty_like(q, memory_format=torch.contiguous_format)
        else:
            out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
        _run(*(_heads_major(t, model_layout) for t in (q, k, v)), causal,
             _heads_major(out, model_layout))
        return out

    @staticmethod
    def backward(ctx, grad):
        inputs = [t.detach().requires_grad_() for t in ctx.saved_tensors]
        with torch.enable_grad():
            out = plain_attention(*(_heads_major(t, ctx.model_layout)
                                    for t in inputs), ctx.causal)
            grads = torch.autograd.grad(
                _heads_major(out, ctx.model_layout), inputs, grad)
        return (*grads, None, None)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True,
                    out: torch.Tensor | None = None) -> torch.Tensor:
    """q: (B, H, Sq, D); k, v: (B, KH, Sk, D) with H % KH == 0. Returns
    (B, H, Sq, D) in q's type, with a graph through ``FlashAttention``;
    or written into ``out`` when it is given, which records no graph and
    so raises when grad is enabled and an input requires it. Any strides
    are taken as they are, as long as D is contiguous: the kernel reads and
    writes through them, so transposed views of the model layout need no
    copy."""
    if out is None:
        return FlashAttention.apply(q, k, v, causal, False)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise RuntimeError("flash_attention(out=...) records no autograd "
                           "graph; call it without out= for inputs that "
                           "require grad")
    _run(q, k, v, causal, out)
    return out
