"""Public attention op in model layout (B, S, H, D): the flash_attention
kernel on the card, its plain version on the CPU, chosen by where the
tensors lie (there is no switch). The reference's sharded and blocked
CPU paths (``blocked_mha_*``, ``HEAD_SHARDED_ATTENTION``) are not
ported."""

from __future__ import annotations

import torch

from .flash_attention import flash_attention


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True) -> torch.Tensor:
    """q: (B, S, H, D); k, v: (B, S, KH, D). Returns (B, S, H, D). The
    kernel reads the (B, H, S, D) views of the inputs and writes the
    output's through their strides: no transposed copy is made."""
    out = torch.empty_like(q, memory_format=torch.contiguous_format)
    flash_attention(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                    causal=causal, out=out.transpose(1, 2))
    return out
