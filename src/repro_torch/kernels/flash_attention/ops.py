"""Public attention op in model layout (B, S, H, D): the flash_attention
kernel on the card, its plain version on the CPU, chosen by where the
tensors lie (there is no switch), with the output carrying a graph on
both (``FlashAttention``'s backward differentiates the plain version, as
the reference's train step differentiates its own). The reference's
sharded and blocked CPU paths (``blocked_mha_*``,
``HEAD_SHARDED_ATTENTION``) are not ported: training above 2048 keys
recomputes the dense ``mha_ref`` where the reference's blocked one would
save memory."""

from __future__ import annotations

import torch

from .flash_attention import FlashAttention


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True) -> torch.Tensor:
    """q: (B, S, H, D); k, v: (B, S, KH, D). Returns (B, S, H, D). The
    kernel reads the (B, H, S, D) views of the inputs and writes the
    output's through their strides: no transposed copy is made."""
    return FlashAttention.apply(q, k, v, causal, True)
