"""Public attention op in model layout (B, S, H, D): the flash_attention
kernel on the card at every length, and on CPU and meta tensors the plain
version the reference's ``attention`` lowers off the TPU
(``src/repro/kernels/flash_attention/ops.py:48-63``): the blocked
online-softmax attention above 2048 keys where Sk is a multiple of 1024
(heads-major under ``flash_attention.HEAD_SHARDED_ATTENTION``, set by
``set_head_sharded_attention``, when an activation-sharding
policy is installed and the heads divide its model axis), the dense
``mha_ref`` otherwise (``flash_attention.plain_attention``). Which runs
is chosen by where the tensors lie: there is no switch. The output
carries a graph on every device: ``FlashAttention``'s backward
differentiates the same plain version, as the reference's train step
differentiates its own. The dry run (``launch/dryrun.py``) reaches the
plain versions on meta tensors, as the reference's lowers its jnp paths
on a forced host platform."""

from __future__ import annotations

import torch

from .flash_attention import (FlashAttention,  # noqa: F401
                              set_head_sharded_attention)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True) -> torch.Tensor:
    """q: (B, S, H, D); k, v: (B, S, KH, D). Returns (B, S, H, D). The
    kernel reads the (B, H, S, D) views of the inputs and writes the
    output's through their strides: no transposed copy is made."""
    return FlashAttention.apply(q, k, v, causal, True)
