"""Model and run configuration (the port's copies of the reference's
ModelConfig, with the fields and the analytic parameter count unchanged,
and of its ShapeConfig and the four input shapes of its cells)."""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                    # dense | moe | ssm | hybrid | encdec | vlm
    num_layers: int
    d_model: int
    num_heads: int                 # 0 for attention-free archs
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0              # 0 -> d_model // num_heads
    # --- MoE ---
    num_experts: int = 0
    experts_per_token: int = 0
    moe_capacity_factor: float = 1.25
    # --- SSM (mamba2) ---
    ssm_state: int = 0
    ssm_headdim: int = 64
    ssm_groups: int = 1
    ssm_expand: int = 2
    ssm_conv: int = 4
    # --- flags ---
    qkv_bias: bool = False
    mlp: str = "swiglu"            # swiglu | squared_relu
    tie_embeddings: bool = False
    rope_theta: float = 1e4
    norm_eps: float = 1e-5
    # --- enc-dec ---
    encoder_layers: int = 0        # >0 -> encoder-decoder model
    # --- hybrid (zamba2-style) ---
    attn_every: int = 0            # shared attn block period (0 = none)
    # --- frontend stubs (vlm/audio): inputs are precomputed embeddings ---
    frontend_stub: bool = False
    # --- training-time knobs (affect lowering, not the architecture) ---
    remat: str = "none"            # none | full (checkpoint each block)
    loss_chunk: int = 0            # >0: chunk the unembed+CE over seq

    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // max(self.num_heads, 1))

    @property
    def ssm_heads(self) -> int:
        return (self.ssm_expand * self.d_model) // self.ssm_headdim

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    def param_count(self) -> int:
        """Analytic parameter count (biases and norms left out, as in the
        reference)."""
        d, ff, v = self.d_model, self.d_ff, self.vocab_size
        emb = v * d * (1 if self.tie_embeddings else 2)
        per_attn = (self.num_heads * self.hd + 2 * self.num_kv_heads
                    * self.hd) * d + self.num_heads * self.hd * d
        if self.mlp == "swiglu":
            per_mlp = 3 * d * ff
        else:
            per_mlp = 2 * d * ff
        if self.family == "moe":
            per_mlp = self.num_experts * 3 * d * ff + d * self.num_experts
        if self.family in ("ssm", "hybrid"):
            din, ns, gh = self.d_inner, self.ssm_state, self.ssm_groups
            per = d * (2 * din + 2 * gh * ns + self.ssm_heads) + din * d \
                + self.ssm_conv * (din + 2 * gh * ns) + 3 * self.ssm_heads
            n = self.num_layers * per
            if self.family == "hybrid":
                n += per_attn + per_mlp                  # shared block
        elif self.encoder_layers:
            n = (self.encoder_layers + self.num_layers) * (per_attn + per_mlp)
            n += self.num_layers * per_attn          # cross attention
        else:
            n = self.num_layers * (per_attn + per_mlp)
        return n + emb

    def active_param_count(self) -> int:
        """Parameters touched per token (MoE: top-k experts only)."""
        if self.family != "moe":
            return self.param_count()
        d, ff = self.d_model, self.d_ff
        full_mlp = self.num_layers * self.num_experts * 3 * d * ff
        act_mlp = self.num_layers * self.experts_per_token * 3 * d * ff
        return self.param_count() - full_mlp + act_mlp


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                      # train | prefill | decode

    @property
    def is_decode(self) -> bool:
        return self.kind == "decode"


TRAIN_4K = ShapeConfig("train_4k", 4096, 256, "train")
PREFILL_32K = ShapeConfig("prefill_32k", 32768, 32, "prefill")
DECODE_32K = ShapeConfig("decode_32k", 32768, 128, "decode")
LONG_500K = ShapeConfig("long_500k", 524288, 1, "decode")
SHAPES = {s.name: s for s in (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)}
