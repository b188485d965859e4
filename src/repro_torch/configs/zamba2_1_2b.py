"""zamba2-1.2b [hybrid]: Mamba2 backbone + shared attention block
(kv=32 i.e. MHA in the shared block), ssm_state=64.
[arXiv:2411.15242; hf]"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-1.2b", family="hybrid", num_layers=38, d_model=2048,
    num_heads=32, num_kv_heads=32, d_ff=8192, vocab_size=32000,
    ssm_state=64, ssm_headdim=64, ssm_groups=1, ssm_expand=2,
    attn_every=6, head_dim=64,
)

SMOKE_CONFIG = ModelConfig(
    name="zamba2-1.2b-smoke", family="hybrid", num_layers=5, d_model=64,
    num_heads=4, num_kv_heads=4, d_ff=128, vocab_size=512,
    ssm_state=16, ssm_headdim=16, ssm_groups=1, ssm_expand=2,
    attn_every=2, head_dim=16,
)
