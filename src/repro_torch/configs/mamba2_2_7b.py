"""mamba2-2.7b [ssm]: attention-free SSD LM, 64 layers, state 128.
[arXiv:2405.21060; unverified]"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-2.7b", family="ssm", num_layers=64, d_model=2560,
    num_heads=0, num_kv_heads=0, d_ff=0, vocab_size=50280,
    ssm_state=128, ssm_headdim=64, ssm_groups=1, ssm_expand=2,
    tie_embeddings=True,
)

SMOKE_CONFIG = ModelConfig(
    name="mamba2-2.7b-smoke", family="ssm", num_layers=2, d_model=64,
    num_heads=0, num_kv_heads=0, d_ff=0, vocab_size=512,
    ssm_state=16, ssm_headdim=16, ssm_groups=1, ssm_expand=2,
    tie_embeddings=True,
)
