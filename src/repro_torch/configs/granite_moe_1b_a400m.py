"""granite-moe-1b-a400m [moe]: 32 experts, top-8.
[hf:ibm-granite/granite-3.0-1b-a400m-base; hf]"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="granite-moe-1b-a400m", family="moe", num_layers=24, d_model=1024,
    num_heads=16, num_kv_heads=8, d_ff=512, vocab_size=49155,
    num_experts=32, experts_per_token=8,
)

SMOKE_CONFIG = ModelConfig(
    name="granite-moe-smoke", family="moe", num_layers=2, d_model=64,
    num_heads=4, num_kv_heads=2, d_ff=48, vocab_size=512,
    num_experts=4, experts_per_token=2,
)
