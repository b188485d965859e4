"""olmoe-1b-7b [moe]: 64 experts, top-8, 1B active / 7B total.
[arXiv:2409.02060; hf]"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="olmoe-1b-7b", family="moe", num_layers=16, d_model=2048,
    num_heads=16, num_kv_heads=16, d_ff=1024, vocab_size=50304,
    num_experts=64, experts_per_token=8,
)

SMOKE_CONFIG = ModelConfig(
    name="olmoe-1b-7b-smoke", family="moe", num_layers=2, d_model=64,
    num_heads=4, num_kv_heads=4, d_ff=64, vocab_size=512,
    num_experts=8, experts_per_token=2,
)
