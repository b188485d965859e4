"""llama3.2-3b [dense]: small llama3, GQA kv=8.
[hf:meta-llama/Llama-3.2-1B; unverified]"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="llama3.2-3b", family="dense", num_layers=28, d_model=3072,
    num_heads=24, num_kv_heads=8, d_ff=8192, vocab_size=128256,
    rope_theta=5e5,
)

SMOKE_CONFIG = ModelConfig(
    name="llama3.2-3b-smoke", family="dense", num_layers=2, d_model=96,
    num_heads=6, num_kv_heads=2, d_ff=256, vocab_size=512,
)
