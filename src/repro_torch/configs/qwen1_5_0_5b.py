"""qwen1.5-0.5b [dense]: QKV bias, MHA (kv=16). [hf:Qwen/Qwen1.5-0.5B]"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="qwen1.5-0.5b", family="dense", num_layers=24, d_model=1024,
    num_heads=16, num_kv_heads=16, d_ff=2816, vocab_size=151936,
    qkv_bias=True,
)

SMOKE_CONFIG = ModelConfig(
    name="qwen1.5-0.5b-smoke", family="dense", num_layers=2, d_model=64,
    num_heads=4, num_kv_heads=4, d_ff=160, vocab_size=512, qkv_bias=True,
)
