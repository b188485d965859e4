"""nemotron-4-15b [dense]: GQA kv=8, squared-ReLU MLP, 256 k vocab.
[arXiv:2402.16819; unverified]"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="nemotron-4-15b", family="dense", num_layers=32, d_model=6144,
    num_heads=48, num_kv_heads=8, d_ff=24576, vocab_size=256000,
    mlp="squared_relu",
)

SMOKE_CONFIG = ModelConfig(
    name="nemotron-4-15b-smoke", family="dense", num_layers=2, d_model=96,
    num_heads=6, num_kv_heads=2, d_ff=256, vocab_size=512,
    mlp="squared_relu",
)
