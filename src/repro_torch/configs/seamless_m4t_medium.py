"""seamless-m4t-medium [audio]: enc-dec transformer backbone; the audio
frontend is a stub (precomputed frame embeddings). 12 encoder + 12
decoder layers. [arXiv:2308.11596; hf]"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-medium", family="encdec", num_layers=12,
    d_model=1024, num_heads=16, num_kv_heads=16, d_ff=4096,
    vocab_size=256206, encoder_layers=12, frontend_stub=True,
)

SMOKE_CONFIG = ModelConfig(
    name="seamless-m4t-medium-smoke", family="encdec", num_layers=2,
    d_model=64, num_heads=4, num_kv_heads=4, d_ff=128, vocab_size=512,
    encoder_layers=2, frontend_stub=True,
)
