"""chameleon-34b [vlm]: early-fusion multimodal LM; VQ image tokens share
the text vocab, so the backbone is a plain decoder and the image
frontend (VQ-GAN tokenizer) is a stub. [arXiv:2405.09818; unverified]"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="chameleon-34b", family="vlm", num_layers=48, d_model=8192,
    num_heads=64, num_kv_heads=8, d_ff=22016, vocab_size=65536,
    frontend_stub=True, rope_theta=1e4,
)

SMOKE_CONFIG = ModelConfig(
    name="chameleon-34b-smoke", family="vlm", num_layers=2, d_model=64,
    num_heads=4, num_kv_heads=2, d_ff=160, vocab_size=512,
    frontend_stub=True,
)
