"""internlm2-20b [dense]: GQA kv=8. [arXiv:2403.17297; hf]"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="internlm2-20b", family="dense", num_layers=48, d_model=6144,
    num_heads=48, num_kv_heads=8, d_ff=16384, vocab_size=92544,
)

SMOKE_CONFIG = ModelConfig(
    name="internlm2-20b-smoke", family="dense", num_layers=2, d_model=96,
    num_heads=6, num_kv_heads=2, d_ff=256, vocab_size=512,
)
