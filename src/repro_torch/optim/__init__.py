"""The optimizer of the train step: AdamW, its schedule and gradient
compression (adamw.py)."""

from .adamw import (AdamWConfig, apply_updates, compress_int8,
                    compressed_grad, decompress_int8, global_norm,
                    init_state, schedule, topk_sparsify)
