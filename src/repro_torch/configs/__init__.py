"""Model configs of the port. ``get_config(name)`` returns the published
config, ``get_smoke_config(name)`` a reduced one of the same family.
The port carries every config of the reference (``ARCHS``): the dense, MoE
and VLM decoders, the pure SSM, the hybrid (zamba2-1.2b) and the
encoder-decoder (seamless-m4t-medium); and the reference's four cell
shapes (``SHAPES``)."""

from importlib import import_module

from .base import (DECODE_32K, LONG_500K, PREFILL_32K, SHAPES, TRAIN_4K,
                   ModelConfig, ShapeConfig)

ARCHS = [
    "chameleon_34b", "olmoe_1b_7b", "granite_moe_1b_a400m", "llama3_2_3b",
    "internlm2_20b", "qwen1_5_0_5b", "nemotron_4_15b", "zamba2_1_2b",
    "seamless_m4t_medium", "mamba2_2_7b",
]
# canonical ids as assigned (dashes/dots) -> module names
ALIASES = {
    "chameleon-34b": "chameleon_34b",
    "olmoe-1b-7b": "olmoe_1b_7b",
    "granite-moe-1b-a400m": "granite_moe_1b_a400m",
    "llama3.2-3b": "llama3_2_3b",
    "internlm2-20b": "internlm2_20b",
    "qwen1.5-0.5b": "qwen1_5_0_5b",
    "nemotron-4-15b": "nemotron_4_15b",
    "zamba2-1.2b": "zamba2_1_2b",
    "seamless-m4t-medium": "seamless_m4t_medium",
    "mamba2-2.7b": "mamba2_2_7b",
}


def _module(name: str):
    mod = ALIASES.get(name, name).replace("-", "_").replace(".", "_")
    if mod not in ALIASES.values():
        raise KeyError(f"the port has no config {name!r} yet; it has "
                       f"{sorted(ALIASES)}")
    return import_module(f"{__name__}.{mod}")


def get_config(name: str) -> ModelConfig:
    return _module(name).CONFIG


def get_smoke_config(name: str) -> ModelConfig:
    return _module(name).SMOKE_CONFIG


def all_configs():
    return {a: get_config(a) for a in ARCHS}
