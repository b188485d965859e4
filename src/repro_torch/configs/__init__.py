"""Model configs of the port. ``get_config(name)`` returns the published
config, ``get_smoke_config(name)`` a reduced one of the same family.
The port carries the configs it runs so far: qwen1.5-0.5b (dense) and
mamba2-2.7b (ssm)."""

from importlib import import_module

from .base import ModelConfig

ALIASES = {"qwen1.5-0.5b": "qwen1_5_0_5b", "mamba2-2.7b": "mamba2_2_7b"}


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
