"""The model families of the port behind the uniform interface of
model_zoo.py: the decoder-only transformer (dense, MoE and VLM;
layers.py, moe.py, transformer.py), the pure-SSM LM (mamba2.py,
ssm_lm.py), the Mamba2 hybrid with a shared attention block (zamba2.py)
and the encoder-decoder (encdec.py)."""

# the module that runs each family
RUNS = {"dense": "transformer", "moe": "transformer", "vlm": "transformer",
        "ssm": "ssm_lm", "hybrid": "zamba2", "encdec": "encdec",
        "audio": "encdec"}


def families_run_by(module: str) -> tuple:
    """The families that ``module`` (a module name of this package) runs."""
    return tuple(f for f, m in RUNS.items() if m == module)


def check_family(cfg, module: str) -> None:
    """Raise unless ``module`` (a module name of this package) runs cfg's
    family; the message names the module that does."""
    runs = RUNS.get(cfg.family)
    if runs == module:
        return
    where = f"models/{runs}.py runs it" if runs else "no module runs it"
    raise NotImplementedError(
        f"family {cfg.family!r}: models/{module}.py does not run it; "
        f"{where}")
