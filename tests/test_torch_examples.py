"""The port's example scripts (examples/*_torch.py) run end to end on the
CPU at their smoke sizes: quickstart (the KVS, a model's loss and decode
step, paged serving), serve_paged (six requests sharing a prefix, a
worker joining mid-flight with the logits unchanged) and kvs_elasticity
(the Sec. 5.3 timeline cut tenfold by --smoke), each with --device cpu."""

import importlib.util
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

EXAMPLES = Path(__file__).resolve().parents[1] / "examples"


@pytest.mark.parametrize("name,argv,expect", [
    ("quickstart_torch", [], "page tables re-mapped"),
    ("serve_paged_torch", [], "logits unchanged"),
    ("kvs_elasticity_torch", ["--smoke"], "reconfigurations:"),
])
def test_example_runs_on_the_cpu(name, argv, expect, capsys):
    spec = importlib.util.spec_from_file_location(name,
                                                  EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.main(argv + ["--device", "cpu"])
    assert expect in capsys.readouterr().out
