"""Every cell end to end on the CPU at a tiny size: the port's plain
versions under the harness, the reference compared, and the result line
and the spec in the shape the benchmark's contract gives them."""

import json
import os
import re

import pytest
import torch

from portbench import harness
from portbench.tests.cases import CELLS, TINY

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.mark.parametrize("cell", CELLS)
def test_a_cell_runs_and_comes_out_correct(cell):
    line = harness.run_cell(cell, 2147483901, 0.2, False, device="cpu",
                            overrides=TINY)
    assert line["correct"] is True
    assert line["attempted"] > 0 and line["failed"] == 0
    assert line["compared"] > 0
    assert set(line["metrics"]) == {"ops_per_s", "p99_batch_ms", "setup_s"}
    assert all(m["value"] > 0 for m in line["metrics"].values())
    assert list(line)[-1] == "checks"
    assert all(c["value"] == 0 and c["limit"] == 0
               for c in line["checks"].values())
    assert line["device"]["count"] == 1
    json.dumps(line)


@pytest.mark.parametrize("cell", CELLS)
def test_a_traced_run_reads_the_spans_it_can_on_the_cpu(cell):
    line = harness.run_cell(cell, 5, 0.2, True, device="cpu",
                            overrides=TINY)
    assert line["correct"] is True
    # no device operation on the CPU: the trace's metrics read nothing
    kind = "write_call_ms" if cell.endswith(".load") else "read_call_ms"
    assert set(line["metrics"]) == {kind}
    assert "busy_s" not in line["device"]


@pytest.mark.parametrize("cell", CELLS)
def test_a_traced_run_profiles_only_after_its_window(monkeypatch, cell):
    events = []
    batch, traced = harness.Clock.batch, harness._traced

    def timed(self, fn, *args):
        events.append(("batch", torch.autograd._profiler_enabled()))
        return batch(self, fn, *args)

    def profiled(clock, body):
        events.append(("traced", None))
        return traced(clock, body)

    monkeypatch.setattr(harness.Clock, "batch", timed)
    monkeypatch.setattr(harness, "_traced", profiled)
    line = harness.run_cell(cell, 6, 0.2, True, device="cpu",
                            overrides=TINY)
    assert line["correct"] is True
    kinds = [k for k, _ in events]
    assert kinds.count("traced") == 1 and kinds[-1] == "traced"
    assert kinds.count("batch") > 0
    assert not any(on for k, on in events if k == "batch")


def test_the_spec_keeps_to_the_contract_and_names_files_that_exist():
    spec = harness.load_spec()
    assert set(spec) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert spec["paths"] == ["portbench"] and 1 <= spec["run_seconds"] <= 51
    configs = {c["name"] for c in spec["configs"]}
    cells = [w["name"] for w in spec["workloads"]]
    assert tuple(cells) == CELLS
    assert {w["config"] for w in spec["workloads"]} == configs
    for c in spec["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert os.path.exists(os.path.join(harness.ROOT, c["file"]))
    pairs = set()
    for w in spec["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        assert os.path.exists(os.path.join(
            harness.HERE, "workloads", w["traffic"] + ".json"))
    names = [m["name"] for m in spec["end_to_end"] + spec["per_layer"]]
    assert len(set(names)) == len(names) and "setup_s" in names
    for m in spec["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in spec["end_to_end"] + spec["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert os.path.exists(os.path.join(harness.HERE, "metrics",
                                           m["name"] + ".py"))
        assert set(m.get("workloads", cells)) <= set(cells)
    for m in spec["per_layer"]:
        assert m["moves"] in {e["name"] for e in spec["end_to_end"]}
    for cell in cells:
        c = harness.find_cell(spec, cell)
        assert c["per_layer"] and len(c["end_to_end"]) >= 2
    assert len(json.dumps(spec)) < 64 * 1024
