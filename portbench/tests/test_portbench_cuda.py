"""The cells through the port's kernels on the card, at a small size: the
same harness as the CPU tests, with the kernels in place of the plain
versions, and the trace read from the card."""

import pytest

from portbench import harness
from portbench.control import ControlStore
from portbench.tests.cases import CELLS

SMALL = {"cfg": {"records_log2": 16, "buckets_log2": 16,
                 "overflow_buckets_log2": 15, "segment_entries_log2": 16,
                 "heap_rows_log2": 16, "value_lanes": 256},
         "traffic": {"batch_log2": 12, "key_batches": 4, "sample_batches": 3,
                     "warmup_batches": 2, "traced_batches": 4,
                     "warmup_loads": 1, "traced_loads": 1}}


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_a_cell_on_the_card(cuda_device, cell):
    line = harness.run_cell(cell, 77, 0.5, True, device=cuda_device,
                            overrides=SMALL)
    assert line["correct"] is True, line["checks"]
    assert line["device"]["busy_s"] > 0
    assert "launches_per_batch" in line["metrics"]
    for name, m in line["metrics"].items():
        if name.endswith("_roofline"):
            assert 0 < m["value"] <= 100


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_the_control_on_the_card(cuda_device, cell):
    line = harness.run_cell(cell, 78, 0.3, False, device=cuda_device,
                            overrides=SMALL, store_cls=ControlStore)
    assert line["correct"] is False
