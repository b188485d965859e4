"""The harness runs the program with its own spans off
(``repro_torch.core.spans``): neither a window nor the traced slice turns
them on, so every metric reads the program as it runs untraced, and no
``dinomo.`` range enters the profiler's trace."""

import pytest

from portbench import harness
from portbench.tests.cases import CELLS, TINY
from repro_torch.core import spans


@pytest.mark.parametrize("trace", [False, True])
@pytest.mark.parametrize("cell", CELLS)
def test_the_harness_leaves_the_program_spans_off(monkeypatch, cell, trace):
    turned_on = []
    monkeypatch.setattr(spans, "enable", lambda: turned_on.append(cell))
    spans.disable()
    spans.reset()
    line = harness.run_cell(cell, 2147483907, 0.2, trace, device="cpu",
                            overrides=TINY)
    assert line["correct"] is True
    assert turned_on == [] and not spans.enabled()
    assert spans.records() == [] and spans.summary()["counters"] == {}
