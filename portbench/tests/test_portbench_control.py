"""The comparison fails what it must: the control (the reference in the
program's place, its rows as float32) and the timed path broken
underneath in each way a cell of one card can break, at a tiny size on
the CPU."""

import pytest
import torch

from portbench import harness
from portbench.control import ControlStore
from portbench.tests.cases import CELLS, TINY
from repro_torch.kernels.clht_probe import ops as probe_ops
from repro_torch.kernels.log_merge import ops as merge_ops


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_comes_out_not_correct(cell):
    line = harness.run_cell(cell, 9, 0.2, False, device="cpu",
                            overrides=TINY, store_cls=ControlStore)
    assert line["correct"] is False
    assert max(c["value"] for c in line["checks"].values()) > 0


def _altered_read(orig):
    def read(table, heap, keys):
        vals, ptrs, found = orig(table, heap, keys)
        vals = vals.clone()
        vals[keys.numel() // 2, 0] ^= 1
        return vals, ptrs, found
    return read


def _half_read(orig):
    def read(table, heap, keys):
        h = keys.numel() // 2
        vals, ptrs, found = orig(table, heap, keys[:h])
        pad = keys.numel() - h
        return (torch.cat([vals, vals.new_zeros(pad, vals.shape[1])]),
                torch.cat([ptrs, ptrs.new_full((pad,), -1)]),
                torch.cat([found, found.new_zeros(pad)]))
    return read


def _unchanged_write(orig):
    def write(table, seg, heap, keys, values):
        n = keys.numel()
        ok = torch.ones(n, dtype=torch.bool)
        none = torch.full((n,), -1, dtype=torch.int32)
        return table, seg, heap, none, none, ok
    return write


def _half_write(orig):
    def write(table, seg, heap, keys, values):
        h = keys.numel() // 2
        out = orig(table, seg, heap, keys[:h], values[:h])
        ok = torch.cat([out[5], torch.ones(keys.numel() - h,
                                           dtype=torch.bool)])
        return (*out[:5], ok)
    return write


def _altered_write(orig):
    def write(table, seg, heap, keys, values):
        values = values.clone()
        values[0, 0] ^= 1
        return orig(table, seg, heap, keys, values)
    return write


def _ok_altered(orig):
    def write(table, seg, heap, keys, values):
        out = orig(table, seg, heap, keys, values)
        ok = out[5].clone()
        ok[-1] = False
        return (*out[:5], ok)
    return write


# the faults each cell's timed path can have: the read cells time
# kvs_lookup, the load cell log_append_merge
READS = ("ycsb-32g-z099.read_only", "ycsb-32g-z05.read_only")
LOADS = ("ycsb-32g-z099.load",)
FAULTS = {
    "answer_altered": (probe_ops, "kvs_lookup", _altered_read, READS),
    "half_the_batch_left_out": (probe_ops, "kvs_lookup", _half_read,
                                READS),
    "state_unchanged": (merge_ops, "log_append_merge", _unchanged_write,
                        LOADS),
    "half_the_writes_left_out": (merge_ops, "log_append_merge",
                                 _half_write, LOADS),
    "value_altered_where_written": (merge_ops, "log_append_merge",
                                    _altered_write, LOADS),
    "ok_altered_where_produced": (merge_ops, "log_append_merge",
                                  _ok_altered, LOADS),
}
CASES = [(f, c) for f, (*_, cells) in sorted(FAULTS.items()) for c in cells]


def test_every_cell_has_its_faults():
    assert {c for _, c in CASES} == set(CELLS)


@pytest.mark.parametrize("fault,cell", CASES)
def test_a_broken_timed_path_comes_out_not_correct(monkeypatch, fault,
                                                   cell):
    module, name, breaker, _ = FAULTS[fault]
    monkeypatch.setattr(module, name, breaker(getattr(module, name)))
    line = harness.run_cell(cell, 4, 0.2, False, device="cpu",
                            overrides=TINY)
    assert line["correct"] is False, line["checks"]
