"""The least-byte counts on hand-counted small batches, and the roofline
share they give."""

import torch

from portbench import least_bytes as lb
from portbench.harness import Run
from portbench.trace import Call, Trace


def test_lookup_bytes_count_each_distinct_present_row_once():
    keys = torch.tensor([5, 5, 7, 9, 5], dtype=torch.int32)
    present = torch.tensor([True, True, True, False, True])
    # keys 5 x 4 B; rows read: 5 and 7 (9 absent, 5 repeated) x 16 B;
    # written: 5 rows of 16 B and 5 flags of 1 B
    assert lb.lookup_bytes(keys, present, 16) == 20 + 32 + 85


def test_lookup_bytes_of_a_batch_with_nothing_present():
    keys = torch.tensor([1, 2], dtype=torch.int32)
    assert lb.lookup_bytes(keys, torch.zeros(2, dtype=torch.bool), 1024) == (
        8 + 2 * 1025)


def test_merge_bytes_count_every_write_and_each_distinct_index_entry():
    keys = torch.tensor([1, 2, 1, 3, 1], dtype=torch.int32)
    # each write: key 4 + row read 16 + heap row 16 + log entry 8 + ok 1
    # = 45 B, 5 writes; index entries: keys 1, 2, 3 x 8 B
    assert lb.merge_bytes(keys, 16) == 5 * 45 + 3 * 8


def test_merge_bytes_of_the_load_batch_size():
    keys = torch.randperm(1 << 10).to(torch.int32)
    assert lb.merge_bytes(keys, 1024) == (1 << 10) * (4 + 2048 + 8 + 1 + 8)


def _run(calls, nbytes):
    run = Run(device=torch.device("cpu"), cfg={}, traffic={})
    run.trace = Trace(window_s=1.0, busy_s=0.5, launches=3, calls=calls,
                      device_ops=[], idle_gaps=[])
    run.traced_bytes = nbytes
    return run


def test_roofline_share_is_least_time_over_device_time():
    calls = [Call("read", 1e-3), Call("read", 3e-3), Call("write", 1.0)]
    run = _run(calls, {"read": [3.35e9, 3.35e9]})
    # 6.7e9 B at 3.35e12 B/s is 2 ms of the 4 ms the calls took
    assert abs(lb.roofline_share(run, "read") - 50.0) < 1e-9
    assert lb.roofline_share(run, "write") is None


def test_roofline_share_reads_nothing_without_a_trace_or_a_match():
    run = _run([Call("read", 1e-3)], {"read": [1, 2]})
    assert lb.roofline_share(run, "read") is None
    run.trace = None
    assert lb.roofline_share(run, "read") is None
