"""The trace reader on hand-made events: the union of device intervals,
each call's device time, the launches and the idle gaps by what the host
was doing."""

from portbench.trace import (SPAN, WINDOW, Event, covered_ns, host_activity,
                             summarize, union)


def test_union_merges_overlapping_and_touching_intervals():
    assert union([(5, 7), (0, 2), (1, 3), (3, 4)]) == [(0, 4), (5, 7)]
    assert covered_ns([(0, 10), (2, 4), (20, 25)]) == 15


def test_summarize_counts_overlaps_once_and_splits_calls():
    host = [Event(WINDOW, 0, 1000),
            Event(SPAN + "read", 0, 450), Event(SPAN + "read", 500, 1000),
            Event("aten::nonzero", 240, 440),
            Event("cudaStreamSynchronize", 245, 430)]
    device = [Event("kernel_b", 10, 210), Event("memcpy", 100, 250),
              Event("walk", 600, 700), Event("outside", 2000, 2100)]
    t = summarize(device, host)
    assert t.window_s == 1000 / 1e9
    assert t.busy_s == (240 + 100) / 1e9
    assert t.launches == 3
    reads = t.calls_of("read")
    assert sorted(c.device_s for c in reads) == [100 / 1e9, 240 / 1e9]
    assert t.device_ops[0] == ["kernel_b", 200 / 1e9]
    gaps = dict(t.idle_gaps)
    # gaps: [0, 10), [250, 600), [700, 1000)
    assert gaps == {
        "portbench.read": 10 / 1e9 + 300 / 1e9,
        "portbench.read > aten::nonzero > cudaStreamSynchronize": 350 / 1e9}


def test_host_activity_names_the_innermost_events():
    host = [Event(SPAN + "write", 0, 100), Event("aten::sort", 10, 50),
            Event("aten::copy_", 20, 30), Event("cudaLaunchKernel", 22, 24)]
    assert host_activity(host, [5, 23, 40, 99, 150]) == [
        "portbench.write", "portbench.write > aten::copy_ > cudaLaunchKernel",
        "portbench.write > aten::sort", "portbench.write",
        "host: outside any call"]


def test_summarize_finds_nothing_without_device_operations():
    assert summarize([], [Event(WINDOW, 0, 10)]) is None
    assert summarize([Event("k", 0, 5)], []) is None
