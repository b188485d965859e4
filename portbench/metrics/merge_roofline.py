"""merge_roofline: each traced ``log_append_merge`` call's least bytes
(``least_bytes.merge_bytes``: keys and rows read, heap rows, log entries
and index entries written, ok flags) at 3.35 TB/s, over the device time
of every operation the calls launched (the profiler's trace)."""

from portbench.least_bytes import roofline_share


def read(run):
    return roofline_share(run, "write")
