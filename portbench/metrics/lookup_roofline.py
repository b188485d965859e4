"""lookup_roofline: each traced ``kvs_lookup`` call's least bytes
(``least_bytes.lookup_bytes``: the keys, each distinct present key's row,
the rows and found flags written) at 3.35 TB/s, over the device time of
every operation the calls launched (the profiler's trace)."""

from portbench.least_bytes import roofline_share


def read(run):
    return roofline_share(run, "read")
