"""read_call_ms: the mean of the benchmark's host-clock spans around each
``kvs_lookup`` call in the window, each ended by a synchronize."""


def read(run):
    spans = run.calls.get("read")
    return sum(spans) / len(spans) * 1e3 if spans else None
