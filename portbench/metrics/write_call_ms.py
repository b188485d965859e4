"""write_call_ms: the mean of the benchmark's host-clock spans around each
``log_append_merge`` call in the window, each ended by a synchronize."""


def read(run):
    spans = run.calls.get("write")
    return sum(spans) / len(spans) * 1e3 if spans else None
