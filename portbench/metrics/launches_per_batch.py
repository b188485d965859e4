"""launches_per_batch: device operations (kernels, copies, memsets) in the
traced slice over the batches issued there; in a load, the pool's
creation is shared out over its batches."""


def read(run):
    t = run.trace
    if t is None:
        return None
    batches = len(t.calls_of("read")) + len(t.calls_of("write"))
    return t.launches / batches if batches else None
