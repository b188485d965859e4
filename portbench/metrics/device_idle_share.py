"""device_idle_share: the share of the traced slice's wall time in which
no operation ran on the device (one less the union of the device
intervals over the slice, from the profiler's trace)."""


def read(run):
    t = run.trace
    if t is None or t.window_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
