"""ops_per_s: every operation completed in the window over the window's
seconds, on the host clock (the window is at least a second long)."""


def read(run):
    return run.ops / run.window_s if run.window_s > 0 and run.ops else None
