"""p99_batch_ms: the 99th percentile of every batch's latency in the
window, from CUDA events recorded on the stream at the batch's issue and
after its outputs exist (numpy's linear interpolation between ranks)."""

import numpy as np


def read(run):
    return float(np.percentile(run.batch_ms, 99)) if run.batch_ms else None
