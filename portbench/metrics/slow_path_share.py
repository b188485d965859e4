"""slow_path_share: the entries that the merge handed to its slow path
(kernel D, ``_build.work["clht_insert"]``) over the window, as a share of
the keys inserted there. The kernels count on the card only."""


def read(run):
    keys = run.counters.get("keys_inserted")
    if run.device.type != "cuda" or not keys:
        return None
    return 100.0 * run.counters["slow_path_entries"] / keys
