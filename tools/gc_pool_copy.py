#!/usr/bin/env python3
"""Run chip_smoke.py's ``cluster`` phase alone, with one more copy of
the loaded pool kept alive through it (``--copy live``: a
``copy.deepcopy`` of the pool as loaded, the object graph a baseline
would take) or not (``--copy pickled``: the phase as chip_smoke.py runs
it, its copy kept as pickled bytes). What the live copy costs the
phase's timed batches is the garbage collector's: its full passes walk
every object alive.

    python3 tools/gc_pool_copy.py --copy live|pickled

One mode a process (the collector's state depends on all the process
made before it); run the modes in turns on one card. Prints the phase's
JSON lines as chip_smoke.py does: each leg's ``cluster_mix`` line holds
its ops/s, ``gc_s`` and ``gc_collections`` (passes by generation)
inside its batches.
"""

from __future__ import annotations

import argparse
import copy
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke  # noqa: E402


class LiveCopy(chip_smoke.Smoke):
    """The phase with a live copy of its first cluster's pool, as
    loaded, kept until the process ends."""

    def _cluster_at(self, n, reference_cache, variant=chip_smoke.DINOMO,
                    pool=None):
        c = super()._cluster_at(n, reference_cache, variant, pool)
        if not hasattr(self, "live_pool"):
            self.live_pool = copy.deepcopy(c.pool)
        return c


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--copy", choices=("live", "pickled"), required=True)
    args = ap.parse_args()
    if not chip_smoke.torch.cuda.is_available():
        print("gc_pool_copy: no CUDA device", file=sys.stderr)
        return 2
    smoke = LiveCopy() if args.copy == "live" else chip_smoke.Smoke()
    smoke.environment()
    smoke.build_kernels()
    chip_smoke.emit({"copy": args.copy})
    smoke.cluster()
    return 0


if __name__ == "__main__":
    sys.exit(main())
