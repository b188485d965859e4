"""Pass registry. Each pass module exposes ``NAME`` and
``run(corpus) -> list[Finding]``; the six names are the reference's."""

from __future__ import annotations

from . import (crash_points, deprecations, determinism, fence_coverage,
               kernel_hygiene, plan_purity)

ALL_PASSES = (plan_purity, crash_points, fence_coverage, determinism,
              kernel_hygiene, deprecations)

BY_NAME = {m.NAME: m for m in ALL_PASSES}

__all__ = ["ALL_PASSES", "BY_NAME"]
