"""Meshes: the port's copy of the reference's ``launch/mesh.py``.

A ``Mesh`` names its axes and their sizes (``shape``, a dict like JAX's
``mesh.shape``) and, when it maps onto real devices, holds them. The
production meshes (16 x 16, and 2 x 16 x 16 over two pods) and the 2 x 4
smoke mesh hold none: the port runs on one card, so they serve the
partition rules (``distributed/sharding.py``) and the dry run only.
State is placed on a mesh's device only where the mesh has one device
(``Mesh.device``); a larger mesh raises there.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch


@dataclass(frozen=True)
class Mesh:
    axis_names: tuple
    sizes: tuple
    devices: tuple | None = None     # one per position, row-major

    def __post_init__(self):
        if len(self.axis_names) != len(self.sizes):
            raise ValueError(f"axes {self.axis_names} and sizes "
                             f"{self.sizes} differ in length")
        if self.devices is not None and len(self.devices) != self.size:
            raise ValueError(f"a mesh of {self.size} positions takes as "
                             f"many devices, not {len(self.devices)}")

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.sizes))

    @property
    def size(self) -> int:
        return math.prod(self.sizes)

    @property
    def device(self) -> torch.device:
        """The mesh's one device; raises for a mesh of more positions or of
        none (the production and smoke meshes)."""
        if self.devices is None or self.size != 1:
            raise ValueError(
                f"a {'x'.join(map(str, self.sizes))} mesh"
                f"{'' if self.devices else ' with no devices'} cannot place "
                "state on this process's one device")
        return self.devices[0]


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """16x16 = 256 chips per pod; 2 pods = 512 chips multi-pod."""
    if multi_pod:
        return Mesh(("pod", "data", "model"), (2, 16, 16))
    return Mesh(("data", "model"), (16, 16))


def make_smoke_mesh(shape=(2, 4), axes=("data", "model")) -> Mesh:
    """The reference's small mesh for multi-device tests, with no
    devices."""
    return Mesh(tuple(axes), tuple(shape))


# NVIDIA H100 SXM (data sheet, dense bf16 without sparsity, at the 700 W
# power limit) for the roofline, per card; no interconnect rate is given
# (one card)
PEAK_FLOPS_BF16 = 989e12          # FLOP/s
HBM_BW = 3.35e12                  # B/s
