"""Meshes: the port's copy of the reference's ``launch/mesh.py``.

A ``Mesh`` names its axes and their sizes (``shape``, a dict like JAX's
``mesh.shape``). It comes in three forms:

  * with no devices: the production meshes (16 x 16, and 2 x 16 x 16 over
    two pods) and the 2 x 4 smoke mesh, which serve the partition rules
    (``distributed/sharding.py``) and the dry run;
  * with the devices one process drives: the (1, 1) host mesh over one
    device (``launch/train.py:make_host_mesh``);
  * a mesh of ranks (``make_mesh``): one process a position, joined by
    ``torch.distributed``. Each rank holds its coordinates, one process
    group for each tuple of axes of more than one position, and its own
    device; ``distributed/collectives.py`` runs over those groups.

``Mesh.device`` is where state goes: the mesh's one device, or this
rank's. A mesh with no devices, or of several devices that one process
would drive, raises there.
"""

from __future__ import annotations

import itertools
import math
from dataclasses import dataclass
from datetime import timedelta

import torch
import torch.distributed as dist

from ..device import resolve_device

# the backend that carries collectives between tensors on each device type
BACKENDS = {"cuda": "nccl", "cpu": "gloo"}


@dataclass(frozen=True, eq=False)
class RankPlace:
    """This process's place in a mesh of ranks: its coordinates (one an
    axis), its device, and the process group of each tuple of axes of
    more than one position (keyed by those axes, in mesh order)."""
    coords: tuple
    device: torch.device
    groups: dict


@dataclass(frozen=True)
class Mesh:
    axis_names: tuple
    sizes: tuple
    devices: tuple | None = None     # one per position, row-major
    place: RankPlace | None = None   # a mesh of ranks: this rank's

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
        """This rank's device in a mesh of ranks, else the mesh's one
        device; raises for a mesh of more positions that one process
        drives, or of none (the production and smoke meshes)."""
        if self.place is not None:
            return self.place.device
        if self.devices is None or self.size != 1:
            raise ValueError(
                f"a {'x'.join(map(str, self.sizes))} mesh"
                f"{'' if self.devices else ' with no devices'} cannot place "
                "state on this process's one device")
        return self.devices[0]

    def size_of(self, axes) -> int:
        """The number of positions along ``axes`` (a name or a tuple)."""
        return math.prod(self.shape[a] for a in _axes(axes))

    def coord(self, axis: str) -> int:
        """This rank's coordinate along ``axis``."""
        return self._place().coords[self.axis_names.index(axis)]

    def index(self, axes) -> int:
        """This rank's row-major position along ``axes``: the block of a
        dim sharded over them that it holds."""
        out = 0
        for a in _axes(axes):
            out = out * self.shape[a] + self.coord(a)
        return out

    def group(self, axes):
        """The process group of the ranks that differ from this one only
        along ``axes``, in row-major order; None where those axes hold one
        position. ``axes`` must be in mesh order."""
        axes = _axes(axes)
        order = [self.axis_names.index(a) for a in axes]
        if order != sorted(order) or len(set(order)) != len(order):
            raise ValueError(f"axes {axes} are not in the mesh's order "
                             f"{self.axis_names}")
        wide = tuple(a for a in axes if self.shape[a] > 1)
        return self._place().groups[wide] if wide else None

    def _place(self) -> RankPlace:
        if self.place is None:
            raise ValueError(f"a {'x'.join(map(str, self.sizes))} mesh with "
                             "no ranks has no rank's coordinates or groups")
        return self.place


def _axes(axes) -> tuple:
    return (axes,) if isinstance(axes, str) else tuple(axes)


def init_ranks(world_size: int, rank: int, init_method: str, *, device=None,
               timeout: float = 300.0) -> torch.device:
    """Join a world of ``world_size`` ranks as ``rank`` through
    ``init_method`` (a ``file://`` or ``tcp://`` address) with the backend
    of ``device``'s type: NCCL for the card (the default), gloo for
    ``"cpu"``. A collective that waits longer than ``timeout`` seconds
    raises. Returns this rank's device (``rank_device``)."""
    dev = rank_device(device, rank)
    dist.init_process_group(_backend(dev), init_method=init_method,
                            world_size=world_size, rank=rank,
                            timeout=timedelta(seconds=timeout))
    return dev


def rank_device(device=None, rank: int | None = None) -> torch.device:
    """The device of this rank: ``device`` where it names one (``"cpu"``,
    or a card by index, as a launcher over several hosts gives each rank
    its local one), else the card of the rank's index, ``cuda:rank`` (the
    initialised world's rank when ``rank`` is None): one host, one card a
    rank. The card is made this process's current device."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", dist.get_rank() if rank is None else rank)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    return dev


def _backend(dev: torch.device) -> str:
    if dev.type not in BACKENDS:
        raise ValueError(f"no collective backend for {dev.type} tensors")
    return BACKENDS[dev.type]


def make_mesh(shape, axes, *, device=None) -> Mesh:
    """The mesh of ranks ``shape`` over ``axes`` on the initialised world,
    whose size must be ``prod(shape)``: rank r holds the coordinates of
    position r in row-major order (as ``jax.make_mesh`` orders devices)
    and ``device`` (``rank_device``: the card unless ``"cpu"``), which
    must be the backend's (NCCL for the card, gloo for the CPU). Every rank
    must call it, with the same arguments: it creates the process group
    of each tuple of axes of more than one position."""
    shape, axes = tuple(int(s) for s in shape), tuple(axes)
    if len(shape) != len(axes):
        raise ValueError(f"shape {shape} and axes {axes} differ in length")
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs torch.distributed initialised "
                           "(launch.mesh.init_ranks)")
    n = math.prod(shape)
    if dist.get_world_size() != n:
        raise ValueError(f"a {shape} mesh needs {n} ranks; the world has "
                         f"{dist.get_world_size()}")
    dev = rank_device(device)
    if dist.get_backend() != _backend(dev):
        raise ValueError(f"the world's backend is {dist.get_backend()}; "
                         f"{dev.type} tensors need {_backend(dev)}")
    rank = dist.get_rank()
    coords, r = [], rank
    for size in reversed(shape):
        coords.append(r % size)
        r //= size
    coords = tuple(reversed(coords))
    strides = [math.prod(shape[i + 1:]) for i in range(len(shape))]
    wide = [i for i, s in enumerate(shape) if s > 1]
    groups = {}
    # every rank creates every group, in the same order
    for k in range(1, len(wide) + 1):
        for sub in itertools.combinations(wide, k):
            rest = [i for i in range(len(shape)) if i not in sub]
            for fixed in itertools.product(*(range(shape[i]) for i in rest)):
                base = sum(c * strides[i] for c, i in zip(fixed, rest))
                ranks = sorted(
                    base + sum(c * strides[i] for c, i in zip(pos, sub))
                    for pos in itertools.product(*(range(shape[i])
                                                   for i in sub)))
                g = dist.new_group(ranks)
                if rank in ranks:
                    groups[tuple(axes[i] for i in sub)] = g
    return Mesh(axes, shape, place=RankPlace(coords, dev, groups))


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
# (no collective time across cards has been measured)
PEAK_FLOPS_BF16 = 989e12          # FLOP/s
HBM_BW = 3.35e12                  # B/s
