"""Device resolution for the port's entry points, and device dispatch for
its kernel wrappers.

Entry points that create state run on the card unless the caller asks
for the CPU; with no card they raise. They also take ``"meta"`` when
asked for it: tensors with shapes and types and no data, on which the
dry run (``launch/dryrun.py``) runs whole steps. A kernel wrapper runs
the plain torch version only for tensors that lie on the CPU or on meta
(where it computes shapes only), and the hand-written kernel for CUDA
tensors: there is no switch and no fallback between them.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` -> ``cuda`` (raises without a card); anything else is taken
    as given, and ``"cpu"`` or ``"meta"`` only when asked for."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "to run the plain torch versions on the CPU")
    if dev.type not in ("cuda", "cpu", "meta"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def on_cuda(*tensors: torch.Tensor) -> bool:
    """True if every tensor lies on a CUDA device, False if every one lies
    on the CPU or every one on meta; raises on a mix or on another device
    type."""
    types = {t.device.type for t in tensors}
    if types == {"cuda"}:
        return True
    if types in ({"cpu"}, {"meta"}):
        return False
    raise ValueError(f"tensors on mixed or unsupported devices: {types}")
