"""Public SSD op: the ssd_scan kernel on the card, its plain chunked
version on the CPU, chosen by where the tensors lie (there is no
switch)."""

from __future__ import annotations

from .ssd_scan import ssd_scan


def ssd(x, dt, a, b, c, d, *, chunk: int = 64):
    """x: (B, S, H, P); dt: (B, S, H); a: (H,); b, c: (B, S, G, N);
    d: (H,). The chunk is cut to S, as in the reference; S must then be
    a multiple of it (the reference fails there with an assert or a
    reshape; ``ssd_scan`` raises ValueError)."""
    return ssd_scan(x, dt, a, b, c, d, chunk=min(chunk, x.shape[1]))
