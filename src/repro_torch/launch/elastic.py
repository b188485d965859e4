"""Elastic restore: DINOMO's lightweight reconfiguration applied to
training state, on one card. The port's copy of the reference's
``launch/elastic.py``.

A checkpoint restores wherever the job now runs by *re-owning* its
bytes -- the bytes on disk never move, exactly like OP's ownership
handoff. ``resize`` performs the paper's protocol steps for the training
analogue:

  1. participants = every worker (synchronous step boundary)
  2. quiesce (finish in-flight step)
  3. merge pending state = flush async checkpoint futures
  4. new mapping = the device that loads the leaves
  5. resume -- restore + re-own, no data reorganization

On one card step 4 is the device alone. The reference maps each leaf to
a new mesh's shardings there (``distributed/sharding.py``); the mesh
rules come to the port with its launch and distributed modules (ROADMAP
Queue 2 item 8).
"""

from __future__ import annotations

from ..checkpoint.ckpt import CheckpointStore
from ..device import resolve_device


def resize(store: CheckpointStore, template, *, device=None,
           step: int | None = None):
    """Restore ``template``-shaped state onto ``device`` (the card unless
    ``"cpu"``). Returns (state, extra, step). The restore cost is
    O(bytes read), with zero re-layout on disk."""
    dev = resolve_device(device)
    store.wait()                          # step 3: merge pending logs
    return store.restore(template, step=step, device=dev)


def straggler_scales(throughputs: dict[str, float],
                     slow_factor: float = 0.7) -> dict[str, float]:
    """Straggler mitigation policy (M-node style): workers whose
    measured step rate falls below ``slow_factor`` x median get their
    load share scaled down (the data pipeline serves them smaller
    shards; ownership of the difference moves to healthy workers)."""
    if not throughputs:
        return {}
    med = sorted(throughputs.values())[len(throughputs) // 2]
    scales = {}
    for w, t in throughputs.items():
        scales[w] = min(1.0, max(t / max(med, 1e-9), 0.25)) \
            if t < slow_factor * med else 1.0
    tot = sum(scales.values())
    return {w: s * len(scales) / tot for w, s in scales.items()}
