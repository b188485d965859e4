"""Elastic restore: DINOMO's lightweight reconfiguration applied to
training state. The port's copy of the reference's
``launch/elastic.py``.

A checkpoint restores wherever the job now runs by *re-owning* its
bytes -- the bytes on disk never move, exactly like OP's ownership
handoff. ``resize`` performs the paper's protocol steps for the training
analogue:

  1. participants = every worker (synchronous step boundary)
  2. quiesce (finish in-flight step)
  3. merge pending state = flush async checkpoint futures
  4. new mapping = shardings for the new mesh
  5. resume -- restore + re-own, no data reorganization

Step 4 maps each leaf to the new mesh's partition rules
(``distributed/sharding.py``), as the reference's. On a mesh of ranks of
any size (``launch/mesh.py:make_mesh``) every rank reads each leaf and
keeps its block by those rules, whatever mesh saved it; on a mesh of one
device (``launch/train.py:make_host_mesh``) every leaf's shard is the
whole leaf; with no mesh the state goes to the device asked for. A mesh
with no devices or ranks raises.
"""

from __future__ import annotations

from ..checkpoint.ckpt import CheckpointStore
from ..device import resolve_device
from ..distributed.sharding import make_rules, param_shardings, tree_leaves
from .mesh import Mesh


def resize(store: CheckpointStore, template, new_mesh: Mesh | None = None,
           *, mode: str = "train", device=None, step: int | None = None):
    """Restore ``template``-shaped state onto ``new_mesh``: each rank's
    blocks of it on a mesh of ranks (every rank calls), the whole on a
    mesh's one device; or with no mesh onto ``device`` (the card unless
    ``"cpu"``). Returns (state, extra, step). The restore cost is O(bytes
    read), with zero re-layout on disk."""
    if new_mesh is None:
        dev = resolve_device(device)
    else:
        dev = new_mesh.device             # raises with no device or rank
        if device is not None and resolve_device(device) != dev:
            raise ValueError(f"device {device} is not the mesh's {dev}")
    store.wait()                          # step 3: merge pending logs
    if new_mesh is None:
        return store.restore(template, step=step, device=dev)
    shardings = param_shardings(template, make_rules(new_mesh), mode)
    if new_mesh.place is not None:        # step 4: new mapping
        return store.restore(template, step=step, shardings=shardings)
    for leaf, sh in zip(tree_leaves(template), tree_leaves(shardings),
                        strict=True):
        if sh.shard_shape(leaf.shape) != tuple(leaf.shape):
            raise ValueError(f"{sh.spec} splits a leaf of "
                             f"{tuple(leaf.shape)} on one device")
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
