"""Carry state across planes as plain numpy arrays.

``from_jax_arrays`` builds the port's CLHT / LogSegment / ValueHeap from
the fields of the reference's dataclasses given as numpy arrays (take
them with ``np.array(x)``, a writable copy), and ``to_numpy`` gives the
same fields back, so two planes can start from one state and be compared
field by field. ``params_from_jax`` carries a model's weights across.
This module imports no JAX.
"""

from __future__ import annotations

import numpy as np
import torch

from .core.clht import CLHT
from .core.log import LogSegment, ValueHeap
from .device import resolve_device
from .kernels.clht_probe.clht_probe import pack_table


def _t(a, dev) -> torch.Tensor:
    """An int32 copy of ``a`` on ``dev`` (never a view of the caller's
    array: the port updates its state in place)."""
    return torch.tensor(np.asarray(a, dtype=np.int32), device=dev)


def from_jax_arrays(*, table: dict | None = None, seg: dict | None = None,
                    heap: dict | None = None, device=None):
    """Build (table, seg, heap) on ``device`` from dicts of the reference's
    field names to numpy arrays (``num_buckets`` may be an int); an
    argument left out gives None in its place."""
    dev = resolve_device(device)
    out_table = out_seg = out_heap = None
    if table is not None:
        out_table = CLHT(
            lines=pack_table(_t(table["keys"], dev), _t(table["ptrs"], dev),
                             _t(table["nxt"], dev)),
            overflow_head=_t(table["overflow_head"], dev).reshape(()),
            num_buckets=int(table["num_buckets"]))
    if seg is not None:
        out_seg = LogSegment(keys=_t(seg["keys"], dev),
                             ptrs=_t(seg["ptrs"], dev),
                             seal=_t(seg["seal"], dev),
                             count=int(seg["count"]),
                             merged=int(seg["merged"]))
    if heap is not None:
        out_heap = ValueHeap(data=_t(heap["data"], dev),
                             head=int(heap["head"]))
    return out_table, out_seg, out_heap


def to_numpy(obj) -> dict:
    """The reference's fields of a port CLHT / LogSegment / ValueHeap as
    numpy arrays (int32; the host registers as 0-d arrays)."""
    np32 = lambda t: t.detach().cpu().numpy().astype(np.int32)
    if isinstance(obj, CLHT):
        return {"keys": np32(obj.keys), "ptrs": np32(obj.ptrs),
                "nxt": np32(obj.nxt),
                "overflow_head": np32(obj.overflow_head),
                "num_buckets": np.array(obj.num_buckets)}
    if isinstance(obj, LogSegment):
        return {"keys": np32(obj.keys), "ptrs": np32(obj.ptrs),
                "seal": np32(obj.seal), "count": np.int32(obj.count),
                "merged": np.int32(obj.merged)}
    if isinstance(obj, ValueHeap):
        return {"data": np32(obj.data), "head": np.int32(obj.head)}
    raise TypeError(f"not a DPM structure: {type(obj).__name__}")


def _bf16(a, dev) -> torch.Tensor:
    """A bf16 copy of ``a`` on ``dev``: float32 values are rounded (bf16
    values carried as float32 come back exactly), uint16 arrays are taken
    as the raw bits of bf16 values, bf16 tensors kept."""
    if isinstance(a, torch.Tensor):
        if a.dtype not in (torch.bfloat16, torch.float32):
            raise TypeError(f"expected a bf16 or float32 tensor, got "
                            f"{a.dtype}")
        return a.to(device=dev, dtype=torch.bfloat16, copy=True)
    a = np.asarray(a)
    if a.dtype == np.uint16:
        t = torch.from_numpy(np.ascontiguousarray(a).view(np.int16)
                             .copy()).view(torch.bfloat16)
    elif a.dtype == np.float32:
        t = torch.from_numpy(np.array(a)).to(torch.bfloat16)
    else:
        raise TypeError(f"expected float32 or uint16 arrays, got {a.dtype} "
                        "(pass np.asarray(x, np.float32) for a bf16 array)")
    return t.to(dev)


# the reference's float32 parameters (models/mamba2.py:mamba_init, the MoE
# router of models/moe.py:moe_init); every other parameter is bf16
F32_LEAVES = frozenset({"a_log", "dt_bias", "d_skip", "router"})


def _f32(a, dev) -> torch.Tensor:
    if isinstance(a, torch.Tensor):
        if a.dtype != torch.float32:
            raise TypeError(f"expected a float32 tensor for a float32 "
                            f"parameter, got {a.dtype}")
        return a.to(dev, copy=True)
    a = np.asarray(a)
    if a.dtype != np.float32:
        raise TypeError(f"expected a float32 array for a float32 parameter, "
                        f"got {a.dtype}")
    return torch.from_numpy(np.array(a)).to(dev)


# the reference's stacked layer lists, by key, and the config field that
# gives each one's depth
STACKS = {"layers": "num_layers", "enc_layers": "encoder_layers",
          "dec_layers": "num_layers"}


def reference_ndim(path: tuple, t: torch.Tensor) -> int:
    """The rank of the leaf ``t`` at ``path`` (the keys from the root, list
    indices included) in the reference's tree: one more than ``t``'s
    inside a layer list of ``STACKS``, which the reference stacks on a
    leading axis. So a layer's norm (d,) counts as (L, d), while ``ln_f``
    and zamba2's unstacked ``shared`` block keep their own rank. The
    reference's AdamW decays the leaves of rank 2 or more
    (src/repro/optim/adamw.py:72)."""
    stacked = len(path) > 1 and path[0] in STACKS and isinstance(path[1], int)
    return t.dim() + int(stacked)


def _array(a):
    """A tensor as it is, anything else as a numpy array."""
    return a if isinstance(a, torch.Tensor) else np.asarray(a)


def _carry(tree: dict, cfg, leaf) -> dict:
    """The port's layout of the reference's tree ``tree`` (nested dicts of
    numpy arrays or tensors): ``leaf(array, name)`` of each leaf, where
    ``name`` is its key; each list of ``STACKS`` unstacked into one dict
    per layer, as deep as cfg says."""
    def walk(node, pick, name=None):
        if isinstance(node, dict):
            return {k: walk(v, pick, k) for k, v in node.items()}
        return leaf(pick(_array(node)), name)

    stacks = [k for k in STACKS if k in tree]
    if not stacks:
        raise ValueError(f"no stacked layers among {sorted(tree)}; "
                         f"expected one of {sorted(STACKS)}")
    out = {k: walk(v, lambda a: a, k) for k, v in tree.items()
           if k not in STACKS}
    for key in stacks:
        n = getattr(cfg, STACKS[key])
        depth = {_array(a).shape[0] for a in _leaves(tree[key])}
        if depth != {n}:
            raise ValueError(f"{key} stacked {sorted(depth)} deep, config "
                             f"has {STACKS[key]} = {n}")
        out[key] = [walk(tree[key], lambda a, i=i: a[i]) for i in range(n)]
    return out


def params_from_jax(params: dict, cfg, device=None) -> dict:
    """The port's parameters on ``device`` from the reference's parameter
    tree as nested dicts of numpy arrays: ``models/transformer.py``
    (dense, MoE and VLM), ``models/ssm_lm.py``, ``models/zamba2.py`` or
    ``models/encdec.py``'s ``init_params``. An MoE layer's ``moe`` dict
    comes across whole: ``router`` (d, E) f32, ``wi`` and ``wg`` (E, d,
    ff) and ``wo`` (E, ff, d) bf16. zamba2's ``shared`` block is one
    unstacked dict and comes across once, one set of tensors for every
    site.

    The leaves may also be tensors (a restored checkpoint's: bf16 kept,
    float32 exactly), which are copied to ``device``.

    Both layouts keep weights (d_in, d_out) for ``x @ w``. The reference
    stacks the layers of each list in ``STACKS`` on a leading axis, as
    deep as its config field says (``enc_layers`` ``encoder_layers``, the
    others ``num_layers``); the port keeps each as a list of one dict per
    layer. Each tensor keeps the reference's type, by the leaf's name:
    the leaves named in ``F32_LEAVES`` are float32 in the reference and
    come as float32 arrays, kept exactly; every other leaf is bf16, given
    as float32 (rounded to bf16) or as the uint16 bits of bf16."""
    dev = resolve_device(device)
    return _carry(params, cfg, lambda a, name: _f32(a, dev)
                  if name in F32_LEAVES else _bf16(a, dev))


def opt_state_from_jax(state: dict, cfg, device=None) -> dict:
    """The port's AdamW state (``optim.init_state``'s layout) on ``device``
    from the reference's (``repro.optim.init_state`` and on), as numpy:
    ``mu`` and ``nu``, trees shaped like the reference's parameters with
    float32 leaves, kept exactly and unstacked as ``params_from_jax``
    unstacks; ``step``, an int32 0-d tensor."""
    dev = resolve_device(device)
    return {"mu": _carry(state["mu"], cfg, lambda a, _: _f32(a, dev)),
            "nu": _carry(state["nu"], cfg, lambda a, _: _f32(a, dev)),
            "step": torch.tensor(int(state["step"]), dtype=torch.int32,
                                 device=dev)}


def _stacked(params: dict, cfg, leaf, stack) -> dict:
    """``params`` (or a tree shaped like it) in the reference's layout:
    ``leaf`` of each tensor, each list of ``STACKS`` stacked by ``stack``
    on a leading axis."""
    for key in STACKS:
        if key in params and len(params[key]) != getattr(cfg, STACKS[key]):
            raise ValueError(f"{key} holds {len(params[key])} layers, config "
                             f"has {STACKS[key]} = "
                             f"{getattr(cfg, STACKS[key])}")

    def stacked(layers):
        if isinstance(layers[0], dict):
            return {k: stacked([lp[k] for lp in layers]) for k in layers[0]}
        return stack(layers)

    def walk(node):
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        if isinstance(node, list):
            return stacked([walk(v) for v in node])
        return leaf(node)

    return walk(params)


def params_to_numpy(params: dict, cfg) -> dict:
    """The reference's parameter tree (``params_from_jax``'s input) from
    the port's parameters, or from any tree shaped like them (gradients,
    AdamW moments): nested dicts of float32 numpy arrays (bf16 values are
    exact in float32), each list of ``STACKS`` stacked on a leading axis
    again."""
    return _stacked(params, cfg, lambda t: t.detach().float().cpu().numpy(),
                    np.stack)


def _checkpoint(params: dict, opt_state: dict, cfg, leaf) -> tuple:
    def stack(tree):
        return _stacked(tree, cfg, leaf, torch.stack)

    return (stack(params), {"mu": stack(opt_state["mu"]),
                            "nu": stack(opt_state["nu"]),
                            "step": leaf(opt_state["step"])})


def checkpoint_tree(params: dict, opt_state: dict, cfg) -> tuple:
    """The training state as the reference's train loop checkpoints it:
    the tuple (params, opt_state) in the reference's layout, each list of
    ``STACKS`` stacked on a leading axis (a copy on the tensors' device;
    the other leaves are the state's own tensors) and every leaf of its
    own type: the bf16 parameters as bf16 (saved as their bits), the
    float32 ones and the AdamW moments exactly, ``step`` an int32 0-d
    tensor. ``CheckpointStore.save`` of it writes what the reference
    writes for the same values; ``from_checkpoint`` takes it back."""
    return _checkpoint(params, opt_state, cfg, lambda t: t.detach())


def checkpoint_template(params: dict, opt_state: dict, cfg) -> tuple:
    """``checkpoint_tree``'s structure, shapes and types with meta tensors
    for leaves (no data moves): the template ``CheckpointStore.restore``
    takes."""
    return _checkpoint(params, opt_state, cfg, lambda t: t.to("meta"))


def from_checkpoint(tree: tuple, cfg, device=None,
                    dtype=None) -> tuple[dict, dict]:
    """(params, opt_state) on ``device`` from ``checkpoint_tree``'s layout
    (a restored checkpoint, the reference's or the port's), every tensor a
    copy: ``params_from_jax`` and ``opt_state_from_jax`` of its two
    halves. With ``dtype`` torch.float32 every parameter is float32, kept
    exactly (a checkpoint of f32 parameters, ``launch/train.py``'s
    ``dtype``)."""
    params, opt_state = tree
    if dtype is None:
        params = params_from_jax(params, cfg, device)
    elif dtype == torch.float32:
        dev = resolve_device(device)
        params = _carry(params, cfg, lambda a, _: _f32(a, dev))
    else:
        raise ValueError(f"parameters of {dtype}: the model's types or "
                         "torch.float32")
    return params, opt_state_from_jax(opt_state, cfg, device)


def _leaves(node):
    if isinstance(node, dict):
        for v in node.values():
            yield from _leaves(v)
    else:
        yield node
