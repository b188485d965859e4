"""Divisibility-aware sharding rules for the production mesh: the port's
copy of the reference's ``distributed/sharding.py``.

GSPMD rejects uneven shardings, and the assigned archs are full of
non-multiples of 16 (llama3.2's 24 heads, mamba2's 80 ssm heads, ragged
vocab sizes), so specs are *computed*, not hand-written: for each param
the largest dim divisible by the axis (group) is sharded, preferring
trailing dims (feature dims -> TP-style math), with FSDP over the
combined (pod, data, model) axes for training and TP-only ('model') for
serving. Batch dims shard over (pod, data); KV caches shard batch over
data and sequence over model -- sequence-sharded KV is the dense-cache
analogue of DINOMO page ownership.

A spec is a tuple of the reference's ``PartitionSpec`` entries: None, an
axis name, or a tuple of two or more names in mesh order (a tuple of one
is its name, as JAX's ``PartitionSpec`` holds it); ``NamedSharding`` pairs
it with a mesh (``launch/mesh.py``). On a mesh with no ranks the rules give
the dry run its per-device sizes; on a mesh of ranks they place real
shards: ``NamedSharding.local`` cuts a rank's block out of a whole leaf,
``gather`` rebuilds the whole from the blocks, ``reduce`` sums the ranks'
shares of a whole leaf's gradient into the rank's block, and ``place`` /
``gather_tree`` do the first two over a tree (the port's
``jax.device_put(tree, shardings)`` and its inverse).

The port keeps a model's layers as a list of one tree per layer where
the reference stacks them on a leading, scan-indexed axis. A leaf of
such a list gets the reference's spec of its stacked leaf (the list's
length prepended to its shape, one scan dim) without that leading entry,
which is never sharded; a tree in the reference's stacked layout
(``state.checkpoint_tree``) gets the reference's specs as they are.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from ..launch.mesh import Mesh
from . import collectives


@dataclass(frozen=True)
class NamedSharding:
    mesh: Mesh
    spec: tuple

    def shard_shape(self, shape) -> tuple:
        """The shape of one device's shard of a ``shape`` leaf; raises
        where a sharded dim does not divide."""
        out = list(shape)
        for i, entry in enumerate(self.spec):
            if entry is None:
                continue
            n = math.prod(self.mesh.shape[a] for a in
                          (entry if isinstance(entry, tuple) else (entry,)))
            if out[i] % n:
                raise ValueError(f"dim {i} of {tuple(shape)} does not "
                                 f"divide over {entry} ({n})")
            out[i] //= n
        return tuple(out)

    def _sharded(self):
        """(dim, axes) of each sharded dim."""
        for i, entry in enumerate(self.spec):
            if entry is not None:
                yield i, (entry if isinstance(entry, tuple) else (entry,))

    def local(self, full: torch.Tensor) -> torch.Tensor:
        """This rank's block of the whole leaf ``full`` (a view): on each
        sharded dim the block at the rank's row-major position along the
        dim's axes."""
        self.shard_shape(full.shape)
        out = full
        for i, axes in self._sharded():
            n = self.mesh.size_of(axes)
            if n > 1:
                size = out.shape[i] // n
                out = out.narrow(i, self.mesh.index(axes) * size, size)
        return out

    def gather(self, local: torch.Tensor) -> torch.Tensor:
        """The whole leaf from every rank's block: an all_gather over each
        sharded dim's axes."""
        out = local
        for i, axes in self._sharded():
            out = collectives.all_gather(out, i, axes, self.mesh)
        return out

    def reduce(self, share: torch.Tensor) -> torch.Tensor:
        """This rank's block of the sum over every rank of ``share`` (a
        whole leaf's gradient as one rank holds it, collectives.py's
        convention): a sum reduce-scatter over each sharded dim's axes,
        then a psum over the axes the spec leaves out."""
        out = share
        used = set()
        for i, axes in self._sharded():
            out = collectives.reduce_scatter(out, i, axes, self.mesh)
            used.update(axes)
        rest = tuple(a for a in self.mesh.axis_names if a not in used)
        return collectives.psum(out, rest, self.mesh) if rest else out

    def first_holder(self) -> bool:
        """Whether this rank is the first of those holding its block:
        coordinate 0 along every axis the spec leaves out."""
        used = {a for _, axes in self._sharded() for a in axes}
        return all(self.mesh.coord(a) == 0 for a in self.mesh.axis_names
                   if a not in used)


@dataclass(frozen=True)
class MeshRules:
    mesh: Mesh
    data_axes: tuple        # ("data",) or ("pod", "data")
    model_axis: str = "model"

    @property
    def model_size(self) -> int:
        return self.mesh.shape[self.model_axis]

    @property
    def data_size(self) -> int:
        return math.prod(self.mesh.shape[a] for a in self.data_axes)

    @property
    def fsdp_axes(self) -> tuple:
        return self.data_axes + (self.model_axis,)

    @property
    def fsdp_size(self) -> int:
        return self.data_size * self.model_size


def make_rules(mesh: Mesh) -> MeshRules:
    axes = mesh.axis_names
    data_axes = tuple(a for a in axes if a in ("pod", "data"))
    return MeshRules(mesh=mesh, data_axes=data_axes)


# ---------------------------------------------------------------------------
# parameter shardings
# ---------------------------------------------------------------------------
def _pick_dim(shape, divisor: int, skip_dims: int, min_shard: int = 8):
    """Largest dim (prefer trailing) divisible by divisor; -1 if none."""
    best, best_size = -1, 0
    for i in range(len(shape) - 1, skip_dims - 1, -1):
        d = shape[i]
        if d % divisor == 0 and d // divisor >= min_shard \
                and d > best_size:
            best, best_size = i, d
    return best


def _entry(axes: tuple):
    """A spec entry over ``axes``: the name of one axis, else the tuple."""
    return axes if len(axes) > 1 else axes[0]


def param_spec(shape, rules: MeshRules, mode: str,
               scan_dims: int = 0) -> tuple:
    """mode 'train': 2D FSDP -- one dim over the data axes (the
    all-gather dim) and a *different* dim over model (matching the TP
    compute sharding, so un-sharding at use is a single data-axis
    all-gather instead of a full reshard); falls back to 1D.
    mode 'serve': TP over model only."""
    if len(shape) <= scan_dims:
        return ()
    entries = [None] * len(shape)
    if mode == "train":
        mdim = _pick_dim(shape, rules.model_size, scan_dims)
        if mdim >= 0:
            # model axis on the TP dim; data axes on another dim
            ddim = _pick_dim(
                [s if i != mdim else 1 for i, s in enumerate(shape)],
                rules.data_size, scan_dims, min_shard=1)
            if ddim >= 0 and ddim != mdim:
                entries[ddim] = _entry(rules.data_axes)
            entries[mdim] = rules.model_axis
            return tuple(entries)
        dim = _pick_dim(shape, rules.data_size, scan_dims)
        if dim >= 0:
            entries[dim] = _entry(rules.data_axes)
            return tuple(entries)
        return ()
    dim = _pick_dim(shape, rules.model_size, scan_dims)
    if dim >= 0:
        entries[dim] = rules.model_axis
        return tuple(entries)
    return ()


def _map(fn, node, path=(), layers=None):
    """``fn(leaf, path, layers)`` over the leaves of nested dicts, tuples
    and lists, where ``path`` holds the keys from the root and ``layers``
    is the length of the layer list the leaf lies in (None outside one)."""
    if isinstance(node, dict):
        return {k: _map(fn, v, path + (k,), layers) for k, v in node.items()}
    if isinstance(node, tuple):
        return tuple(_map(fn, v, path, layers) for v in node)
    if isinstance(node, list):
        return [_map(fn, v, path, len(node)) for v in node]
    return fn(node, path, layers)


def _zip_map(fn, tree, shardings):
    """``fn(leaf, sharding)`` over a tree of dicts, tuples and lists and
    the matching tree of ``NamedSharding``, in ``tree``'s shape."""
    if isinstance(tree, dict):
        return {k: _zip_map(fn, v, shardings[k]) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        if len(tree) != len(shardings):
            raise ValueError(f"{len(tree)} entries against "
                             f"{len(shardings)} shardings")
        return type(tree)(_zip_map(fn, v, s)
                          for v, s in zip(tree, shardings))
    return fn(tree, shardings)


def zip_leaves(tree, shardings):
    """(leaf, sharding) of every leaf of ``tree``, matched to the tree of
    ``NamedSharding`` by key and index, in ``tree``'s order."""
    pairs = []
    _zip_map(lambda t, s: pairs.append((t, s)), tree, shardings)
    return pairs


def place(tree, shardings):
    """Each rank's blocks of a tree of whole leaves, as contiguous copies
    on the mesh's device (the port's ``jax.device_put(tree,
    shardings)``); a leaf that is a plain number (the encoder-decoder
    cache's ``enc_len``) as it is."""
    def one(t, s):
        if not isinstance(t, torch.Tensor):
            return t
        return s.local(t).to(s.mesh.device, copy=True,
                             memory_format=torch.contiguous_format)
    return _zip_map(one, tree, shardings)


def gather_tree(tree, shardings):
    """The whole leaves of a tree of this rank's blocks (``place``'s
    inverse), plain numbers as they are; every rank must call it.

    ``NamedSharding.gather`` leaf by leaf in effect, in as few collectives
    as the specs allow: in each round, every leaf still split takes its
    first split dim, and the leaves split over the same axes and of one
    type go through one all_gather of their blocks, flattened and
    concatenated (a tree of serve specs, split on one dim over the model
    axis, in one all_gather a type)."""
    pairs = zip_leaves(tree, shardings)
    whole = [t for t, _ in pairs]
    todo = {i: list(s._sharded()) for i, (t, s) in enumerate(pairs)
            if isinstance(t, torch.Tensor)}
    while any(todo.values()):
        groups = {}
        for i, dims in todo.items():
            if dims:
                groups.setdefault((dims[0][1], whole[i].dtype), []).append(i)
        for (axes, _), idx in groups.items():
            mesh = pairs[idx[0]][1].mesh
            if mesh.size_of(axes) == 1:      # the block is whole there
                for i in idx:
                    todo[i].pop(0)
                continue
            flat = torch.cat([whole[i].reshape(-1) for i in idx])
            parts = collectives.all_gather(flat[None], 0, axes, mesh)
            start = 0
            for i in idx:
                t, (dim, _) = whole[i], todo[i].pop(0)
                blocks = parts[:, start:start + t.numel()]
                start += t.numel()
                whole[i] = torch.cat(blocks.reshape(-1, *t.shape).unbind(0),
                                     dim)
    it = iter(whole)
    return _zip_map(lambda t, s: next(it), tree, shardings)


def reduce_tree(shares, shardings):
    """Each rank's blocks of the sums over the ranks of a tree of whole
    leaves' shares (``NamedSharding.reduce``: a tree of gradients)."""
    return _zip_map(lambda t, s: s.reduce(t), shares, shardings)


def tree_leaves(tree):
    """Every leaf of nested dicts, tuples and lists, in order."""
    if isinstance(tree, dict):
        tree = tree.values()
    elif not isinstance(tree, (list, tuple)):
        yield tree
        return
    for v in tree:
        yield from tree_leaves(v)


def _stacked(spec_of, shape, layers, scan_dims: int) -> tuple:
    """``spec_of(shape, scan_dims)`` of a leaf; for a leaf of a layer list,
    of its stacked shape with one scan dim, the leading entry dropped."""
    if layers is None:
        return spec_of(tuple(shape), scan_dims)
    return spec_of((layers,) + tuple(shape), 1)[1:]


def _scan_dims_of(path) -> int:
    """Leaves under a 'layers' collection carry a leading stacked-layer
    dim in the reference's layout; those dims must stay unsharded (they
    are scan-indexed)."""
    return 1 if any("layers" in str(k) for k in path) else 0


def param_shardings(tree, rules: MeshRules, mode: str = "train"):
    """A tree of ``NamedSharding`` shaped like ``tree`` (tensors, meta
    included, or anything with a ``shape``)."""
    def one(leaf, path, layers):
        spec = _stacked(lambda shape, scan: param_spec(shape, rules, mode,
                                                       scan),
                        leaf.shape, layers, _scan_dims_of(path))
        return NamedSharding(rules.mesh, spec)
    return _map(one, tree)


# ---------------------------------------------------------------------------
# activations / batches / caches
# ---------------------------------------------------------------------------
def _batch_axes(b: int, rules: MeshRules) -> tuple:
    """As many data axes, in order, as divide ``b``."""
    axes = []
    rem = b
    for a in rules.data_axes:
        sz = rules.mesh.shape[a]
        if rem % sz == 0:
            axes.append(a)
            rem //= sz
    return tuple(axes)


def batch_spec(global_batch: int, rules: MeshRules) -> tuple:
    """Shard dim 0 over as many data axes as divide it."""
    axes = _batch_axes(global_batch, rules)
    return (_entry(axes) if axes else None,)


def batch_shardings(tree, rules: MeshRules):
    def one(leaf, path, layers):
        spec = batch_spec(leaf.shape[0], rules)
        return NamedSharding(rules.mesh,
                             spec + (None,) * (len(leaf.shape) - 1))
    return _map(one, tree)


def token_shardings(tree, rules: MeshRules):
    """A batch on a mesh of ranks, in the one activation layout
    (``act_sharding.py``): the rows of every leaf over all data axes, and
    the sequence of a (B, S) leaf (tokens, labels, mask) over the model
    axis; an encoder's frames (B, S_enc, d) by rows only."""
    def one(leaf, path, layers):
        spec = (_entry(rules.data_axes),)
        if len(leaf.shape) == 2:
            spec += (rules.model_axis,)
        return NamedSharding(rules.mesh,
                             spec + (None,) * (len(leaf.shape) - len(spec)))
    return _map(one, tree)


def _cache_spec(shape, rules: MeshRules, scan_dims: int) -> tuple:
    entries = [None] * len(shape)
    if len(shape) > scan_dims:
        axes = _batch_axes(shape[scan_dims], rules)
        if axes:
            entries[scan_dims] = _entry(axes)
    dim = _pick_dim(shape, rules.model_size, scan_dims + 1, min_shard=1)
    if dim >= 0:
        entries[dim] = rules.model_axis
    return tuple(entries)


def cache_sharding(shape, rules: MeshRules, scan_dims: int = 1):
    """KV cache (L, B, S, KH, D) or state (L, B, ...): batch dim over
    data axes if divisible, else the largest remaining dim over model
    (sequence-sharded KV == page ownership)."""
    return NamedSharding(rules.mesh, _cache_spec(shape, rules, scan_dims))


def cache_shardings(tree, rules: MeshRules):
    """A leaf of a layer list (the port's per-layer recurrent states) as
    its stacked leaf, (L, B, ...); a 0-d leaf or a plain number (the
    encoder-decoder's ``enc_len``) replicated."""
    def one(leaf, path, layers):
        if not isinstance(leaf, torch.Tensor) or leaf.dim() == 0:
            return replicated(rules)
        return NamedSharding(rules.mesh, _stacked(
            lambda shape, scan: _cache_spec(shape, rules, scan),
            leaf.shape, layers, 1))
    return _map(one, tree)


def replicated(rules: MeshRules):
    return NamedSharding(rules.mesh, ())
