"""The activation-sharding policy, plumbed via a contextvar so model code
stays mesh-agnostic: the port's copy of the reference's
``distributed/act_sharding.py``. The launch layer installs the policy
(``activation_sharding``, as the step builders do); without one every
function here is the identity.

On a mesh with no ranks (the dry run's meshes) the policy only answers
whether the heads divide the model axis (``head_sharding_active``), which
picks the reference's heads-major blocked attention under
``kernels/flash_attention/flash_attention.py``'s ``HEAD_SHARDED_ATTENTION``;
the layout functions are the identity there, as the reference's
constraints change no value.

On a mesh of ranks (``launch/mesh.py:make_mesh``) each rank holds its
block of every activation, in one layout everywhere: the batch rows over
the data axes and the sequence over the model axis (the reference's
``SEQ_SHARDED_ACTIVATIONS`` layout, which its ``moe_ff_sharded``'s
``x_spec`` assumes). The reference's toggle has no counterpart: it picks
between two layouts for GSPMD to propagate, while an explicit partition
holds one, and moves a tensor out of it only where an op needs another,
by a collective:

  * ``constrain`` checks that a (B, S, ...) activation is the rank's
    block of the policy's ``tokens`` (B, S);
  * ``constrain_heads`` moves an attention input from the sequence
    layout (B, S/M, H, D) to the heads layout (B, S, H/M, D) by an
    all-to-all over the model axis (the model layout of the reference's
    (B, H, S/M, D) -> (B, H/M, S, D)); ``release_heads`` moves it back;
  * ``gather_sequence`` gives every rank the whole sequence (an
    all_gather over the model axis) and ``local_sequence`` keeps its own
    positions of such a tensor;
  * ``constrain_experts`` moves MoE buckets (E, C, d) to the (E/M, M*C, d)
    layout, each rank's experts with every rank's tokens for them;
    ``release_experts`` moves them back;
  * ``seq_start`` is the rank's first position, ``token_mean`` the mean of
    a per-token sum over the whole batch;
  * ``halo`` gives the SSM's causal conv the previous rank's last
    positions (a ``shift``, point to point), ``gather_model`` stacks a
    tensor of every rank of the model axis (the SSD's carried states, the
    decode's attention partials), ``last_position`` gives every rank the
    sequence's last position, and ``reshard_sequence`` moves a tensor of
    the sequence layout to a cache's spec.

The decode steps hold another layout, ``"rows"``: the batch rows over the
data axes that divide them, every model rank holding the same rows whole,
and the caches by their partition rules (``Policy.cache``: the dim of each
cache leaf's per-layer block that the model axis splits, read by
``cache_split``). ``ranks`` answers for the sequence layout only, so that
the functions above stay the identity there; ``rows`` answers for the
rows layout, and ``model_coord``, ``gather_model``, ``model_gather`` and
``model_sum`` serve both.
"""

from __future__ import annotations

import contextlib
import contextvars
from dataclasses import dataclass

import torch

from . import collectives


@dataclass(frozen=True)
class Policy:
    mesh: object
    data_axes: tuple
    model_axis: str
    tokens: tuple | None = None     # the step's global (B, S)
    layout: str = "sequence"        # or "rows" (the decode steps)
    cache: dict | None = None       # rows: leaf name -> the split dim


_policy: contextvars.ContextVar = contextvars.ContextVar(
    "act_sharding_policy", default=None)


@contextlib.contextmanager
def activation_sharding(mesh, data_axes: tuple, model_axis: str,
                        tokens: tuple | None = None, *,
                        layout: str = "sequence", cache: dict | None = None):
    """Install the policy for the block; ``tokens``, the global (B, S) of
    the step's tokens, lets ``constrain`` check activations on a mesh of
    ranks. ``layout`` "rows" (a decode step) with ``cache``, the dim of
    each cache leaf's per-layer block that the model axis splits, by the
    leaf's name (``cache_split``)."""
    if layout not in ("sequence", "rows"):
        raise ValueError(f"unknown activation layout {layout!r}")
    token = _policy.set(Policy(mesh, tuple(data_axes), model_axis,
                               None if tokens is None else tuple(tokens),
                               layout, dict(cache or {})))
    try:
        yield
    finally:
        _policy.reset(token)


def _on_ranks() -> Policy | None:
    pol = _policy.get()
    if pol is None or pol.mesh.place is None:
        return None
    return pol


def ranks() -> Policy | None:
    """The policy when its mesh is a mesh of ranks and the activations are
    in the sequence layout, else None."""
    pol = _on_ranks()
    return pol if pol is not None and pol.layout == "sequence" else None


def rows() -> Policy | None:
    """The policy when its mesh is a mesh of ranks and the activations are
    in the rows layout (a decode step), else None."""
    pol = _on_ranks()
    return pol if pol is not None and pol.layout == "rows" else None


def _model(pol: Policy) -> int:
    return pol.mesh.shape[pol.model_axis]


def head_sharding_active(num_heads: int) -> bool:
    pol = _policy.get()
    if pol is None:
        return False
    return num_heads % _model(pol) == 0


def constrain(x: torch.Tensor) -> torch.Tensor:
    """x (B, S, ...) as it is; on a mesh of ranks whose policy names the
    step's tokens, raises unless x is one rank's block of them: B / (data
    axes) rows and S / (model axis) positions."""
    pol = ranks()
    if pol is None or pol.tokens is None or x.dim() < 3:
        return x
    b, s = pol.tokens
    want = (b // pol.mesh.size_of(pol.data_axes), s // _model(pol))
    if tuple(x.shape[:2]) != want:
        raise ValueError(f"activation {tuple(x.shape)} is not a rank's "
                         f"block {want} of the {b} x {s} tokens")
    return x


def constrain_heads(x: torch.Tensor) -> torch.Tensor:
    """(B, S/M, H, D) -> (B, S, H/M, D) on a mesh of ranks: every position
    of the rank's H/M heads."""
    pol = ranks()
    if pol is None:
        return x
    return collectives.all_to_all(x, 2, 1, pol.model_axis, pol.mesh)


def release_heads(x: torch.Tensor) -> torch.Tensor:
    """``constrain_heads``' inverse: (B, S, H/M, D) -> (B, S/M, H, D)."""
    pol = ranks()
    if pol is None:
        return x
    return collectives.all_to_all(x, 1, 2, pol.model_axis, pol.mesh)


def gather_sequence(x: torch.Tensor) -> torch.Tensor:
    """(B, S/M, ...) -> (B, S, ...) on every rank of a mesh of ranks."""
    pol = ranks()
    if pol is None:
        return x
    return collectives.all_gather(x, 1, pol.model_axis, pol.mesh)


def local_sequence(x: torch.Tensor) -> torch.Tensor:
    """The rank's S/M positions of a (B, S, ...) tensor on a mesh of ranks
    (a view)."""
    pol = ranks()
    if pol is None:
        return x
    m = _model(pol)
    size = x.shape[1] // m
    return x.narrow(1, pol.mesh.coord(pol.model_axis) * size, size)


def constrain_experts(x: torch.Tensor) -> torch.Tensor:
    """MoE buckets (E, C, d) -> (E/M, M*C, d) on a mesh of ranks: the
    rank's E/M experts with every rank's C slots for each, in rank
    order."""
    pol = ranks()
    if pol is None:
        return x
    return collectives.all_to_all(x, 0, 1, pol.model_axis, pol.mesh)


def release_experts(x: torch.Tensor) -> torch.Tensor:
    """``constrain_experts``' inverse: (E/M, M*C, d) -> (E, C, d)."""
    pol = ranks()
    if pol is None:
        return x
    return collectives.all_to_all(x, 1, 0, pol.model_axis, pol.mesh)


def seq_start(s: int) -> int:
    """The global position of the rank's first of ``s`` local positions:
    its model coordinate times ``s`` on a mesh of ranks, else 0."""
    pol = ranks()
    if pol is None:
        return 0
    return pol.mesh.coord(pol.model_axis) * s


def token_mean(total: torch.Tensor, count: int) -> torch.Tensor:
    """``total`` / ``count`` for a sum over ``count`` tokens; on a mesh of
    ranks, where every rank holds as many tokens, the sum over the mesh
    divided by the whole batch's count: the global mean, on every rank."""
    pol = ranks()
    if pol is None:
        return total / count
    mesh = pol.mesh
    return collectives.psum(total, mesh.axis_names, mesh) \
        / (count * mesh.size)


def mesh_sum(x: torch.Tensor) -> torch.Tensor:
    """The sum of ``x`` over every rank of a mesh of ranks, else x."""
    pol = ranks()
    if pol is None:
        return x
    return collectives.psum(x, pol.mesh.axis_names, pol.mesh)


def model_coord() -> tuple[int, int]:
    """(this rank's coordinate on the model axis, the axis' size) under a
    policy on a mesh of ranks, either layout; (0, 1) otherwise."""
    pol = _on_ranks()
    if pol is None:
        return 0, 1
    return pol.mesh.coord(pol.model_axis), _model(pol)


def gather_model(x: torch.Tensor) -> torch.Tensor:
    """x of every rank of the model axis stacked on a new leading dim, in
    rank order, (M, ...); x[None] without ranks. Backward: each rank's
    slice summed back to it."""
    pol = _on_ranks()
    if pol is None:
        return x[None]
    return collectives.all_gather(x[None], 0, pol.model_axis, pol.mesh)


def model_gather(x: torch.Tensor, dim: int) -> torch.Tensor:
    """The model axis' blocks of x concatenated on ``dim``, in rank order;
    x without ranks."""
    pol = _on_ranks()
    if pol is None:
        return x
    return collectives.all_gather(x, dim, pol.model_axis, pol.mesh)


def model_sum(x: torch.Tensor) -> torch.Tensor:
    """The sum of x over the model axis; x without ranks."""
    pol = _on_ranks()
    if pol is None:
        return x
    return collectives.psum(x, pol.model_axis, pol.mesh)


def halo(x: torch.Tensor, k: int) -> torch.Tensor | None:
    """The previous model rank's last ``k`` positions of x (B, S/M, ...),
    zeros on the first rank: what a causal window of k + 1 positions
    reads before the rank's first. None without ranks in the sequence
    layout or on a model axis of 1, where the caller pads as on one
    card."""
    pol = ranks()
    if pol is None or _model(pol) == 1:
        return None
    if x.shape[1] < k:
        raise ValueError(f"a rank's {x.shape[1]} positions hold less than "
                         f"the {k} that the next rank's window reads")
    return collectives.shift(x[:, x.shape[1] - k:], pol.model_axis,
                             pol.mesh)


def last_position(x: torch.Tensor) -> torch.Tensor:
    """x[:, -1:] of the whole sequence, (B, 1, ...), on every rank: under
    the sequence layout the last model rank's, by an all_gather of each
    rank's last position."""
    pol = ranks()
    last = x[:, -1:]
    if pol is None:
        return last
    return collectives.all_gather(last, 1, pol.model_axis, pol.mesh)[:, -1:]


def reshard_sequence(x: torch.Tensor, seq_dim: int,
                     dim: int | None) -> torch.Tensor:
    """x of the sequence layout (its ``seq_dim`` split over the model axis)
    as the block of a spec that splits ``dim`` over it instead (an
    all-to-all), or whole where ``dim`` is None (an all_gather)."""
    pol = ranks()
    if pol is None or dim == seq_dim:
        return x
    if dim is None:
        return collectives.all_gather(x, seq_dim, pol.model_axis, pol.mesh)
    return collectives.all_to_all(x, dim, seq_dim, pol.model_axis, pol.mesh)


def cache_split(name: str) -> int | None:
    """The dim of cache leaf ``name``'s per-layer block that the model axis
    splits, under a rows policy on a model axis of more than one rank;
    None otherwise (the block is the whole leaf's along every dim but the
    rows)."""
    pol = rows()
    if pol is None or _model(pol) == 1:
        return None
    return pol.cache.get(name)
