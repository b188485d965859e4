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
    a per-token sum over the whole batch.
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


_policy: contextvars.ContextVar = contextvars.ContextVar(
    "act_sharding_policy", default=None)


@contextlib.contextmanager
def activation_sharding(mesh, data_axes: tuple, model_axis: str,
                        tokens: tuple | None = None):
    """Install the policy for the block; ``tokens``, the global (B, S) of
    the step's tokens, lets ``constrain`` check activations on a mesh of
    ranks."""
    token = _policy.set(Policy(mesh, tuple(data_axes), model_axis,
                               None if tokens is None else tuple(tokens)))
    try:
        yield
    finally:
        _policy.reset(token)


def ranks() -> Policy | None:
    """The policy when its mesh is a mesh of ranks, else None."""
    pol = _policy.get()
    if pol is None or pol.mesh.place is None:
        return None
    return pol


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
