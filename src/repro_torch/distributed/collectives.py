"""Collectives over the named axes of a mesh of ranks
(``launch/mesh.py:make_mesh``): the port's counterpart of what GSPMD
inserts implicitly in the reference, and of the ``lax.all_to_all`` and
``lax.pmean`` in its ``moe_ff_sharded``.

``all_gather``, ``reduce_scatter`` (a sum), ``all_to_all`` (tiled, as
``lax.all_to_all(..., tiled=True)``), ``psum``, ``pmean`` and ``shift``
(each rank's tensor to the next rank along an axis, point to point, as
``lax.ppermute`` by one): each runs
over the process group of ``axes`` (a name or a tuple in mesh order; the
ranks in row-major order along them), and is the identity, issuing
nothing, where those axes hold one position. A sharded dim is cut into
equal blocks, block i on the i-th rank; a dim that does not divide raises.

Each is autograd-aware, with its transpose for a backward: all_gather's is
a sum reduce-scatter, reduce_scatter's an all_gather, all_to_all's the
inverse all-to-all, psum's a psum, pmean's a pmean and shift's the
shift the other way. Under that
convention the gradient a rank holds is its share: the gradient of a
tensor is the sum of the ranks' shares, as the objective is the sum of
what each rank backpropagates. A loss that every rank holds whole is
backpropagated from 1 / mesh.size on each rank (``launch/steps.py:
value_and_grad``), and a parameter's gradient is the sum of the ranks'
shares (``NamedSharding.reduce``).

``calls`` and ``nbytes`` count, for each kind, the collectives issued and
the bytes of the tensors each rank handed to them; a backward counts under
the kind it issues. ``reset_counts`` sets them to 0.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

KINDS = ("all_gather", "reduce_scatter", "all_to_all", "all_reduce",
         "send_recv")
calls = dict.fromkeys(KINDS, 0)
nbytes = dict.fromkeys(KINDS, 0)


def reset_counts() -> None:
    for kind in KINDS:
        calls[kind] = 0
        nbytes[kind] = 0


def _count(kind: str, t: torch.Tensor) -> None:
    calls[kind] += 1
    nbytes[kind] += t.numel() * t.element_size()


def _chunks(x: torch.Tensor, dim: int, n: int) -> list:
    if x.shape[dim] % n:
        raise ValueError(f"dim {dim} of {tuple(x.shape)} does not divide "
                         f"over {n} ranks")
    return [c.contiguous() for c in x.chunk(n, dim)]


def _gather(x, dim, group, n):
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(n)]
    _count("all_gather", x)
    dist.all_gather(parts, x, group=group)
    return torch.cat(parts, dim)


def _scatter_sum(x, dim, group, n):
    chunks = _chunks(x, dim, n)
    out = torch.empty_like(chunks[0])
    _count("reduce_scatter", x)
    dist.reduce_scatter(out, chunks, group=group)
    return out


def _exchange(x, split_dim, concat_dim, group, n):
    chunks = _chunks(x, split_dim, n)
    outs = [torch.empty_like(c) for c in chunks]
    _count("all_to_all", x)
    dist.all_to_all(outs, chunks, group=group)
    return torch.cat(outs, concat_dim)


def _sum(x, group):
    out = x.contiguous().clone()
    _count("all_reduce", out)
    dist.all_reduce(out, group=group)
    return out


def _send_recv(x, group, n, index, step):
    """x sent to position index + step of the group and the tensor of
    position index - step received, zeros where there is none (a group
    of one position issues nothing)."""
    x = x.contiguous()
    out = torch.zeros_like(x)
    reqs = []
    if 0 <= index + step < n:
        _count("send_recv", x)
        peer = dist.get_process_group_ranks(group)[index + step]
        reqs.append(dist.isend(x, peer, group=group))
    if 0 <= index - step < n:
        peer = dist.get_process_group_ranks(group)[index - step]
        reqs.append(dist.irecv(out, peer, group=group))
    for r in reqs:
        r.wait()
    return out


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group, n):
        ctx.args = (dim, group, n)
        return _gather(x, dim, group, n)

    @staticmethod
    def backward(ctx, g):
        return _scatter_sum(g, *ctx.args), None, None, None


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group, n):
        ctx.args = (dim, group, n)
        return _scatter_sum(x, dim, group, n)

    @staticmethod
    def backward(ctx, g):
        return _gather(g, *ctx.args), None, None, None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, split_dim, concat_dim, group, n):
        ctx.args = (concat_dim, split_dim, group, n)
        return _exchange(x, split_dim, concat_dim, group, n)

    @staticmethod
    def backward(ctx, g):
        return _exchange(g, *ctx.args), None, None, None, None


class _Sum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _sum(x, group)

    @staticmethod
    def backward(ctx, g):
        return _sum(g, ctx.group), None


class _Shift(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, n, index):
        ctx.args = (group, n, index)
        return _send_recv(x, group, n, index, 1)

    @staticmethod
    def backward(ctx, g):
        return _send_recv(g, *ctx.args, -1), None, None, None


def _over(mesh, axes):
    """(group, ranks) of ``axes`` on ``mesh``; (None, 1) where they hold
    one position (any mesh, with ranks or not)."""
    n = mesh.size_of(axes)
    return (mesh.group(axes), n) if n > 1 else (None, 1)


def all_gather(x: torch.Tensor, dim: int, axes, mesh) -> torch.Tensor:
    """The ranks' blocks along ``axes`` concatenated on ``dim``, in rank
    order: every rank gets the whole. Backward: a sum reduce-scatter."""
    group, n = _over(mesh, axes)
    return x if n == 1 else _AllGather.apply(x, dim, group, n)


def reduce_scatter(x: torch.Tensor, dim: int, axes, mesh) -> torch.Tensor:
    """Block i (on ``dim``) of the sum over the ranks along ``axes`` of
    their ``x``, on the i-th of them. Backward: an all_gather."""
    group, n = _over(mesh, axes)
    return x if n == 1 else _ReduceScatter.apply(x, dim, group, n)


def all_to_all(x: torch.Tensor, split_dim: int, concat_dim: int, axis,
               mesh) -> torch.Tensor:
    """``x`` cut into blocks on ``split_dim``, block j sent to the j-th
    rank along ``axis``; the blocks received concatenated on
    ``concat_dim`` in rank order (``lax.all_to_all(..., tiled=True)``).
    Backward: the inverse all-to-all."""
    group, n = _over(mesh, axis)
    if n == 1:
        return x
    return _AllToAll.apply(x, split_dim, concat_dim, group, n)


def psum(x: torch.Tensor, axes, mesh) -> torch.Tensor:
    """The sum over the ranks along ``axes``, on each of them. Backward: a
    psum."""
    group, n = _over(mesh, axes)
    return x if n == 1 else _Sum.apply(x, group)


def pmean(x: torch.Tensor, axes, mesh) -> torch.Tensor:
    """The mean over the ranks along ``axes``, on each of them. Backward:
    a pmean."""
    n = mesh.size_of(axes)
    return x if n == 1 else psum(x, axes, mesh) / n


def shift(x: torch.Tensor, axis, mesh) -> torch.Tensor:
    """The ``x`` of the rank before this one along ``axis`` (``lax.ppermute``
    from each position to the next); zeros on the first rank, which has
    none, and wherever ``axis`` holds one position. Backward: the shift
    the other way, the first rank's gradient dropped."""
    group, n = _over(mesh, axis)
    return _Shift.apply(x, group, n, mesh.index(axis) if n > 1 else 0)


def barrier(mesh) -> None:
    """Wait until every rank of the world reaches this call (the world is
    the mesh's: ``make_mesh`` holds every rank)."""
    dev = mesh.device
    if dev.type == "cuda":
        dist.barrier(device_ids=[dev.index])
    else:
        dist.barrier()

