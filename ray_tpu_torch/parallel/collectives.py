"""Differentiable collectives over one axis of a ``DeviceMesh``: the
communication XLA's partitioner inserts for ``ray_tpu``, written out for
the models' compute on local shards.

- ``copy_to(x, mesh, axis)`` — identity forward, all-reduce backward
  (Megatron's ``f``): a tensor replicated over ``axis`` entering a product
  split over it.
- ``reduce(x, mesh, axis)`` — all-reduce forward, identity backward
  (Megatron's ``g``): partial sums over ``axis`` leaving such a product.
- ``gather(x, mesh, axis, dim, grad)`` — all-gather along ``dim``; the
  backward reduce-scatters (``grad="sum"``: the ranks of ``axis`` saw
  different data, ZeRO-3's gradient) or keeps the rank's slice
  (``grad="slice"``: they computed the same gradient).
- ``shift(x, mesh, axis)`` — send to the next rank of ``axis`` and receive
  from the previous one (a ring); the backward shifts the gradient back.
  Ring attention's K/V rotation and the pipeline rotor's advance.

Every op is the identity on an axis of size 1 (or with ``mesh`` None), so
a world of one runs the same code with no communication.
"""

from __future__ import annotations

import math
from typing import Iterable, Union

import torch
import torch.distributed as dist

from ray_tpu_torch.parallel.mesh import (DATA_AXES, axis_rank, axis_size,
                                         local, logical_spec, named_sharding)

Axes = Union[str, Iterable[str]]


def _axes(mesh, axes: Axes):
    """The axes of ``axes`` with more than one rank (none without a mesh)."""
    if mesh is None:
        return []
    names = (axes,) if isinstance(axes, str) else tuple(axes)
    return [a for a in names if axis_size(mesh, a) > 1]


def all_reduce_(t: torch.Tensor, mesh, axes: Axes,
                op=dist.ReduceOp.SUM) -> torch.Tensor:
    """In-place all-reduce of ``t`` over each of ``axes`` (no autograd)."""
    for a in _axes(mesh, axes):
        dist.all_reduce(t, op=op, group=mesh.get_group(a))
    return t


class _Reduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes):
        return all_reduce_(x.clone(), mesh, axes)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes):
        ctx.mesh, ctx.axes = mesh, axes
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_(g.clone(), ctx.mesh, ctx.axes), None, None


def reduce(x: torch.Tensor, mesh, axes: Axes) -> torch.Tensor:
    axes = _axes(mesh, axes)
    return _Reduce.apply(x, mesh, axes) if axes else x


def copy_to(x: torch.Tensor, mesh, axes: Axes) -> torch.Tensor:
    axes = _axes(mesh, axes)
    return _CopyTo.apply(x, mesh, axes) if axes else x


def _all_gather(x: torch.Tensor, group, n: int, dim: int) -> torch.Tensor:
    x = x.contiguous()
    out = torch.empty((n * x.shape[0],) + tuple(x.shape[1:]), dtype=x.dtype,
                      device=x.device)
    dist.all_gather_into_tensor(out, x, group=group)
    if dim == 0:
        return out
    return torch.cat(out.chunk(n), dim=dim)


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, dim, grad):
        ctx.mesh, ctx.axis, ctx.dim, ctx.grad = mesh, axis, dim, grad
        return _all_gather(x, mesh.get_group(axis), axis_size(mesh, axis),
                           dim)

    @staticmethod
    def backward(ctx, g):
        mesh, axis, dim = ctx.mesh, ctx.axis, ctx.dim
        n = axis_size(mesh, axis)
        if ctx.grad == "slice":
            out = g.chunk(n, dim=dim)[axis_rank(mesh, axis)].contiguous()
        else:
            parts = torch.cat(g.chunk(n, dim=dim)).contiguous()
            out = torch.empty((parts.shape[0] // n,) + parts.shape[1:],
                              dtype=g.dtype, device=g.device)
            dist.reduce_scatter_tensor(out, parts, group=mesh.get_group(axis))
        return out, None, None, None, None


def gather(x: torch.Tensor, mesh, axis: str, dim: int,
           grad: str = "sum") -> torch.Tensor:
    if grad not in ("sum", "slice"):
        raise ValueError(f"gather: grad must be 'sum' or 'slice', got "
                         f"{grad!r}")
    if not _axes(mesh, axis):
        return x
    return _Gather.apply(x, mesh, axis, dim, grad)


def _shift(x: torch.Tensor, mesh, axis: str, step: int) -> torch.Tensor:
    group = mesh.get_group(axis)
    n, r = axis_size(mesh, axis), axis_rank(mesh, axis)
    send = x.contiguous()
    out = torch.empty_like(send)
    ops = [dist.P2POp(dist.isend, send,
                      dist.get_global_rank(group, (r + step) % n), group),
           dist.P2POp(dist.irecv, out,
                      dist.get_global_rank(group, (r - step) % n), group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return out


class _Shift(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return _shift(x, mesh, axis, 1)

    @staticmethod
    def backward(ctx, g):
        return _shift(g, ctx.mesh, ctx.axis, -1), None, None


def shift(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """Rank i's ``x`` -> rank i+1 (mod n) of ``axis``."""
    if not _axes(mesh, axis):
        return x
    if not x.requires_grad:
        return _shift(x, mesh, axis, 1)
    return _Shift.apply(x, mesh, axis)


class _Chained(torch.autograd.Function):
    """``fwd(x)`` with a token passed through, so that the calls sharing a
    token form one chain: the backward runs each ``bwd`` in exact reverse
    order on every rank, and runs it even where the rank did not use the
    output (its gradient is then zeros)."""

    @staticmethod
    def forward(ctx, token, x, fwd, bwd):
        ctx.bwd = bwd
        return token.view_as(token), fwd(x)

    @staticmethod
    def backward(ctx, g_token, g):
        return g_token, ctx.bwd(g), None, None


def chained(token: torch.Tensor, x: torch.Tensor, fwd, bwd):
    """Returns ``(token, fwd(x))``; see ``_Chained``. Ranks that run
    different graphs (the pipeline's stages) thread one token through
    their collectives over the axis that joins them, so those collectives
    pair up in both passes."""
    return _Chained.apply(token, x, fwd, bwd)


def chained_shift(token, x, mesh, axis: str):
    """``shift`` in a token chain (identity on an axis of size 1)."""
    if not _axes(mesh, axis):
        return token, x
    return chained(token, x, lambda t: _shift(t, mesh, axis, 1),
                   lambda g: _shift(g, mesh, axis, -1))


def chained_copy_to(token, x, mesh, axis: str):
    """``copy_to`` in a token chain."""
    if not _axes(mesh, axis):
        return token, x
    return chained(token, x, lambda t: t.view_as(t),
                   lambda g: all_reduce_(g.clone(), mesh, axis))


def unshard(w: torch.Tensor, names, mesh, keep: Iterable[str] = (),
            rules=None) -> torch.Tensor:
    """Gather the local shard ``w``, whose dims carry the logical
    ``names``, over every mesh axis the names map to except ``keep``: the
    per-use all-gather of a weight (ZeRO-3 over ``fsdp``, whose backward
    reduce-scatters the gradient; a slice over the axes whose ranks
    computed the same gradient)."""
    if mesh is None:
        return w
    for d, axes in enumerate(logical_spec(names, rules)):
        if axes is None:
            continue
        for a in reversed(axes if isinstance(axes, tuple) else (axes,)):
            if a not in keep:
                w = gather(w, mesh, a, d,
                           "sum" if a in DATA_AXES else "slice")
    return w


def unshard_params(params, logical_tree, mesh, stacked=(), layers=None,
                   keep: Iterable[str] = ()):
    """A model's parameters (DTensors or local shards) all-gathered by
    their logical names for a step over ``mesh`` (``unshard`` per leaf).
    ``layers`` — the optimizer's per-layer local views of the ``stacked``
    subtrees, a list for one subtree or a dict of lists — are gathered
    instead of those subtrees. Returns (params, layers)."""

    def tree(t, names):
        if isinstance(t, dict):
            return {k: tree(v, names[k]) for k, v in t.items()}
        if isinstance(t, list):
            return [tree(v, n) for v, n in zip(t, names)]
        return unshard(local(t), names, mesh, keep)

    def per_layer(name):
        return {k: v[1:] for k, v in logical_tree[name].items()}

    out = {k: v if layers is not None and k in stacked
           else tree(v, logical_tree[k]) for k, v in params.items()}
    if layers is None:
        return out, None
    if isinstance(layers, list):
        (name,) = stacked
        return out, [tree(view, per_layer(name)) for view in layers]
    return out, {name: [tree(view, per_layer(name)) for view in views]
                 for name, views in layers.items()}


def batch_rows(x: torch.Tensor, mesh) -> torch.Tensor:
    """This rank's rows (dim 0 over the batch's axes) of a global batch."""
    return local_slice(x, mesh, named_sharding(
        mesh, ("batch",) + (None,) * (x.dim() - 1)))


def local_slice(full: torch.Tensor, mesh, placements) -> torch.Tensor:
    """This rank's block of ``full`` under ``placements`` (a view): each
    ``Shard(d)`` in mesh-axis order splits dim ``d`` once more, so a dim
    sharded over two axes is split outer-axis-major, as DTensor and JAX
    split it."""
    out = full
    coord = mesh.get_coordinate()
    for i, p in enumerate(placements):
        if p.is_shard():
            n = mesh.size(i)
            if out.shape[p.dim] % n:
                raise ValueError(f"dim {p.dim} of {tuple(full.shape)} does "
                                 f"not split {n} ways")
            out = out.chunk(n, dim=p.dim)[coord[i]]
    return out


def data_size(mesh) -> int:
    """The number of data shards of a batch (the data axes' ranks)."""
    return math.prod(axis_size(mesh, a) for a in DATA_AXES)
