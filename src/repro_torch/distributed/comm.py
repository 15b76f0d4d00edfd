"""Differentiable collectives over one mesh axis, for the layer's explicit
per-rank code (the counterparts of the reference's ``shard_map`` bodies).

Each transpose follows what the value is on the ranks of the group:
``all_reduce`` leaves a value that every rank holds alike, so its gradient
is the rank's own (the reference's ``psum``), and ``vary`` sums the
gradients of such a value where the ranks go on to compute different
things from it (``pvary``); ``reduce_scatter`` hands back
its gradient by ``all_gather``; ``all_gather`` sums the ranks' gradients
and keeps the rank's slice where the ranks go on to compute different
things from the gathered value (``varying``, e.g. each model rank's own
experts), and only keeps its slice where they compute the same thing.
``reduce_scatter`` runs as the group's own (NCCL's on the card, the fake
group's in the dry run, whose counter then sees what NCCL would move) and
as an ``all_reduce`` and a slice under gloo, which has none.
"""

from __future__ import annotations

import torch
import torch.distributed as dist


def _size(group) -> int:
    return dist.get_world_size(group)


def _rank(group) -> int:
    return dist.get_rank(group)


def _gather(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    parts = [torch.empty_like(x) for _ in range(_size(group))]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts, dim)


def _slice(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    return x.chunk(_size(group), dim)[_rank(group)].contiguous()


def _reduce_scatter(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    if dist.get_backend(group) != dist.Backend.GLOO:
        x = x.movedim(dim, 0).contiguous()
        out = x.new_empty((x.shape[0] // _size(group), *x.shape[1:]))
        dist.reduce_scatter_tensor(out, x, group=group)
        return out.movedim(0, dim).contiguous()
    x = x.contiguous().clone()
    dist.all_reduce(x, group=group)
    return _slice(x, dim, group)


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group, varying):
        ctx.dim, ctx.group, ctx.varying = dim, group, varying
        return _gather(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        if ctx.varying:
            return _reduce_scatter(g, ctx.dim, ctx.group), None, None, None
        return _slice(g, ctx.dim, ctx.group), None, None, None


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        x = x.contiguous().clone()
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, g):
        return g, None


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return _reduce_scatter(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return _gather(g, ctx.dim, ctx.group), None, None


class _Vary(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _ScaleGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, s):
        ctx.s = s
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g * ctx.s, None


def all_gather(x: torch.Tensor, dim: int, group, *, varying: bool = True) -> torch.Tensor:
    """The group's blocks of ``x`` concatenated along ``dim`` (tiled)."""
    return _AllGather.apply(x, dim, group, varying)


def all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of the group's ``x``."""
    return _AllReduce.apply(x, group)


def reduce_scatter(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The sum of the group's ``x``, the rank's block along ``dim`` (tiled)."""
    return _ReduceScatter.apply(x, dim, group)


def vary(x: torch.Tensor, group) -> torch.Tensor:
    """``x``, alike on the group's ranks, entering computations that differ
    per rank: the identity, its gradient summed over the group (the
    reference's ``pvary``)."""
    return _Vary.apply(x, group)


def scale_grad(x: torch.Tensor, s: float) -> torch.Tensor:
    """``x``, its gradient times ``s``: a value every rank of a group
    computes alike, whose gradients the group later sums, counts once."""
    return x if s == 1 else _ScaleGrad.apply(x, s)
