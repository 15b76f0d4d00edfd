"""Activation-sharding hook: the multi-device layer registers a callback
that redistributes DTensor activations at well-known points inside the
model (``distributed.sharding.make_activation_sharder``); with nothing
registered it is the identity, so the model's code stays mesh-free and a
single-device run (the card's, the CPU tests') is unchanged, bit for bit.
The reference's ``models/sharding_hooks.py``."""

from __future__ import annotations

from typing import Any, Callable, NamedTuple, Optional

import torch
from torch.distributed.tensor import DTensor, Replicate

_SHARDER: Optional[Callable] = None
_MESH: Optional[Any] = None
_FSDP: bool = False
_CACHE_OPS: Optional["CacheOps"] = None


class CacheOps(NamedTuple):
    """A sharded serving step's operations on a contiguous cache of
    DTensors (``distributed.serve``): ``attention(cfg, q, new, positions,
    cache, impl=, mla=)`` writes a decode step's rows and attends over the
    cache, ``write_prefill(layer, updates, positions)`` writes a prompt
    into a rolling cache."""

    attention: Callable
    write_prefill: Callable


def set_activation_sharder(
    fn: Optional[Callable],
    mesh: Optional[Any] = None,
    fsdp: bool = False,
    cache_ops: Optional[CacheOps] = None,
) -> None:
    global _SHARDER, _MESH, _FSDP, _CACHE_OPS
    _SHARDER = fn
    _MESH = mesh
    _FSDP = fsdp
    _CACHE_OPS = cache_ops


def cache_ops() -> Optional[CacheOps]:
    """The ``CacheOps`` a sharded serving step registered; None otherwise,
    and then a layer's cache is plain tensors, read and written in place."""
    return _CACHE_OPS


def current_mesh():
    """The ``DeviceMesh`` the launcher registered; None in mesh-free runs."""
    return _MESH


def params_fsdp() -> bool:
    """Whether weights are ZeRO-3 sharded over ``data`` (launcher-registered)."""
    return _FSDP


def shard_activations(x, kind: str):
    """kind: ``resid``, ``logits``, ``attn_io``, ``batch0``, ``moe_buf``,
    ``moe_tokens``; see ``distributed/sharding.py``."""
    if _SHARDER is None:
        return x
    return _SHARDER(x, kind)


def gather_sequence(x):
    """A block's input gathered from sequence parallelism: on a DTensor
    whose sequence (dim 1) is split over mesh dims, those become
    replicated (Megatron-SP's all-gather before a block's TP products,
    which GSPMD inserts in the reference); anything else as it is."""
    if _MESH is None or not isinstance(x, DTensor):
        return x
    if not any(p.is_shard(1) for p in x.placements):
        return x
    want = [Replicate() if p.is_shard(1) else p for p in x.placements]
    return x.redistribute(x.device_mesh, want)


class _WholeSequenceGrad(torch.autograd.Function):
    """The identity, its gradient gathered from sequence parallelism."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return gather_sequence(g)


def whole_sequence_grad(x):
    """A block's output, computed on the whole sequence, as it joins a
    residual stream split by sequence parallelism: the identity, and its
    gradient gathered from sequence parallelism too, so that the block's
    backward products see whole sequences (DTensor cannot propagate a
    product over a batch x sequence dim split over two mesh dims under fake
    tensors); anything but a DTensor as it is."""
    if _MESH is None or not isinstance(x, DTensor):
        return x
    return _WholeSequenceGrad.apply(x)


def replicated(mesh, t: torch.Tensor):
    """A plain tensor as a replicated DTensor on ``mesh`` (every rank holds
    it whole); a DTensor as it is."""
    if isinstance(t, DTensor):
        return t
    return DTensor.from_local(t.contiguous(), mesh, [Replicate()] * mesh.ndim, run_check=False)


def on_batch_rows(fn, rows: tuple, whole: tuple = (), outs: tuple = ("rows",)):
    """``fn(*rows, *whole)`` as each rank's code on its batch rows, where
    the computation is independent across batch rows (each row's sequence
    whole) but has no DTensor strategy of its own (the MoE's routing
    algebra, the SSD scan): the MoE where ``model`` does not divide its
    experts, and the SSD where ``model`` does not divide its heads (the
    rules keep those weights whole there; where ``model`` divides them the
    MoE runs expert-parallel and the SSD split over its heads, with explicit
    collectives).  ``rows`` are tensors (or trees of them) with
    the batch on dim 0, ``whole`` trees of tensors every rank takes whole
    (the weights, gathered from TP and FSDP).  The batch keeps the split
    that the first DTensor of ``rows`` gives it over the data-parallel mesh
    dims (dim 0 sharded there), and every other mesh dim is replicated:
    such a rank computes what its peers over those dims compute.  Each
    output of ``fn`` is ``"rows"`` (batch on dim 0, laid out as the input
    rows) or ``"mean"`` (a mean over the rows, e.g. the MoE's ``aux``: the
    ranks' means averaged).  The gradients of ``whole`` come back
    ``Partial`` over the batch's mesh dims.  With no DTensor in ``rows`` it
    is ``fn`` itself."""
    from torch.distributed.tensor import Partial, Shard
    from torch.distributed.tensor.experimental import local_map
    from torch.utils import _pytree as pytree

    first = next((t for t in pytree.tree_leaves(rows) if isinstance(t, DTensor)), None)
    if first is None:
        return fn(*rows, *whole)
    mesh = first.device_mesh
    row_pl = tuple(Shard(0) if p.is_shard(0) else Replicate() for p in first.placements)
    whole_pl = tuple(Replicate() for _ in row_pl)
    grad_pl = tuple(Partial() if p.is_shard() else Replicate() for p in row_pl)
    nshard = 1
    for i, p in enumerate(row_pl):
        nshard *= mesh.size(i) if p.is_shard() else 1

    def dt(t):
        return replicated(mesh, t) if torch.is_tensor(t) else t

    rows, whole = pytree.tree_map(dt, rows), pytree.tree_map(dt, whole)
    n_rows = len(pytree.tree_leaves(rows))
    n_whole = len(pytree.tree_leaves(whole))
    out_pl = tuple(row_pl if k == "rows" else grad_pl for k in outs)

    def local(*args):
        out = fn(*args)
        out = out if isinstance(out, tuple) else (out,)
        return tuple(o / nshard if k == "mean" else o for o, k in zip(out, outs))

    run = local_map(
        local,
        out_placements=out_pl,
        in_placements=(row_pl,) * n_rows + (whole_pl,) * n_whole,
        in_grad_placements=(row_pl,) * n_rows + (grad_pl,) * n_whole,
        device_mesh=mesh,
        redistribute_inputs=True,
    )
    out = run(*rows, *whole)
    return out if len(outs) > 1 else out[0]


class _GradAsValue(torch.autograd.Function):
    """The identity; its gradient laid out as the value was."""

    @staticmethod
    def forward(ctx, x):
        ctx.placements = tuple(x.placements)
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        if isinstance(g, DTensor) and tuple(g.placements) != ctx.placements:
            g = g.redistribute(g.device_mesh, ctx.placements)
        return g


def grad_as_value(x):
    """``x``, its gradient redistributed to ``x``'s own placements: where
    the consumers of a value whole on ``model`` split their products over
    heads, the gradient comes back a ``Partial`` sum over ``model``, and
    DTensor would reduce-scatter it along a flattened batch x sequence dim
    that the data-parallel axes already split (a strided shard that the
    weight-gradient product cannot propagate); laid out as the value, it
    is all-reduced instead, as GSPMD does.  Anything but a DTensor as it
    is."""
    if _MESH is None or not isinstance(x, DTensor):
        return x
    return _GradAsValue.apply(x)
