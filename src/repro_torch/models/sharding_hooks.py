"""Activation-sharding hook: the multi-device layer registers a callback
that redistributes DTensor activations at well-known points inside the
model (``distributed.sharding.make_activation_sharder``); with nothing
registered it is the identity, so the model's code stays mesh-free and a
single-device run (the card's, the CPU tests') is unchanged, bit for bit.
The reference's ``models/sharding_hooks.py``."""

from __future__ import annotations

from typing import Any, Callable, Optional

import torch
from torch.distributed.tensor import DTensor, Replicate

_SHARDER: Optional[Callable] = None
_MESH: Optional[Any] = None
_FSDP: bool = False


def set_activation_sharder(
    fn: Optional[Callable], mesh: Optional[Any] = None, fsdp: bool = False
) -> None:
    global _SHARDER, _MESH, _FSDP
    _SHARDER = fn
    _MESH = mesh
    _FSDP = fsdp


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
