"""int8 error-feedback gradient compression: the reference's
``optim/compression.py``.

Gradients are quantized to int8 with one scale per leaf (the max over the
whole leaf, layers stacked, as the reference's) before the optimizer takes
them; the quantization residual is carried in an error-feedback buffer so
the scheme is unbiased over time.  Rounding is half to even, as
``jnp.round``.  The port updates the gradients and the buffer in place.
"""

from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.tree import leaves, tree_map


def _quantize(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    scale = torch.clamp(x.abs().max(), min=1e-12) / 127.0
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


@torch.no_grad()
def int8_ef_compress(grads, ef_state):
    """Returns ``(dequantized grads actually applied, new error-feedback
    state)``: both are the input trees, updated in place."""
    for g, e in zip(leaves(grads), leaves(ef_state)):
        g32 = g.float() + e
        q, s = _quantize(g32)
        deq = q.float() * s
        e.copy_(g32 - deq)
        g.copy_(deq.to(g.dtype))
    return grads, ef_state


def init_ef_state(params):
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device), params)
