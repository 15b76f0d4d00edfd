"""Hand-rolled optimizers: the reference's AdamW and Adafactor on trees of
tensors.

``make_optimizer(name)`` returns ``(init_fn, update_fn)``:
  init_fn(params)                          -> opt_state tree
  update_fn(grads, opt_state, params, lr)  -> (updates, new_opt_state)
Updates are *subtracted* by the caller.  All state is float32.

A leaf is one of the reference's parameter leaves, the layer stack's leaves
stacked ``[L, ...]`` (a hybrid stack's ``[nb, ...]`` and ``[nb, k, ...]``,
up to rank 5; ``train.step`` keeps the parameters so), so every reduction
spans the leaf as the reference's does: Adafactor's update clipping takes
its RMS over the whole stacked leaf, and factors the last two dims of every
leaf of rank >= 2, so a stacked norm scale ``[L, d]`` is factored across its
layers and a hybrid MoE leaf ``[nb, k, E, d, f]`` over ``(d, f)``.  The moments are updated in place
(the reference builds new arrays), which keeps one copy of the optimizer
state on the card; ``clip_by_global_norm`` scales the gradients in place.
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from functools import partial
from typing import Callable, Tuple

import torch

from repro_torch.tree import is_leaf, leaves, tree_map, unflatten


@dataclass(frozen=True)
class OptimizerSpec:
    name: str = "adamw"
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    # adafactor
    decay_rate: float = 0.8
    clip_threshold: float = 1.0


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf (float32), leaves in order."""
    total = None
    for x in leaves(tree):
        s = x.float().square().sum()
        total = s if total is None else total + s
    return total.sqrt()


@torch.no_grad()
def clip_by_global_norm(tree, max_norm: float):
    """Scales ``tree``'s leaves in place to a global norm of at most
    ``max_norm``; returns ``(tree, norm before clipping)``."""
    g = global_norm(tree)
    scale = torch.clamp(max_norm / torch.clamp(g, min=1e-9), max=1.0)
    for x in leaves(tree):
        x.mul_(scale.to(x.dtype))
    return tree, g


def lr_schedule(
    step, *, base_lr: float, warmup_steps: int, total_steps: int, min_ratio: float = 0.1
) -> torch.Tensor:
    """Linear warmup -> cosine decay to ``min_ratio * base_lr``, float32."""
    step = torch.as_tensor(step).float()
    warm = torch.clamp(step / max(warmup_steps, 1), max=1.0)
    prog = torch.clamp((step - warmup_steps) / max(total_steps - warmup_steps, 1), 0.0, 1.0)
    cos = min_ratio + (1 - min_ratio) * 0.5 * (1 + torch.cos(math.pi * prog))
    return base_lr * warm * cos


def _pairs(params, other):
    """``(param leaf, other's node at its place)`` in flattening order."""
    if is_leaf(params):
        yield params, other
        return
    for k in sorted(params):
        yield from _pairs(params[k], other[k])


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------


def _adamw_init(params):
    def z(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)

    count = torch.zeros((), dtype=torch.int32, device=leaves(params)[0].device)
    return {"m": tree_map(z, params), "v": tree_map(z, params), "count": count}


@torch.no_grad()
def _adamw_update(grads, state, params, lr, spec: OptimizerSpec):
    c = state["count"] + 1
    b1, b2 = spec.b1, spec.b2
    bc1 = 1 - torch.pow(b1, c.float())
    bc2 = 1 - torch.pow(b2, c.float())

    def upd(g, m, v, p):
        g = g.float()
        m.mul_(b1).add_((1 - b1) * g)
        v.mul_(b2).add_((1 - b2) * g.square())
        u = (m / bc1) / ((v / bc2).sqrt() + spec.eps) + spec.weight_decay * p.float()
        return (lr * u).to(p.dtype)

    updates = tree_map(upd, grads, state["m"], state["v"], params)
    return updates, {"m": state["m"], "v": state["v"], "count": c}


# ---------------------------------------------------------------------------
# Adafactor (factored second moment over the last two axes)
# ---------------------------------------------------------------------------


def _adafactor_init(params):
    def init(p):
        kw = dict(dtype=torch.float32, device=p.device)
        if p.dim() >= 2:
            return {
                "vr": torch.zeros(p.shape[:-1], **kw),
                "vc": torch.zeros((*p.shape[:-2], p.shape[-1]), **kw),
            }
        return {"v": torch.zeros(p.shape, **kw)}

    count = torch.zeros((), dtype=torch.int32, device=leaves(params)[0].device)
    return {"f": tree_map(init, params), "count": count}


@torch.no_grad()
def _adafactor_update(grads, state, params, lr, spec: OptimizerSpec):
    c = state["count"] + 1
    beta = 1.0 - c.float() ** (-spec.decay_rate)

    def upd(g, st, p):
        g = g.float()
        g2 = g.square() + 1e-30
        if g.dim() >= 2:
            vr = st["vr"].mul_(beta).add_((1 - beta) * g2.mean(-1))
            vc = st["vc"].mul_(beta).add_((1 - beta) * g2.mean(-2))
            row_mean = torch.clamp(vr.mean(-1, keepdim=True)[..., None], min=1e-30)
            denom = torch.sqrt(vr[..., None] * vc[..., None, :] / row_mean)
            u = g / torch.clamp(denom, min=1e-30)
        else:
            v = st["v"].mul_(beta).add_((1 - beta) * g2)
            u = g / (v.sqrt() + 1e-30)
        # update clipping (RMS <= 1) over the whole leaf, per Adafactor
        rms = torch.sqrt(u.square().mean() + 1e-30)
        u = u / torch.clamp(rms / spec.clip_threshold, min=1.0)
        u = u + spec.weight_decay * p.float()
        return (lr * u).to(p.dtype)

    updates = [upd(g, st, p) for (p, st), g in zip(_pairs(params, state["f"]), leaves(grads))]
    return unflatten(params, updates), {"f": state["f"], "count": c}


def make_optimizer(name: str, spec: OptimizerSpec = OptimizerSpec()) -> Tuple[Callable, Callable]:
    if name == "adamw":
        return _adamw_init, partial(_adamw_update, spec=dataclasses.replace(spec, name="adamw"))
    if name == "adafactor":
        return _adafactor_init, partial(
            _adafactor_update, spec=dataclasses.replace(spec, name="adafactor")
        )
    raise ValueError(f"unknown optimizer {name!r}")
