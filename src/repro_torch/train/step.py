"""The train step: the reference's ``train/step.py``.

``make_train_step(cfg, run, total_steps)`` builds
   train_step(state, batch) -> (state, metrics)
with loss = CE + ``moe_aux_loss_weight`` * aux, microbatched gradient
accumulation in float32, optional int8 error-feedback compression,
global-norm clipping, the LR schedule, AdamW or Adafactor and ``p - u``,
in the reference's order.  Metrics: ``loss``, ``aux_loss``, ``grad_norm``
(before clipping), ``lr``, ``param_norm`` (after the update), as 0-dim
tensors.  ``make_prefill_step``/``make_decode_step`` are the reference's
serving steps over the contiguous cache (``models.model.prefill_cache``,
``decode_step_cache``).

The state's parameters are the reference's tree: one float32 tensor per
leaf, the layer stack's leaves stacked ``[L, ...]`` (a hybrid stack's
``[nb, ...]`` and ``[nb, k, ...]``).  The model's per-layer
parameters are views into those tensors and their ``.grad`` views into
``TrainState.grads``, so the forward runs the port's modules while the
optimizer, the int8 scales and the checkpoints see the reference's leaves.
The step updates the state in place (the reference returns a new one).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig, RunConfig
from repro_torch.models import model as M
from repro_torch.models.layers import cross_entropy, iter_specs
from repro_torch.optim import (
    clip_by_global_norm,
    global_norm,
    init_ef_state,
    int8_ef_compress,
    lr_schedule,
    make_optimizer,
)
from repro_torch.tree import leaves


@dataclass
class TrainState:
    """What a train step reads and updates.  ``tree()`` is the reference's
    train state (``{"params", "opt", "step"[, "ef"]}``), as checkpoints and
    ``interop`` carry it."""

    model: M.Transformer
    params: dict
    grads: dict
    opt: dict
    step: torch.Tensor  # int32 scalar
    ef: Optional[dict] = None

    def tree(self) -> dict:
        out = {"params": self.params, "opt": self.opt, "step": self.step}
        if self.ef is not None:
            out["ef"] = self.ef
        return out


def _set(tree: dict, keys, value) -> None:
    for k in keys[:-1]:
        tree = tree.setdefault(k, {})
    tree[keys[-1]] = value


@torch.no_grad()
def bind_stacked(model: M.Transformer) -> Tuple[dict, dict]:
    """Gather the model's parameters into the reference's tree, one tensor
    per leaf (layer leaves stacked ``[L, ...]``; a hybrid stack's ``[nb,
    ...]`` and ``[nb, k, ...]``), and make every parameter a view of its
    slice and its ``.grad`` a view of the same slice of a zeroed gradient
    tree.  Returns ``(params, grads)``."""
    params: dict = {}
    grads: dict = {}
    for keys, spec in iter_specs(M.param_specs(model.cfg)):
        if M.is_stacked(keys):
            ps = model.stacked(keys)
            leaf = torch.stack([p.detach() for _, p in ps]).reshape(spec.shape)
            grad = torch.zeros_like(leaf)
            for idx, p in ps:
                p.data = leaf[idx]
                p.grad = grad[idx]
        else:
            p = M._param(model, keys)
            leaf = p.detach()
            grad = torch.zeros_like(leaf)
            p.grad = grad
        _set(params, keys, leaf)
        _set(grads, keys, grad)
    return params, grads


def init_train_state(cfg: ModelConfig, run: RunConfig, seed: int = 0, *, device=None) -> TrainState:
    """Seeded parameters (the port's init), the optimizer's zero state and
    step 0 on ``device`` (default: CUDA)."""
    model = M.init_params(
        cfg,
        seed,
        device=device,
        compute_dtype=getattr(torch, run.compute_dtype),
        param_dtype=getattr(torch, run.param_dtype),
        impl=run.impl,
    )
    params, grads = bind_stacked(model)
    opt_init, _ = make_optimizer(run.optimizer)
    step = torch.zeros((), dtype=torch.int32, device=model.device)
    ef = init_ef_state(params) if run.grad_compression == "int8_ef" else None
    return TrainState(model, params, grads, opt_init(params), step, ef)


def _device_batch(batch: Dict[str, Any], device) -> Dict[str, torch.Tensor]:
    out = {}
    for k, v in batch.items():
        out[k] = (v if torch.is_tensor(v) else torch.from_numpy(np.asarray(v))).to(device)
    return out


def make_grad_fn(cfg: ModelConfig, run: RunConfig):
    """``grad_fn(state, batch) -> (grads, metrics)``: the loss's gradients
    accumulated into ``state.grads`` (zeroed first; with ``microbatches > 1``
    summed over the microbatches in float32, then divided, as the
    reference's scan) and ``{"loss", "aux_loss"}`` (their means).  An
    encoder-decoder stack reads its ``frames [B, T_enc, d]`` from the batch
    beside ``tokens`` and ``labels``, as the reference's step passes the
    batch to its ``forward_train``."""

    def loss_fn(model, batch):
        logits, aux = M.forward_train(
            model, batch["tokens"], frames=batch.get("frames"), remat_policy=run.remat_policy
        )
        loss = cross_entropy(logits, batch["labels"], cfg.vocab_size)
        total = loss + cfg.moe_aux_loss_weight * aux
        return total, {"loss": loss.detach(), "aux_loss": aux.detach()}

    def grad_fn(state: TrainState, batch):
        batch = _device_batch(batch, state.model.device)
        for g in leaves(state.grads):
            g.zero_()
        n = run.microbatches
        if n <= 1:
            total, metrics = loss_fn(state.model, batch)
            total.backward()
            return state.grads, metrics
        b = batch["tokens"].shape[0]
        if b % n:
            raise ValueError(f"batch {b} does not split into {n} microbatches")
        ms = []
        for i in range(n):
            mb = {k: v[i * (b // n) : (i + 1) * (b // n)] for k, v in batch.items()}
            total, m = loss_fn(state.model, mb)
            total.backward()
            ms.append(m)
        with torch.no_grad():
            for g in leaves(state.grads):
                g.div_(n)
        return state.grads, {k: torch.stack([m[k] for m in ms]).mean() for k in ms[0]}

    return grad_fn


def make_train_step(cfg: ModelConfig, run: RunConfig, total_steps: int):
    _, opt_update = make_optimizer(run.optimizer)
    grad_fn = make_grad_fn(cfg, run)

    def train_step(state: TrainState, batch) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        grads, metrics = grad_fn(state, batch)
        if run.grad_compression == "int8_ef":
            grads, state.ef = int8_ef_compress(grads, state.ef)
        grads, gnorm = clip_by_global_norm(grads, run.grad_clip)
        lr = lr_schedule(
            state.step,
            base_lr=run.learning_rate,
            warmup_steps=run.warmup_steps,
            total_steps=total_steps,
        )
        updates, state.opt = opt_update(grads, state.opt, state.params, lr)
        with torch.no_grad():
            for p, u in zip(leaves(state.params), leaves(updates)):
                p.sub_(u.to(p.dtype))
        del updates
        state.step = state.step + 1
        metrics = dict(metrics, grad_norm=gnorm, lr=lr, param_norm=global_norm(state.params))
        return state, metrics

    return train_step


def _check_model(model: M.Transformer, run: RunConfig) -> None:
    want = getattr(torch, run.compute_dtype)
    if model.compute_dtype != want:
        raise ValueError(
            f"the run computes in {run.compute_dtype}; "
            f"the model was built for {model.compute_dtype}"
        )


def make_prefill_step(cfg: ModelConfig, run: RunConfig):
    """The reference's ``make_prefill_step``: ``prefill_step(model, batch,
    cache) -> (logits, cache)`` over the contiguous cache
    (``models.model.prefill_cache``; ``batch["frames"]`` for whisper).  The
    model (the reference's ``params``) computes in ``run.compute_dtype``."""

    def prefill_step(model: M.Transformer, batch, cache):
        _check_model(model, run)
        return M.prefill_cache(model, batch["tokens"], cache, frames=batch.get("frames"))

    return prefill_step


def make_decode_step(cfg: ModelConfig, run: RunConfig, *, mla_absorbed: bool = False):
    """The reference's ``make_decode_step``: ``decode_step(model, cache,
    tokens, pos) -> (logits, cache)`` (``models.model.decode_step_cache``)."""

    def decode_step(model: M.Transformer, cache, tokens, pos):
        _check_model(model, run)
        return M.decode_step_cache(model, cache, tokens, pos, mla_absorbed=mla_absorbed)

    return decode_step
