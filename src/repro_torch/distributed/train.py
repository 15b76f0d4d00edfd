"""The sharded train step: the port's train step on DTensors over a
``DeviceMesh`` (the reference's jitted step under its ``NamedSharding``s).

``shard_train_state`` lays a ``train.step.TrainState`` out by the rules
(``sharding.param_shardings`` with FSDP: ZeRO-3 over ``data``, TP over
``model``; the optimizer state as ``launch.specs.state_shardings``): every
stacked leaf becomes a DTensor and each layer's parameter a DTensor view of
its slice, its ``.grad`` a view of the same slice of the zeroed gradient
tree, as ``bind_stacked`` lays out the single-device state.
``make_sharded_train_step`` registers the activation sharder
(``models.sharding_hooks``), lays the batch out by ``batch_shardings`` and
runs ``train.step.make_train_step``'s step under DTensor's implicit
replication (plain tensors the step makes, positions and masks, count as
replicated).  DTensor's sharding propagation places the collectives: the
FSDP all-gathers of the weights at use, the TP reductions after the row-
split products, the gradients' reduce-scatters.  Two computations run as
each rank's code instead (``local_map``): attention on each rank's batch
rows and heads (``models.attention._flash``), and the vocab-parallel
embedding lookup (``models.model._embed_lookup_sharded``: DTensor has no
strategy for its deterministic backward).  The metrics come back as plain
tensors, whole on every rank.
"""

from __future__ import annotations

from typing import Dict

import torch
from torch.distributed.tensor import DTensor, distribute_tensor
from torch.distributed.tensor.experimental import implicit_replication

from repro_torch.configs.base import ModelConfig, RunConfig
from repro_torch.distributed import sharding as SH
from repro_torch.models import model as M
from repro_torch.models.layers import iter_specs
from repro_torch.models.sharding_hooks import set_activation_sharder


def _owners(model: M.Transformer, keys) -> list:
    """``(index, module, path)`` for every slice of the stacked leaf at
    ``keys``: the parameter is ``path`` under ``module`` (the order of
    ``Transformer.stacked``)."""
    if keys[0] == "encoder":
        return [((i,), m, keys[2:]) for i, m in enumerate(model.encoder.layers)]
    out = []
    for i, layer in enumerate(model.layers):
        sub = getattr(layer, keys[1])
        if isinstance(sub, torch.nn.ModuleList):
            out += [((i, j), m, keys[2:]) for j, m in enumerate(sub)]
        else:
            out.append(((i,), layer, keys[1:]))
    return out


def _put(module, path, value: torch.Tensor, grad: torch.Tensor) -> None:
    for k in path[:-1]:
        module = getattr(module, k)
    p = torch.nn.Parameter(value, requires_grad=True)
    p.grad = grad
    module._parameters[path[-1]] = p


def _get(tree, keys):
    for k in keys:
        tree = tree[k]
    return tree


def _set(tree, keys, value) -> None:
    for k in keys[:-1]:
        tree = tree.setdefault(k, {})
    tree[keys[-1]] = value


def _distribute(tree, shardings):
    if isinstance(tree, dict):
        return {k: _distribute(tree[k], shardings[k]) for k in tree}
    if tree.dim() == 0:  # scalars (counts) stay plain: alike on every rank
        return tree
    return distribute_tensor(tree, shardings.mesh, shardings.placements)


@torch.no_grad()
def shard_train_state(state, run: RunConfig, mesh, *, fsdp: bool = True):
    """``state`` (every rank holding the same whole state) laid out over
    ``mesh``, in place; returns it.  ``fsdp=False``: the weights' d_model
    dim stays whole (a serving layout)."""
    from repro_torch.launch.specs import state_shardings

    model, cfg = state.model, state.model.cfg
    pshard = SH.param_shardings(cfg, mesh, fsdp=fsdp)
    params, grads = {}, {}
    for keys, _ in iter_specs(M.param_specs(cfg)):
        sh = _get(pshard, keys)
        leaf = distribute_tensor(_get(state.params, keys).detach(), mesh, sh.placements)
        grad = torch.zeros_like(leaf)
        if M.is_stacked(keys):
            for idx, module, path in _owners(model, keys):
                _put(module, path, leaf[idx], grad[idx])
        else:
            _put(model, keys, leaf, grad)
        _set(params, keys, leaf)
        _set(grads, keys, grad)
    sh = state_shardings(run, mesh, pshard, state.params)
    state.params, state.grads = params, grads
    state.opt = _distribute(state.opt, sh["opt"])
    if state.ef is not None:
        state.ef = _distribute(state.ef, pshard)
    return state


def shard_batch(cfg: ModelConfig, mesh, batch: Dict[str, torch.Tensor]) -> Dict[str, DTensor]:
    """The batch laid out by ``batch_shardings`` / ``label_sharding``."""
    B = batch["tokens"].shape[0]
    sh = dict(SH.batch_shardings(cfg, mesh, B), labels=SH.label_sharding(mesh, B))
    out = {}
    for k, v in batch.items():
        v = v if torch.is_tensor(v) else torch.as_tensor(v)
        out[k] = v if isinstance(v, DTensor) else distribute_tensor(v, mesh, sh[k].placements)
    return out


def _plain(x):
    return x.full_tensor() if isinstance(x, DTensor) else x


def make_sharded_train_step(cfg: ModelConfig, run: RunConfig, total_steps: int, mesh):
    """``step(state, batch) -> (state, metrics)`` on a state laid out by
    ``shard_train_state`` and a batch of whole tensors (or DTensors)."""
    from repro_torch.train.step import make_train_step

    inner = make_train_step(cfg, run, total_steps)
    sharder = SH.make_activation_sharder(mesh, seq_parallel=run.seq_parallel)

    def step(state, batch):
        set_activation_sharder(sharder, mesh=mesh, fsdp=True)
        try:
            with implicit_replication():
                state, metrics = inner(state, shard_batch(cfg, mesh, batch))
        finally:
            set_activation_sharder(None)
        return state, {k: _plain(v) for k, v in metrics.items()}

    return step
