"""Carry the reference package's inputs and state over to the port.

The reference is a JAX package; nothing here imports it.  Its objects come
in as plain Python and numpy values (``dataclasses.asdict`` of its
``SimParams`` and ``ModelConfig``, numpy arrays of its trace columns, state
fields and parameter tree), the way a weight converter takes a checkpoint's
arrays.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.address import MemoryGeometry
from repro_torch.core.simulator import SimParams, Trace
from repro_torch.core.state import SimState
from repro_torch.core.traffic import EventSchedule
from repro_torch.models.model import Transformer, empty_model

#: the reference's arbiter backends, both of which the Hopper kernel replaces
_REFERENCE_ARBITERS = ("jax", "pallas")


def params_from_reference(d: Mapping) -> SimParams:
    """A port ``SimParams`` from ``dataclasses.asdict`` of a reference
    ``SimParams`` (``geom`` nested as a dict).  Every field carries over
    (``stages``, ``collect``, ``inflight_override``, ``time_skip`` and the
    rest); the reference's arbiter backends map to the port's kernel."""
    fields = dict(d)
    fields["geom"] = MemoryGeometry(**fields["geom"])
    if fields.get("arbiter") in _REFERENCE_ARBITERS:
        fields["arbiter"] = SimParams.arbiter
    if fields.get("stages") is not None:
        fields["stages"] = tuple(fields["stages"])
    return SimParams(**fields)


def trace_from_arrays(
    is_write, burst, addr, start: Optional[np.ndarray] = None, prio: Optional[np.ndarray] = None
) -> Trace:
    """A port ``Trace`` from the reference trace's columns (any array-likes)."""

    def col(a):
        return None if a is None else np.asarray(a, np.int32)

    return Trace(col(is_write), col(burst), col(addr), col(start), col(prio))


def schedule_from_arrays(is_write, burst, addr, start, prio, cls, deadline) -> EventSchedule:
    """A port ``EventSchedule`` from the reference schedule's columns, in
    their storage dtypes (int8 direction, burst, prio and class; int32
    addresses, starts and deadlines)."""
    i8, i32 = np.int8, np.int32
    cols = (is_write, burst, addr, start, prio, cls, deadline)
    return EventSchedule(
        *(np.asarray(a, t) for a, t in zip(cols, (i8, i8, i32, i32, i8, i8, i32)))
    )


def state_from_numpy(fields: Mapping[str, np.ndarray], device) -> SimState:
    """A ``B = 1`` :class:`SimState` from one reference state's fields (numpy
    arrays by field name, e.g. from the reference's set-up of either pipeline
    or its state after k cycles).  Every field must be present with its
    storage dtype, and no other."""
    names = [f.name for f in dataclasses.fields(SimState)]
    missing = [n for n in names if n not in fields]
    if missing:
        raise KeyError(f"state fields missing: {missing}")
    extra = [k for k in fields if k not in names]
    if extra:
        raise ValueError(f"fields the port's state does not have: {extra}")
    return SimState(**{n: torch.from_numpy(np.array(fields[n])[None]).to(device) for n in names})


@torch.no_grad()
def model_from_reference(
    cfg: ModelConfig,
    tree: Mapping,
    *,
    device=None,
    compute_dtype: torch.dtype = torch.bfloat16,
    kv_dtype: torch.dtype = torch.bfloat16,
    impl: str = "kernel",
) -> Transformer:
    """A port :class:`Transformer` holding the reference's parameters.

    ``tree`` is the reference's parameter tree with numpy leaves (its
    ``init_params`` output through ``np.asarray``): nested dicts, the layer
    stack's leaves stacked ``[L, ...]``, layouts as in the reference
    (``wq [d, h, k]``, ``wo [h, k, d]``, ``embed [Vp, d]``, ``lm_head [d, Vp]``;
    an MoE layer's ``moe`` leaves ``router [d, E]``, ``w_gate``/``w_up
    [E, d, f]``, ``w_down [E, f, d]`` and the shared experts' ``ws_gate``/
    ``ws_up [d, n f]``, ``ws_down [n f, d]``; QK-norm's ``q_norm``/``k_norm
    [k]``; an MLA layer's ``attn`` leaves ``wq [d, h, dn + dr]``, ``w_dkv
    [d, r]``, ``w_kpe [d, dr]``, ``kv_norm [r]``, ``w_uk [r, h, dn]``,
    ``w_uv [r, h, dv]``, ``wo [h, dv, d]``; an SSM layer's ``mixer_norm``
    and ``ssm`` leaves ``w_z``/``w_x [d, d_inner]``, ``w_B``/``w_C [d, g n]``,
    ``w_dt [d, h]``, ``conv_x``/``conv_B``/``conv_C [W, ...]``, ``A_log``,
    ``D``, ``dt_bias [h]``, ``norm [d_inner]``, ``out_proj [d_inner, d]``).
    A config that ties its embeddings (mamba2) has no ``lm_head`` leaf.
    Weight matrices are cast to ``compute_dtype`` once here; norm scales and
    biases stay float32.  ``device`` defaults to CUDA."""
    model = empty_model(
        cfg, device=device, compute_dtype=compute_dtype, kv_dtype=kv_dtype, impl=impl
    )
    return model.load_tree(tree)


@torch.no_grad()
def load_train_state(state, tree: Mapping) -> None:
    """Copy a train state laid out as the reference's (``{"params", "opt",
    "step"[, "ef"]}``, numpy or tensor leaves: a reference checkpoint, or
    ``np.asarray`` of the reference's ``init_train_state``) into the port's
    ``train.step.TrainState``, in place: parameters (so also the model's
    views of them), the optimizer's moments and count (AdamW or Adafactor),
    the step and the error-feedback buffers."""
    from repro_torch.tree import leaves_with_path

    ours = list(leaves_with_path(state.tree()))
    theirs = list(leaves_with_path(tree))
    if [p for p, _ in ours] != [p for p, _ in theirs]:
        raise ValueError(
            "the train states differ in structure: "
            f"{sorted(set(p for p, _ in ours) ^ set(p for p, _ in theirs))[:6]}"
        )
    for (path, dst), (_, src) in zip(ours, theirs):
        src = src if torch.is_tensor(src) else torch.from_numpy(np.array(src))
        if tuple(src.shape) != tuple(dst.shape):
            raise ValueError(f"{path}: shape {tuple(src.shape)}, expected {tuple(dst.shape)}")
        dst.copy_(src)


def train_state_to_reference(state) -> dict:
    """The port's train state as the reference's tree of numpy arrays."""
    from repro_torch.checkpoint.manager import to_host

    return to_host(state.tree())
