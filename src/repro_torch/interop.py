"""Carry the reference package's inputs and state over to the port.

The reference is a JAX package; nothing here imports it.  Its objects come
in as plain Python and numpy values (``dataclasses.asdict`` of its
``SimParams``, numpy arrays of its trace columns and state fields), the way a
weight converter takes a checkpoint's arrays.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping, Optional

import numpy as np
import torch

from repro_torch.core.address import MemoryGeometry
from repro_torch.core.simulator import SimParams, Trace
from repro_torch.core.state import SimState

#: the reference's arbiter backends, both of which the Hopper kernel replaces
_REFERENCE_ARBITERS = ("jax", "pallas")


def params_from_reference(d: Mapping) -> SimParams:
    """A port ``SimParams`` from ``dataclasses.asdict`` of a reference
    ``SimParams`` (``geom`` nested as a dict)."""
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


def state_from_numpy(fields: Mapping[str, np.ndarray], device) -> SimState:
    """A ``B = 1`` :class:`SimState` from one reference state's fields (numpy
    arrays by field name, e.g. from the reference's dense set-up or its state
    after k cycles).  Every port field must be present with its storage
    dtype; extra reference fields are accepted only when empty (the schedule
    pipeline's tables, zero-size on the dense path)."""
    names = [f.name for f in dataclasses.fields(SimState)]
    missing = [n for n in names if n not in fields]
    if missing:
        raise KeyError(f"state fields missing: {missing}")
    extra = [k for k in fields if k not in names and np.asarray(fields[k]).size]
    if extra:
        raise ValueError(f"non-empty fields the dense port does not carry: {extra}")
    return SimState(**{n: torch.from_numpy(np.array(fields[n])[None]).to(device) for n in names})
