"""Collective wire bytes of a step: the counterpart of the reference's
``analysis/hlo.py``.

The reference parses the compiled XLA HLO text, multiplying each
computation's collectives by its enclosing ``while`` trip counts.  Nothing
in PyTorch emits HLO, so the port counts the collectives a step issues as
it runs: ``CollectiveCounter`` is a ``CommDebugMode`` (it sees ``c10d``
calls, the functional collectives and DTensor's redistributions alike)
that also records each call's kind, result dtype and result shape.  An
eager step runs its layer loop in Python, so every layer's collectives are
recorded where they happen: no trip-count correction is needed.

``stats()`` returns the reference's keys with its ring model (documented
in EXPERIMENTS.md, Roofline): the bytes of each kind's results, where an
all-reduce moves 2x its payload on the wire and all-gather, reduce-scatter,
all-to-all and collective-permute 1x; ``count`` the calls, ``calls`` the
calls per kind.  The dry run (``launch/dryrun.py``) counts one step of a
cell under fake tensors and a fake process group this way.
"""

from __future__ import annotations

import math
import re
from collections import Counter
from typing import Dict, List, Optional, Tuple

import torch
from torch.distributed.tensor.debug import CommDebugMode

_DTYPE_BYTES = dict(f64=8, s64=8, u64=8, c64=8, f32=4, s32=4, u32=4, f16=2, bf16=2, s16=2)
_DTYPE_BYTES.update(u16=2, s8=1, u8=1, pred=1, f8e4m3fn=1, f8e5m2=1)
_SHAPE_RE = re.compile(r"(\w+)\[([\d,]*)\]")

#: the HLO name of each torch dtype a collective carries
HLO_DTYPES = {
    torch.float64: "f64",
    torch.int64: "s64",
    torch.float32: "f32",
    torch.int32: "s32",
    torch.float16: "f16",
    torch.bfloat16: "bf16",
    torch.int16: "s16",
    torch.int8: "s8",
    torch.uint8: "u8",
    torch.bool: "pred",
}

KINDS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all", "collective-permute")


def shape_bytes(shape_str: str) -> int:
    """Bytes of an HLO shape string, e.g. ``f32[1024]`` or ``(f32[4], bf16[8])``."""
    total = 0
    for dt, dims in _SHAPE_RE.findall(shape_str):
        if dt not in _DTYPE_BYTES:
            continue
        n = 1
        for d in dims.split(","):
            if d:
                n *= int(d)
        total += n * _DTYPE_BYTES[dt]
    return total


def _flat(ts) -> List[torch.Tensor]:
    if isinstance(ts, torch.Tensor):
        return [ts]
    out: List[torch.Tensor] = []
    for t in ts:
        out += _flat(t)
    return out


def _record(name: str, args, out) -> List[Tuple[str, torch.Tensor, tuple]]:
    """``[(kind, a tensor of the result's dtype, result shape)]`` of one
    collective op: ``c10d::*`` ops take their results as the first argument
    (in place), the functional ones return them."""
    op = name.split("::")[-1]
    res = _flat(args[0]) if name.startswith("c10d::") else _flat(out)
    if "allreduce" in op or "all_reduce" in op:
        return [("all-reduce", t, tuple(t.shape)) for t in res]
    if "allgather" in op or "all_gather" in op:
        if op in ("allgather_", "allgather_coalesced_"):  # a list of blocks per input
            t = res[0]
            return [("all-gather", t, (t.shape[0] * len(res), *t.shape[1:]))]
        return [("all-gather", t, tuple(t.shape)) for t in res]
    if "reduce_scatter" in op:
        return [("reduce-scatter", t, tuple(t.shape)) for t in res]
    if "alltoall" in op or "all_to_all" in op:
        t = res[0]
        return [("all-to-all", t, (sum(r.shape[0] for r in res), *t.shape[1:]))]
    if op in ("send", "recv_"):
        return [("collective-permute", t, tuple(t.shape)) for t in res]
    return []


def _group_name(args) -> Optional[str]:
    """The process group's name of one collective op: the functional ops
    take it as their last string (after the reduce op's name), the ``c10d``
    ones as a boxed ``ProcessGroup``."""
    import torch.distributed as dist

    for a in reversed(args):
        if isinstance(a, str):
            return a
        if isinstance(a, torch.ScriptObject) and "ProcessGroup" in str(a._type()):
            return dist.ProcessGroup.unbox(a).group_name
    return None


def group_ranks(name: Optional[str]) -> Optional[Tuple[int, ...]]:
    """The global ranks of the process group named ``name`` (``groups``'
    entries), or None.  Compare groups by their ranks, not by name: two
    ``DeviceMesh``es of one layout compare equal, and DTensor's cached
    sharding plans may run a later mesh's collectives over the earlier
    mesh's groups of the same ranks."""
    import torch.distributed as dist
    from torch.distributed.distributed_c10d import _resolve_process_group

    if name is None:
        return None
    return tuple(dist.get_process_group_ranks(_resolve_process_group(name)))


class CollectiveCounter(CommDebugMode):
    """``CommDebugMode`` that also keeps, per collective call, its kind
    (the reference's HLO names), result dtype and result shape
    (``records``: ``(kind, hlo dtype, shape)``) and, beside each record, the
    name of the process group it ran over (``groups``; ``group_ranks``
    gives its ranks)."""

    def __init__(self):
        super().__init__()
        self.records: List[Tuple[str, str, tuple]] = []
        self.groups: List[Optional[str]] = []

    def __enter__(self):
        super().__enter__()
        # no per-module tables here: ``CommDebugMode``'s module tracker keeps
        # one forward hook a module name and leaves those of modules that
        # share a name on them after it exits, where they break the next
        # counter's run (a counted prefill, then a counted decode step)
        tracker = getattr(self, "advanced_module_tracker", None)
        if tracker is not None:
            tracker.__exit__()
        return self

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = super().__torch_dispatch__(func, types, args, kwargs)
        name = str(func._schema.name) if hasattr(func, "_schema") else str(func)
        if name.startswith(("c10d::", "_c10d_functional::", "c10d_functional::")):
            for kind, t, shape in _record(name, args, out):
                self.records.append((kind, HLO_DTYPES.get(t.dtype, str(t.dtype)), tuple(shape)))
                self.groups.append(_group_name(args))
        return out

    def stats(self) -> Dict[str, float]:
        return collective_stats(self.records)


def collective_stats(records) -> Dict[str, float]:
    """The reference's ``collective_wire_bytes`` keys from ``records``."""
    out: Dict[str, float] = {k: 0 for k in KINDS}
    calls = Counter()
    for kind, dtype, shape in records:
        out[kind] += math.prod(shape) * _DTYPE_BYTES.get(dtype, 0)
        calls[kind] += 1
    out["count"] = sum(calls.values())
    out["calls"] = dict(calls)
    out["wire_bytes"] = (
        2 * out["all-reduce"]
        + out["all-gather"]
        + out["reduce-scatter"]
        + out["all-to-all"]
        + out["collective-permute"]
    )
    return out

