"""Logical-axis -> mesh-axis sharding rules (MaxText-style), per arch x
shape: the reference's ``distributed/sharding.py`` over a ``DeviceMesh``.

Params carry *logical* axis names (``ParamSpec.axes``); here they resolve
to mesh axes.  The defaults are the reference's:
  - TP over ``model`` for heads / mlp / vocab / experts,
  - FSDP (ZeRO-3) over ``data`` for the d_model dim of every weight at
    training,
  - DP over ``("pod", "data")`` for batch,
  - the decode KV cache's sequence dim over ``model`` (long_500k:
    ``("data", "model")``).
Any axis whose dim does not divide its mesh axes falls back to
replication (e.g. whisper's 8 heads on a 16-way ``model`` axis), and no
mesh axis is used twice in one spec.

A spec is the reference's ``PartitionSpec`` as a tuple: per tensor dim
``None``, one mesh-axis name, or a tuple of names.  ``NamedSharding``
pairs it with a mesh and turns it into DTensor placements: ``Shard(dim)``
on each mesh dim that a tensor dim names, ``Replicate()`` on the others
(a tensor dim named by several mesh axes is split over them major to
minor, as the reference's).  Any object with ``mesh_dim_names`` and
``shape`` serves as the mesh (a ``DeviceMesh``, or an ``AbstractMesh`` of
shapes only, which needs no process group).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import torch
from torch.distributed.tensor import Replicate, Shard

from repro_torch.configs.base import ModelConfig, ShapeConfig

#: the reference's ``PartitionSpec``: per tensor dim None | axis | (axes, ...)
Spec = Tuple[Any, ...]


@dataclass(frozen=True)
class AbstractMesh:
    """A mesh of shapes only (the reference's ``jax.sharding.AbstractMesh``)."""

    shape: Tuple[int, ...]
    mesh_dim_names: Tuple[str, ...]


def mesh_axes(mesh) -> Dict[str, int]:
    """``{axis name: size}`` of a ``DeviceMesh`` or an ``AbstractMesh``."""
    return dict(zip(mesh.mesh_dim_names, tuple(mesh.shape)))


def dp_axes(mesh) -> Tuple[str, ...]:
    return ("pod", "data") if "pod" in mesh.mesh_dim_names else ("data",)


def axis_size(mesh, axes) -> int:
    if axes is None:
        return 1
    if isinstance(axes, str):
        axes = (axes,)
    sizes = mesh_axes(mesh)
    return math.prod(sizes[a] for a in axes)


def param_rules(cfg: ModelConfig, mesh, *, fsdp: bool) -> Dict[str, Any]:
    """Logical-axis resolution for parameters."""
    return {
        "vocab": "model",
        "embed": "data" if fsdp else None,
        "embed_table": None,  # gather-friendly: the table shards over vocab only
        "heads": "model",
        "kv_heads": "model",
        "head_dim": None,
        "mlp": "model",
        "expert": "model",
        "expert_mlp": "data" if fsdp else None,
    }


def _divisible(dim: int, mesh, axes) -> bool:
    return dim % axis_size(mesh, axes) == 0


def spec_for_param(
    spec_axes: Tuple[Optional[str], ...], shape: Tuple[int, ...], rules: Dict[str, Any], mesh
) -> Spec:
    """Resolve one param's logical axes, degrading to replication when a dim
    does not divide the mesh axis (and never using one mesh axis twice)."""
    used: set = set()
    out = []
    for dim, ax in zip(shape, spec_axes):
        m = rules.get(ax) if ax is not None else None
        if m is None:
            out.append(None)
            continue
        maxes = (m,) if isinstance(m, str) else tuple(m)
        if any(a in used for a in maxes) or not _divisible(dim, mesh, maxes):
            out.append(None)
            continue
        used.update(maxes)
        out.append(m)
    return tuple(out)


def placements(spec: Spec, mesh) -> tuple:
    """DTensor placements of ``spec`` on ``mesh``, one per mesh dim."""
    where: Dict[str, int] = {}
    for dim, m in enumerate(spec):
        for a in (m,) if isinstance(m, str) else (m or ()):
            where[a] = dim
    return tuple(
        Shard(where[name]) if name in where else Replicate() for name in mesh.mesh_dim_names
    )


@dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh (the reference's ``NamedSharding``)."""

    mesh: Any
    spec: Spec

    @property
    def placements(self) -> tuple:
        return placements(self.spec, self.mesh)

    def shard_shape(self, shape: Tuple[int, ...]) -> Tuple[int, ...]:
        """One rank's block of a tensor of ``shape`` (the rules keep every
        sharded dim divisible; an uneven dim takes ``ceil``, DTensor's
        largest chunk)."""
        spec = tuple(self.spec) + (None,) * (len(shape) - len(self.spec))
        return tuple(-(-d // axis_size(self.mesh, m)) for d, m in zip(shape, spec))

    def shard_nbytes(self, shape: Tuple[int, ...], dtype: torch.dtype) -> int:
        return math.prod(self.shard_shape(shape)) * torch.empty((), dtype=dtype).element_size()


def param_shardings(cfg: ModelConfig, mesh, *, fsdp: bool) -> dict:
    """``NamedSharding`` tree matching ``models.model.param_specs(cfg)``."""
    from repro_torch.models.layers import ParamSpec
    from repro_torch.models.model import param_specs

    rules = param_rules(cfg, mesh, fsdp=fsdp)

    def walk(node):
        if isinstance(node, ParamSpec):
            return NamedSharding(mesh, spec_for_param(node.axes, node.shape, rules, mesh))
        return {k: walk(v) for k, v in node.items()}

    return walk(param_specs(cfg))


# ---------------------------------------------------------------------------
# Activation constraints (registered through models.sharding_hooks)
# ---------------------------------------------------------------------------

#: a dim the constraint leaves where it is (the reference's ``P.UNCONSTRAINED``)
UNCONSTRAINED = "unconstrained"


def activation_spec(mesh, shape: Tuple[int, ...], kind: str, *, seq_parallel: bool = False):
    """The reference's constraint for an activation of ``shape`` and
    ``kind``, or None where it applies none (an unknown kind, or a batch
    that the data-parallel axes do not divide)."""
    dp = dp_axes(mesh)
    tp = mesh_axes(mesh)["model"]
    ndim = len(shape)
    U = UNCONSTRAINED
    if kind == "resid":
        sp = "model" if (seq_parallel and ndim >= 3 and shape[1] % tp == 0) else None
        spec = (dp, sp, *([None] * (ndim - 2)))
    elif kind == "logits":
        spec = (dp, None, "model")
    elif kind == "moe_buf":  # [groups, experts, capacity, d]
        spec = (dp, "model", None, None)
    elif kind == "moe_tokens":  # [groups, tokens, d]
        spec = (dp, None, None)
    elif kind == "batch0":  # pin dim 0 to dp; the rest stays free
        spec = (dp, *([U] * (ndim - 1)))
    elif kind == "attn_io":  # batch over dp, sequence whole, heads free
        spec = (dp, None, *([U] * (ndim - 2)))
    else:
        return None
    if shape[0] % axis_size(mesh, dp) != 0:
        return None  # e.g. batch-1 long-context cells
    return spec


def _constrained(x, spec: Spec, mesh) -> tuple:
    """Placements of DTensor ``x`` under ``spec``: named dims as
    ``placements``; a mesh dim that ``spec`` leaves free keeps x's placement
    where that shards an unconstrained dim, else replicates."""
    fixed = placements(tuple(None if m == UNCONSTRAINED else m for m in spec), mesh)
    named = set()
    for m in spec:
        if m not in (None, UNCONSTRAINED):
            named.update((m,) if isinstance(m, str) else m)
    out = []
    for name, want, have in zip(mesh.mesh_dim_names, fixed, x.placements):
        if name not in named and have.is_shard() and spec[have.dim] == UNCONSTRAINED:
            out.append(have)
        else:
            out.append(want)
    return tuple(out)


def make_activation_sharder(mesh, *, seq_parallel: bool = False):
    """``shard(x, kind)``: a DTensor ``x`` redistributed to the reference's
    constraint for ``kind`` (``activation_spec``); plain tensors (a rank's
    own block, or a mesh-free run) pass through.  ``seq_parallel``:
    Megatron-SP, the residual stream between blocks sharded over
    (``model`` x sequence)."""
    from torch.distributed.tensor import DTensor

    def shard(x, kind: str):
        if not isinstance(x, DTensor):
            return x
        spec = activation_spec(mesh, tuple(x.shape), kind, seq_parallel=seq_parallel)
        if spec is None:
            return x
        want = _constrained(x, spec, mesh)
        return x if tuple(x.placements) == want else x.redistribute(x.device_mesh, want)

    return shard


# ---------------------------------------------------------------------------
# Batch / cache shardings
# ---------------------------------------------------------------------------


def batch_shardings(cfg: ModelConfig, mesh, batch_size: int) -> dict:
    dp = dp_axes(mesh)
    if batch_size % axis_size(mesh, dp) == 0:
        bspec = dp
    else:
        bspec = "data" if batch_size % mesh_axes(mesh)["data"] == 0 else None
    out = {"tokens": NamedSharding(mesh, (bspec, None))}
    if cfg.is_encoder_decoder:
        out["frames"] = NamedSharding(mesh, (bspec, None, None))
    return out


def label_sharding(mesh, batch_size: int) -> NamedSharding:
    dp = dp_axes(mesh)
    bspec = dp if batch_size % axis_size(mesh, dp) == 0 else None
    return NamedSharding(mesh, (bspec, None))


def cache_pspecs(cfg: ModelConfig, mesh, shape: ShapeConfig, batch_size: int, cache_len: int):
    """Spec tree matching the reference's ``init_cache(cfg, ...)`` tree (an
    MLA cache's ``c_kv`` and ``k_pe``; ``cache_shardings`` lays the port's
    one latent row out as them)."""
    dp = dp_axes(mesh)
    b = dp if batch_size % axis_size(mesh, dp) == 0 else None
    long_ctx = shape.name == "long_500k"
    seq_ax: Any = ("data", "model") if long_ctx else "model"
    if not _divisible(cache_len, mesh, seq_ax):
        seq_ax = "model" if _divisible(cache_len, mesh, "model") else None
    heads_ok = cfg.ssm_state_dim and _divisible(cfg.ssm_num_heads, mesh, "model")
    h_ax = "model" if heads_ok else None
    g_ax = None  # the cache's kv heads stay replicated; the sequence carries 'model'

    def gqa(leading=()):
        ld = tuple(None for _ in leading)
        return {
            "k": (*ld, b, seq_ax, g_ax, None),
            "v": (*ld, b, seq_ax, g_ax, None),
            "pos": (*ld, b, seq_ax),
        }

    def ssm_tree(leading=()):
        ld = tuple(None for _ in leading)
        conv = cfg.d_inner + 2 * cfg.ssm_num_groups * cfg.ssm_state_dim
        conv_ax = "model" if _divisible(conv, mesh, "model") else None
        return {"ssm": (*ld, b, h_ax, None, None), "conv": (*ld, b, None, conv_ax)}

    if cfg.family == "hybrid":
        return {"attn": gqa((0,)), "ssm": ssm_tree((0, 1))}
    if cfg.family == "ssm":
        return ssm_tree((0,))
    if cfg.is_encoder_decoder:
        tree = gqa((0,))
        tree["ck"] = (None, b, None, None, None)
        tree["cv"] = (None, b, None, None, None)
        return tree
    if cfg.use_mla:
        return {
            "c_kv": (None, b, seq_ax, None),
            "k_pe": (None, b, seq_ax, None),
            "pos": (None, b, seq_ax),
        }
    return gqa((0,))


def cache_shardings(cfg: ModelConfig, mesh, shape: ShapeConfig, batch_size: int, cache_len: int):
    """``NamedSharding`` tree matching ``models.model.init_cache``: the
    reference's specs, an MLA cache's ``latent`` row laid out as its
    ``c_kv`` and ``k_pe`` (the same spec: each rank's bytes are theirs)."""

    def walk(node):
        if isinstance(node, tuple):
            return NamedSharding(mesh, node)
        return {k: walk(v) for k, v in node.items()}

    specs = cache_pspecs(cfg, mesh, shape, batch_size, cache_len)
    if cfg.use_mla:
        assert specs["c_kv"] == specs["k_pe"]
        specs = {"latent": specs["c_kv"], "pos": specs["pos"]}
    return walk(specs)


def replicated(mesh) -> NamedSharding:
    return NamedSharding(mesh, ())
