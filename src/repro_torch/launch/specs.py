"""Cell builder: (arch x input shape x mesh) -> abstract arguments and their
placements, the reference's ``launch/specs.py``.

``build_cell`` is the entry point of the dry run (``launch/dryrun.py``).
Nothing here allocates: the arguments are meta tensors (shape and dtype
only; the cache is ``models.model.init_cache`` on the meta device) and the
shardings are ``distributed.sharding.NamedSharding`` trees, whose
``shard_nbytes`` give each rank's bytes.  Train cells carry the sharded
train step (``distributed.train``); prefill cells the sharded prefill into
the contiguous cache and decode cells the sharded decode step over it
(``distributed.serve``), each returning ``(logits, cache)``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch.configs import get_config
from repro_torch.configs.base import (
    ModelConfig,
    RunConfig,
    ShapeConfig,
    SHAPES_BY_NAME,
    shape_applicable,
)
from repro_torch.distributed import sharding as SH
from repro_torch.models import model as M
from repro_torch.models.layers import ParamSpec
from repro_torch.models.sharding_hooks import set_activation_sharder

META = torch.device("meta")


def default_run_config(arch: str, shape: str = "train_4k", **overrides) -> RunConfig:
    """Per-arch runtime defaults, the reference's: the 398B hybrid trains
    with Adafactor and remat ``full`` (AdamW's 8 bytes a parameter of
    moments would not fit)."""
    kw: Dict[str, Any] = dict(arch=arch, shape=shape)
    if arch == "jamba-1.5-large-398b":
        kw["optimizer"] = "adafactor"
        kw["remat_policy"] = "full"
    kw.update(overrides)
    return RunConfig(**kw)


def serve_needs_fsdp(cfg: ModelConfig, mesh) -> bool:
    """bf16 weights must fit a device's memory with TP-only sharding, else FSDP."""
    tp = SH.mesh_axes(mesh)["model"]
    return cfg.num_params() * 2 / tp > 8e9


@dataclass
class Cell:
    arch: str
    shape: ShapeConfig
    fn: Callable
    args: Tuple[Any, ...]
    in_shardings: Tuple[Any, ...]
    out_shardings: Any
    donate_argnums: Tuple[int, ...]
    meta: Dict[str, Any]


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device=META)


def abstract_params(cfg: ModelConfig, dtype=torch.float32) -> dict:
    """``param_specs(cfg)`` as meta tensors of ``dtype``."""
    from repro_torch.models.model import param_specs

    def walk(node):
        if isinstance(node, ParamSpec):
            return _meta(node.shape, dtype)
        return {k: walk(v) for k, v in node.items()}

    return walk(param_specs(cfg))


def _tree_map(fn, tree, *rest):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, tree[k], *(r[k] for r in rest)) for k in tree}
    return fn(tree, *rest)


def state_shardings(run: RunConfig, mesh, pshard: dict, params_abs: dict) -> dict:
    """The train state's shardings: AdamW's moments as their parameters,
    Adafactor's factored moments with the last (``vr``) or second-to-last
    (``vc``) dim dropped, and the full moment ``{"v"}`` of a 1-D parameter
    (the reference's ``_fix_adafactor_1d``); scalars replicated."""
    repl = SH.replicated(mesh)
    if run.optimizer == "adamw":
        opt = {"m": pshard, "v": pshard, "count": repl}
    else:

        def fct(sh, p):
            spec = tuple(sh.spec)
            vr = SH.NamedSharding(mesh, spec[:-1])
            if p.dim() < 2:  # 1-D params keep a full second moment
                return {"v": vr}
            return {"vr": vr, "vc": SH.NamedSharding(mesh, (*spec[:-2], spec[-1]))}

        opt = {"f": _tree_map(fct, pshard, params_abs), "count": repl}
    st = {"params": pshard, "opt": opt, "step": repl}
    if run.grad_compression == "int8_ef":
        st["ef"] = pshard
    return st


def _abstract_opt(run: RunConfig, params_abs: dict) -> dict:
    """Abstract optimizer state matching ``make_optimizer(run.optimizer)``."""
    from repro_torch.optim import make_optimizer

    init, _ = make_optimizer(run.optimizer)
    return init(params_abs)


def build_cell(
    arch: str,
    shape_name: str,
    mesh,
    run: Optional[RunConfig] = None,
    *,
    register_sharder: bool = True,
    cfg: Optional[ModelConfig] = None,
) -> Cell:
    """The cell of ``arch`` (or ``cfg``, e.g. a smoke config) at
    ``shape_name`` on ``mesh`` (a ``DeviceMesh``, or an
    ``sharding.AbstractMesh`` where no step runs)."""
    cfg = cfg or get_config(arch)
    shape = SHAPES_BY_NAME[shape_name]
    ok, why = shape_applicable(cfg, shape)
    if not ok:
        raise ValueError(f"{arch} x {shape_name}: {why}")
    run = run or default_run_config(arch, shape_name)
    fsdp_flag = shape.kind == "train" or serve_needs_fsdp(cfg, mesh)
    if register_sharder:
        set_activation_sharder(
            SH.make_activation_sharder(
                mesh, seq_parallel=run.seq_parallel and shape.kind != "decode"
            ),
            mesh=mesh,
            fsdp=fsdp_flag,
        )
    B, S = shape.global_batch, shape.seq_len
    repl = SH.replicated(mesh)
    meta: Dict[str, Any] = {
        "arch": arch,
        "shape": shape_name,
        "kind": shape.kind,
        "params": cfg.num_params(),
        "mesh": SH.mesh_axes(mesh),
    }

    if shape.kind == "train":
        from repro_torch.distributed.train import make_sharded_train_step

        pshard = SH.param_shardings(cfg, mesh, fsdp=True)
        params_abs = abstract_params(cfg)
        state_abs = {
            "params": params_abs,
            "opt": _abstract_opt(run, params_abs),
            "step": _meta((), torch.int32),
        }
        if run.grad_compression == "int8_ef":
            state_abs["ef"] = _tree_map(lambda p: _meta(p.shape, torch.float32), params_abs)
        state_sh = state_shardings(run, mesh, pshard, params_abs)
        batch_abs = {"tokens": _meta((B, S), torch.int32), "labels": _meta((B, S), torch.int32)}
        batch_sh = dict(SH.batch_shardings(cfg, mesh, B), labels=SH.label_sharding(mesh, B))
        if cfg.is_encoder_decoder:
            batch_abs["frames"] = _meta((B, cfg.encoder_seq_len, cfg.d_model), torch.float32)
        fn = make_sharded_train_step(cfg, run, total_steps=10_000, mesh=mesh)
        metrics_sh = {k: repl for k in ("loss", "aux_loss", "grad_norm", "lr", "param_norm")}
        return Cell(
            arch,
            shape,
            fn,
            (state_abs, batch_abs),
            (state_sh, batch_sh),
            (state_sh, metrics_sh),
            (0,),
            meta,
        )

    # serving cells: params in bf16, no optimizer state
    fsdp = serve_needs_fsdp(cfg, mesh)
    meta["serve_fsdp"] = fsdp
    pshard = SH.param_shardings(cfg, mesh, fsdp=fsdp)
    params_abs = abstract_params(cfg, torch.bfloat16)
    clen = M.cache_length(cfg, S)
    cache_abs = M.init_cache(cfg, B, clen, device=META)
    cache_sh = SH.cache_shardings(cfg, mesh, shape, B, clen)
    meta["cache_len"] = clen
    logits_sh = SH.NamedSharding(mesh, (None, None, "model"))

    if shape.kind == "prefill":
        from repro_torch.distributed.serve import make_sharded_prefill

        batch_abs = {"tokens": _meta((B, S), torch.int32)}
        if cfg.is_encoder_decoder:
            batch_abs["frames"] = _meta((B, cfg.encoder_seq_len, cfg.d_model), torch.float32)
        batch_sh = SH.batch_shardings(cfg, mesh, B)
        fn = make_sharded_prefill(cfg, mesh)
        return Cell(
            arch,
            shape,
            fn,
            (params_abs, batch_abs, cache_abs),
            (pshard, batch_sh, cache_sh),
            (logits_sh, cache_sh),
            (2,),
            meta,
        )

    from repro_torch.distributed.serve import make_sharded_decode

    tok_abs = _meta((B, 1), torch.int32)
    pos_abs = _meta((), torch.int32)
    tok_sh = SH.batch_shardings(cfg, mesh, B)["tokens"]
    return Cell(
        arch,
        shape,
        make_sharded_decode(cfg, mesh),
        (params_abs, cache_abs, tok_abs, pos_abs),
        (pshard, cache_sh, tok_sh, repl),
        (logits_sh, cache_sh),
        (1,),
        meta,
    )


def tree_shard_nbytes(abstract, shardings) -> int:
    """One rank's bytes of an abstract tree under its sharding tree."""
    if isinstance(abstract, dict):
        return sum(tree_shard_nbytes(abstract[k], shardings[k]) for k in abstract)
    return shardings.shard_nbytes(tuple(abstract.shape), abstract.dtype)
