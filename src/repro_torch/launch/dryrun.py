"""Multi-pod dry run: build every (architecture x input shape) cell on the
production meshes as one rank of a fake process group, and record each
rank's bytes and the collectives of one step.  The reference's
``launch/dryrun.py`` compiles on 512 forced host devices; here the mesh is
a ``DeviceMesh`` over a fake process group (``torch.testing._internal.
distributed.fake_pg``: its collectives return at once and move nothing)
at world 256 (``(16, 16)``) or 512 (``(2, 16, 16)``), and rank 0 stands
for every rank: the rules give each rank a block of the same shape.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --all
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch stablelm-1.6b \\
        --shape train_4k --multi-pod

Per cell, into ``<out>/<mesh>/<arch>__<shape>.json`` (``experiments/``,
which ``.gitignore`` lists):
  * ``bytes_per_rank``: the exact bytes of one rank's parameters, optimizer
    state, batch and cache, from the placements (``NamedSharding.shard_shape``);
  * ``step``: one step of the cell run under ``FakeTensorMode`` (shapes
    only, nothing computed or allocated) inside ``analysis.collectives.
    CollectiveCounter``: the collectives' kinds, calls and bytes with the
    reference's ring model, and each call's kind, dtype and shape beside
    the ranks of the group it ran over.  Peak activation memory is not
    reported: the reference reads XLA's ``temp_size``; ``torch.distributed._tools.
    mem_tracker.MemTracker`` under fake tensors counted 217 GB a rank for
    stablelm-1.6b's train_4k step, which the rank's local shapes do not
    account for, so no estimate is kept.  Train cells run the sharded train step
    (``distributed.train``), prefill and decode cells the sharded serving
    steps (``distributed.serve``) on DTensor parameters and a contiguous
    cache (``models.model.init_cache``, fake) laid out by
    ``cache_shardings``: the prefill writes the whole prompt into it, the
    decode step one token a sequence at the context's last position.  A
    step that cannot run records its error and traceback, as the
    reference's failing cells do.
The mesh's device type is the CPU's: under fake tensors nothing reaches a
device.
"""

from __future__ import annotations

import argparse
import json
import time
import traceback
from pathlib import Path
from typing import Optional

import torch
import torch.distributed as dist

from repro_torch.configs import get_config, list_archs, smoke
from repro_torch.configs.base import SHAPES, SHAPES_BY_NAME, shape_applicable
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.specs import build_cell, default_run_config, tree_shard_nbytes
from repro_torch.models.sharding_hooks import set_activation_sharder


def fake_world(world: int) -> None:
    """Make the default process group a fake one of ``world`` ranks, this
    process rank 0 (replacing any fake group of another size)."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        if dist.get_world_size() == world and dist.get_backend() == "fake":
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world)


def _step(cell, cfg, run, mesh) -> dict:
    """One step of ``cell`` under fake tensors: its collectives, each call's
    ``(kind, dtype, shape)`` beside the ranks of the group it ran over
    (``records``), and each mesh dim's group's ranks."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.analysis.collectives import CollectiveCounter, group_ranks
    from repro_torch.distributed.train import shard_train_state
    from repro_torch.models import moe

    B, S = cell.shape.global_batch, cell.shape.seq_len
    t0 = time.time()
    # a fake tensor belongs to its mode: the MoE's cached permutation is
    # made anew in the step and not kept past it
    moe._fractal_perm.cache_clear()
    try:
        with FakeTensorMode(allow_non_fake_inputs=True):
            if cell.shape.kind == "train":
                state = shard_train_state(_fake_train_state(cfg, run), run, mesh)
                batch = {
                    "tokens": torch.zeros((B, S), dtype=torch.int32),
                    "labels": torch.zeros((B, S), dtype=torch.int32),
                }
                if cfg.is_encoder_decoder:
                    batch["frames"] = torch.zeros((B, cfg.encoder_seq_len, cfg.d_model))
                args = (state, batch)
            else:
                from repro_torch.distributed.serve import shard_cache
                from repro_torch.models.model import Transformer, init_cache

                model = Transformer(cfg, impl=run.impl)
                fsdp = cell.meta["serve_fsdp"]
                model = shard_train_state(_State(model), run, mesh, fsdp=fsdp).model
                clen = cell.meta["cache_len"]
                cache = init_cache(cfg, B, clen, device="cpu")
                cache = shard_cache(cfg, mesh, cell.shape, cache, B, clen)
                if cell.shape.kind == "prefill":
                    batch = {"tokens": torch.zeros((B, S), dtype=torch.int32)}
                    if cfg.is_encoder_decoder:
                        batch["frames"] = torch.zeros((B, cfg.encoder_seq_len, cfg.d_model))
                    args = (model, batch, cache)
                else:  # one token a sequence at the context's last position
                    tokens = torch.zeros((B, 1), dtype=torch.int32)
                    args = (model, cache, tokens, torch.tensor(S - 1, dtype=torch.int32))
            with CollectiveCounter() as counter:
                cell.fn(*args)
    finally:
        moe._fractal_perm.cache_clear()
    return {
        "status": "ok",
        "seconds": time.time() - t0,
        "collectives": counter.stats(),
        "records": [(r, group_ranks(g)) for r, g in zip(counter.records, counter.groups)],
        "mesh_groups": {
            n: tuple(dist.get_process_group_ranks(mesh.get_group(n))) for n in mesh.mesh_dim_names
        },
    }


def _fake_train_state(cfg, run):
    """A train state of fake tensors (call under ``FakeTensorMode``): the
    model built as ``init_train_state`` builds it, its values never drawn."""
    from repro_torch.models.model import Transformer
    from repro_torch.optim import make_optimizer
    from repro_torch.train.step import TrainState, bind_stacked

    model = Transformer(
        cfg,
        compute_dtype=getattr(torch, run.compute_dtype),
        param_dtype=getattr(torch, run.param_dtype),
        impl=run.impl,
    )
    params, grads = bind_stacked(model)
    opt = make_optimizer(run.optimizer)[0](params)
    return TrainState(model, params, grads, opt, torch.zeros((), dtype=torch.int32))


class _State:
    """A bare parameter holder for ``shard_train_state`` (a serving model:
    no gradients or optimizer state kept)."""

    def __init__(self, model):
        from repro_torch.train.step import bind_stacked

        self.model = model
        self.params, self.grads = bind_stacked(model)
        self.opt = {}
        self.ef = None


def run_cell(
    arch: str,
    shape_name: str,
    *,
    multi_pod: bool,
    out_dir: Optional[Path] = None,
    cfg=None,
    run=None,
    tag: str = "",
) -> dict:
    """Build one cell on the production mesh (a fake world of 256 or 512)
    and record its bytes per rank and one step's collectives; the JSON goes
    to ``out_dir`` when given."""
    mesh_name = "pod2x16x16" if multi_pod else "pod16x16"
    fake_world(512 if multi_pod else 256)
    mesh = make_production_mesh(multi_pod=multi_pod, device="cpu")
    cfg = cfg or get_config(arch)
    run = run or default_run_config(arch, shape_name)
    rec = {"arch": arch, "shape": shape_name, "mesh": mesh_name, "status": "ok"}
    try:
        cell = build_cell(arch, shape_name, mesh, run=run, cfg=cfg)
        rec["meta"] = cell.meta
        if cell.shape.kind == "train":
            state_abs, batch_abs = cell.args
            state_sh, batch_sh = cell.in_shardings
            nbytes = {
                "params": tree_shard_nbytes(state_abs["params"], state_sh["params"]),
                "opt": tree_shard_nbytes(state_abs["opt"], state_sh["opt"]),
                "batch": tree_shard_nbytes(batch_abs, batch_sh),
            }
        else:
            params_abs, second, third = cell.args[:3]
            p_sh, s_sh, t_sh = cell.in_shardings[:3]
            nbytes = {"params": tree_shard_nbytes(params_abs, p_sh)}
            if cell.shape.kind == "prefill":
                nbytes["batch"] = tree_shard_nbytes(second, s_sh)
                nbytes["cache"] = tree_shard_nbytes(third, t_sh)
            else:
                nbytes["cache"] = tree_shard_nbytes(second, s_sh)
                nbytes["batch"] = tree_shard_nbytes(third, t_sh)
        rec["bytes_per_rank"] = nbytes
        try:
            rec["step"] = _step(cell, cfg, run, mesh)
        except Exception as e:  # recorded, not hidden: the cell's step cannot run
            rec["step"] = {
                "status": "fail",
                "error": f"{type(e).__name__}: {e}"[:2000],
                "traceback": traceback.format_exc()[-2000:],
            }
    except Exception as e:  # a cell that does not build is a bug: record and surface it
        rec["status"] = "fail"
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-2000:]
    finally:
        set_activation_sharder(None)
    if out_dir is not None:
        out_dir.mkdir(parents=True, exist_ok=True)
        (out_dir / f"{arch}__{shape_name}{tag}.json").write_text(
            json.dumps(rec, indent=1, default=str)
        )
    return rec


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--smoke", action="store_true", help="the reduced configs (tests)")
    ap.add_argument("--out", default="experiments/dryrun_torch")
    args = ap.parse_args(argv)

    archs = list_archs() if args.arch is None else [args.arch]
    shapes = [s.name for s in SHAPES] if args.shape is None else [args.shape]
    meshes = [False, True] if (args.both_meshes or args.all) else [args.multi_pod]

    owned = not dist.is_initialized()  # the group is torn down only if made here
    n_ok = n_fail = n_skip = n_step_fail = 0
    for multi_pod in meshes:
        mesh_name = "pod2x16x16" if multi_pod else "pod16x16"
        out_dir = Path(args.out) / mesh_name
        for arch in archs:
            cfg = get_config(arch)
            cfg = smoke(cfg) if args.smoke else cfg
            for shape_name in shapes:
                ok, why = shape_applicable(cfg, SHAPES_BY_NAME[shape_name])
                if not ok:
                    n_skip += 1
                    out_dir.mkdir(parents=True, exist_ok=True)
                    (out_dir / f"{arch}__{shape_name}.json").write_text(
                        json.dumps(
                            {
                                "arch": arch,
                                "shape": shape_name,
                                "mesh": mesh_name,
                                "status": "skip",
                                "reason": why,
                            },
                            indent=1,
                        )
                    )
                    print(f"[skip] {mesh_name} {arch} {shape_name}: {why}", flush=True)
                    continue
                rec = run_cell(arch, shape_name, multi_pod=multi_pod, out_dir=out_dir, cfg=cfg)
                if rec["status"] != "ok":
                    n_fail += 1
                    print(f"[FAIL] {mesh_name} {arch} {shape_name}: {rec['error']}", flush=True)
                    continue
                n_ok += 1
                st = rec.get("step", {})
                n_step_fail += st.get("status") == "fail"
                coll = st.get("collectives", {})
                print(
                    f"[ok]   {mesh_name} {arch} {shape_name} bytes/rank={rec['bytes_per_rank']} "
                    f"step={st.get('status', 'not run')} coll={coll.get('count')} "
                    f"wire={coll.get('wire_bytes')}",
                    flush=True,
                )
    print(f"done: ok={n_ok} fail={n_fail} skip={n_skip} step_fail={n_step_fail}")
    if owned and dist.is_initialized():
        dist.destroy_process_group()
    if n_fail:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
