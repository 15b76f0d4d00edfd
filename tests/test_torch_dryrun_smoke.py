"""The dry run's steps under fake tensors on one rank of a fake process
group of 256 ranks (the ``(16, 16)`` production mesh): the CLI over a smoke
config, every applicable cell of the ten configs reduced, and the GQA
stacks whose heads ``model`` does not divide; each step recorded with its
collectives counted.  Bytes per rank and the collective counter are in
``test_torch_dryrun_bytes.py``, the split SSD cells in
``test_torch_dryrun_ssd.py``."""

import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config, smoke  # noqa: E402
from repro_torch.configs.base import SHAPES, shape_applicable  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from torch_fake_mesh import mesh  # noqa: E402, F401


def test_dryrun_records_cells_and_steps(mesh, tmp_path):
    """The CLI over a smoke config: a JSON per cell, skips recorded, and
    every step run with its collectives counted: the prefill into the
    contiguous cache and the decode step over it (``distributed.serve``),
    whose attention merges the ``model`` ranks' slots of the cache."""
    import json

    dryrun.main(["--arch", "stablelm-1.6b", "--smoke", "--out", str(tmp_path)])
    dryrun.fake_world(256)  # the CLI keeps a group it did not make: a no-op
    recs = {p.stem: json.loads(p.read_text()) for p in (tmp_path / "pod16x16").glob("*.json")}
    assert set(recs) == {f"stablelm-1.6b__{s.name}" for s in SHAPES}
    assert recs["stablelm-1.6b__long_500k"]["status"] == "skip"
    prefill = recs["stablelm-1.6b__prefill_32k"]
    assert prefill["status"] == "ok" and prefill["step"]["status"] == "ok"
    assert prefill["step"]["collectives"]["count"] > 0
    decode = recs["stablelm-1.6b__decode_32k"]["step"]
    assert decode["status"] == "ok", decode.get("traceback")
    assert decode["collectives"]["count"] > 0 and decode["collectives"]["all-gather"] > 0


def _smoke_cfg(arch):
    """The reduced config, an SSM's at the full size's chunk of 256: the
    smoke chunk of 32 makes the SSD's loop over chunks 8x longer, and each
    of its ops costs as much under fake tensors at any size."""
    cfg = get_config(arch)
    return smoke(cfg, ssm_chunk=cfg.ssm_chunk) if cfg.ssm_state_dim else smoke(cfg)


def _smoke_cells():
    from repro_torch.configs import list_archs

    return [
        (arch, s.name) for arch in list_archs() for s in SHAPES
        if shape_applicable(_smoke_cfg(arch), s)[0]
    ]


@pytest.mark.parametrize("arch,shape_name", _smoke_cells())
def test_smoke_cell_step_runs(mesh, arch, shape_name):
    """Every applicable cell of the ten configs, reduced, builds and runs its
    step under fake tensors at world 256 with its collectives counted: the
    sharded train step, the prefill into the contiguous cache, the decode
    step over it (MLA's, the SSD's and whisper's steps among them)."""
    rec = dryrun.run_cell(arch, shape_name, multi_pod=False, cfg=_smoke_cfg(arch))
    assert rec["status"] == "ok", rec.get("traceback")
    assert rec["step"]["status"] == "ok", rec["step"].get("traceback")
    assert rec["step"]["collectives"]["count"] > 0


@pytest.mark.parametrize("arch", ["chameleon-34b", "h2o-danube-1.8b"])
def test_train_step_runs_where_heads_do_not_divide_model(mesh, arch):
    """The smoke GQA stacks' train step on the (16, 16) mesh: 4 heads over
    1 KV group that the rules keep whole on 16 ``model`` ranks, whose
    flattened projections DTensor would split on part heads
    (``models.attention._heads_flat`` keeps the split on whole heads)."""
    rec = dryrun.run_cell(arch, "train_4k", multi_pod=False, cfg=smoke(get_config(arch)))
    assert rec["status"] == "ok" and rec["step"]["status"] == "ok", rec["step"].get("traceback")
    assert rec["step"]["collectives"]["count"] > 0
