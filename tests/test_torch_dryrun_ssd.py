"""The SSD cells of the dry run at 16 heads on one rank of a fake process
group of 256 ranks (the ``(16, 16)`` production mesh): mamba2's and jamba's
steps under fake tensors run the mixer split over its heads, and no
all-gather over ``model`` carries a rank's block of an SSD weight or state
(the other cells' steps are in ``test_torch_dryrun_smoke.py``)."""

import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config, smoke  # noqa: E402
from repro_torch.configs.base import SHAPES, SHAPES_BY_NAME, shape_applicable  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from torch_fake_mesh import mesh  # noqa: E402, F401

#: the SSD configs at a width whose 16 heads the (16, 16) mesh's ``model``
#: divides: smoke at d_model 128 (d_inner 256, 16 heads of 16, state 16),
#: the full size's chunk of 256, as ``test_torch_dryrun_smoke._smoke_cfg``
SSD_TP_ARCHS = ("mamba2-1.3b", "jamba-1.5-large-398b")


def _ssd_tp_cells():
    return [
        (arch, s.name)
        for arch in SSD_TP_ARCHS
        for s in SHAPES
        if shape_applicable(smoke(get_config(arch), d_model=128, ssm_chunk=256), s)[0]
    ]


@pytest.mark.parametrize("arch,shape_name", _ssd_tp_cells())
def test_ssd_cell_step_splits_heads_over_model(mesh, arch, shape_name):
    """The SSD cells at 16 heads on the (16, 16) mesh run the mixer split
    over its heads (``models.ssm.SSMBlock._mix_heads``): the step runs
    with its collectives counted, and no all-gather over ``model`` carries
    a rank's block of ``w_z``, ``w_x``, ``w_dt``, ``conv_x`` or
    ``out_proj`` (the TP block, or the FSDP + TP block of a train cell or
    of jamba's FSDP serving layout; either order of the two gathers) or of
    the SSD state (the counter records a gather's result: its dim 0 is the
    block's times the group's 16 ranks)."""
    from repro_torch.models.ssm import heads_split

    cfg = smoke(get_config(arch), d_model=128, ssm_chunk=256)
    assert cfg.ssm_num_heads == 16 and heads_split(cfg, mesh)
    rec = dryrun.run_cell(arch, shape_name, multi_pod=False, cfg=cfg)
    assert rec["status"] == "ok", rec.get("traceback")
    step = rec["step"]
    assert step["status"] == "ok", step.get("traceback")
    assert step["collectives"]["count"] > 0
    d, di, h, p, n, tp = 128, 256, 16, 16, 16, 16
    wdt = "f32" if shape_name == "train_4k" else "bf16"
    blocks = {
        ((d, di // tp), wdt), ((d // tp, di // tp), wdt),  # w_z, w_x
        ((d, h // tp), wdt), ((d // tp, h // tp), wdt),  # w_dt
        ((4, di // tp), wdt),  # conv_x
        ((di // tp, d), wdt), ((di // tp, d // tp), wdt),  # out_proj
    }
    B = SHAPES_BY_NAME[shape_name].global_batch
    rows = B // 16 if B % 16 == 0 else B
    blocks.add(((rows, h // tp, p, n), "f32"))  # the state's heads
    model = step["mesh_groups"]["model"]
    gathered = [
        ((shape[0] // tp, *shape[1:]), dt)
        for (kind, dt, shape), g in step["records"]
        if kind == "all-gather" and g == model
    ]
    assert gathered, "no all-gather over model at all"  # the counter names the groups
    assert not [b for b in gathered if b in blocks], [b for b in gathered if b in blocks]
