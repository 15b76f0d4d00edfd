"""The sharded serving steps' embedding lookup on one rank of a fake process
group of 256 ranks (the ``(16, 16)`` production mesh): the steps choose
between gathering the vocab-sharded table and the vocab-parallel lookup by
``distributed.serve.lookup_moves_less``, and at decode no all-gather over
``model`` carries the table; the cells' bytes a rank do not move
(stablelm-1.6b's and mamba2-1.3b's decode_32k cells at full size, pinned to
the dry run before the lookup: the steps' inputs are the cells', which this
does not touch)."""

import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config, smoke  # noqa: E402
from repro_torch.configs.base import SHAPES_BY_NAME, shape_applicable  # noqa: E402
from repro_torch.distributed.serve import lookup_moves_less  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from torch_fake_mesh import mesh  # noqa: E402, F401

ARCHS = ("stablelm-1.6b", "mamba2-1.3b")
#: the data-parallel ranks of the (16, 16) mesh
DATA = 16


def _cfg(arch, small=True):
    """The smoke config (an SSM's at its full size's chunk, as
    ``test_torch_dryrun_smoke._smoke_cfg``), or the full one."""
    cfg = get_config(arch)
    if not small:
        return cfg
    return smoke(cfg, ssm_chunk=cfg.ssm_chunk) if cfg.ssm_state_dim else smoke(cfg)


def _payloads(cfg, shape_name):
    """(table bytes, a rank's rows bytes, seq_split) of a serving cell in
    bf16, as ``serve._embed`` counts them."""
    shape = SHAPES_BY_NAME[shape_name]
    B = shape.global_batch
    rows = B // DATA if B % DATA == 0 else B
    S = shape.seq_len if shape.kind == "prefill" else 1
    d = cfg.d_model
    return cfg.padded_vocab * d * 2, rows * S * d * 2, shape.kind == "prefill"


@pytest.mark.parametrize(
    "arch,shape_name,table,rows,lookup",
    [
        ("mamba2-1.3b", "decode_32k", 209_715_200, 32_768, True),
        ("stablelm-1.6b", "decode_32k", 411_041_792, 32_768, True),
        ("mamba2-1.3b", "long_500k", 209_715_200, 4_096, True),
        ("mamba2-1.3b", "prefill_32k", 209_715_200, 268_435_456, False),
        ("stablelm-1.6b", "prefill_32k", 411_041_792, 268_435_456, True),
    ],
)
def test_rule_picks_the_smaller_payload(arch, shape_name, table, rows, lookup):
    """At decode the rows ([8, 1, 2048] bf16, 32 KiB; long_500k's one
    sequence 4 KiB) against the table (mamba2 [51200, 2048], 209.7 MB;
    stablelm [100352, 2048], 411.0 MB); at prefill_32k the rows ([2, 32768,
    2048], 268.4 MB, reduce-scattered) lose to mamba2's table and win over
    stablelm's."""
    got_table, got_rows, seq_split = _payloads(_cfg(arch, small=False), shape_name)
    assert (got_table, got_rows) == (table, rows)
    assert lookup_moves_less(table, rows, seq_split=seq_split) is lookup


def _table_gathers(rec, cfg):
    step = rec["step"]
    assert step["status"] == "ok", step.get("traceback")
    model = step["mesh_groups"]["model"]
    table = (cfg.padded_vocab, cfg.d_model)
    return [
        shape
        for (kind, _, shape), g in step["records"]
        if kind == "all-gather" and g == model and tuple(shape) == table
    ]


def _serving_cells():
    return [
        (arch, s)
        for arch in ARCHS
        for s in ("decode_32k", "long_500k")
        if shape_applicable(_cfg(arch), SHAPES_BY_NAME[s])[0]
    ]


@pytest.mark.parametrize("arch,shape_name", _serving_cells())
def test_decode_gathers_no_table(mesh, arch, shape_name):
    """Every decode_32k and long_500k cell of the smoke configs: no
    all-gather over ``model`` whose result is the whole ``[Vp, d]`` table
    (the counter records a gather's result), and the rows' all-reduce
    (``[B_rank, 1, d]``) is there instead."""
    cfg = _cfg(arch)
    rec = dryrun.run_cell(arch, shape_name, multi_pod=False, cfg=cfg)
    assert rec["status"] == "ok", rec.get("traceback")
    assert not _table_gathers(rec, cfg)
    B = SHAPES_BY_NAME[shape_name].global_batch
    rows = (B // DATA if B % DATA == 0 else B, 1, cfg.d_model)
    model = rec["step"]["mesh_groups"]["model"]
    assert [
        s
        for (kind, _, s), g in rec["step"]["records"]
        if kind == "all-reduce" and g == model and tuple(s) == rows
    ]


def test_prefill_keeps_the_gather_where_the_table_is_smaller(mesh):
    """The smoke prefill_32k cell: its rows ([2, 32768, 64]) outweigh the
    table ([2048, 64]), so the step gathers the table, once."""
    cfg = _cfg("stablelm-1.6b")
    rec = dryrun.run_cell("stablelm-1.6b", "prefill_32k", multi_pod=False, cfg=cfg)
    assert rec["status"] == "ok", rec.get("traceback")
    assert len(_table_gathers(rec, cfg)) == 1


#: the dry run's bytes a rank of two full-size cells before the lookup (the
#: parent's ``python -m repro_torch.launch.dryrun``), and its wire bytes
PARENT = {
    "mamba2-1.3b": ({"params": 215643264, "cache": 50958336, "batch": 32}, 241571904),
    "stablelm-1.6b": ({"params": 205922304, "cache": 3222798336, "batch": 32}, 479337536),
}


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_cell_bytes_per_rank_unchanged_and_wire_falls(mesh, arch):
    """Full-size decode_32k: bytes a rank as before; the wire bytes fall by
    the table's gather (the counter's ring model: a gather's result once)
    less the rows' all-reduce (twice its 32 KiB), and by no more than 1.05
    tables (the residual's layout after the lookup moves some KB too)."""
    cfg = get_config(arch)
    rec = dryrun.run_cell(arch, "decode_32k", multi_pod=False)
    assert rec["status"] == "ok", rec.get("traceback")
    before, wire_before = PARENT[arch]
    assert rec["bytes_per_rank"] == before
    assert not _table_gathers(rec, cfg)
    table, rows, _ = _payloads(cfg, "decode_32k")
    fell = wire_before - rec["step"]["collectives"]["wire_bytes"]
    assert table - 2 * rows <= fell <= 1.05 * table
