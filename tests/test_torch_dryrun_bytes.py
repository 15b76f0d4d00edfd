"""The dry run's cells (``launch.specs.build_cell``) on one rank of a fake
process group of 256 ranks (the ``(16, 16)`` production mesh), held to the
reference's ``build_cell`` on a ``jax.sharding.AbstractMesh`` of the same
shape: each rank's bytes of parameters, optimizer state, batch and cache,
summed from the reference's shard shapes, for every applicable cell of two
smoke configs (dense and MoE) and for stablelm-1.6b's train_4k cell at full
size.  Also the collective counter (``analysis.collectives``) against the
reference's HLO parser: the collectives a 2-rank expert-parallel MoE step
records, written out as HLO lines inside a ``while`` loop of L trips, give
the same bytes through the reference's ``collective_wire_bytes`` as L times
the port's count.  The cells' steps are in ``test_torch_dryrun_smoke.py``
and ``test_torch_dryrun_ssd.py``."""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
from jax.sharding import AbstractMesh as RefAbstractMesh  # noqa: E402

from repro.analysis.hlo import collective_wire_bytes  # noqa: E402
from repro.analysis.hlo import shape_bytes as ref_shape_bytes  # noqa: E402
from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.configs import smoke as ref_smoke  # noqa: E402
from repro.launch import specs as ref_specs  # noqa: E402
from repro_torch.analysis import collectives as C  # noqa: E402
from repro_torch.configs import get_config, smoke  # noqa: E402
from repro_torch.configs.base import SHAPES, shape_applicable  # noqa: E402
from repro_torch.launch.specs import build_cell, tree_shard_nbytes  # noqa: E402
from torch_dist import run_ranks  # noqa: E402
from torch_fake_mesh import mesh  # noqa: E402, F401

SMOKE_ARCHS = ("stablelm-1.6b", "olmoe-1b-7b")


def _ref_cell(arch, shape_name, monkeypatch, small):
    ref_mesh = RefAbstractMesh((16, 16), ("data", "model"))
    if small:
        cfg = ref_smoke(ref_get_config(arch))
        monkeypatch.setattr(ref_specs, "get_config", lambda name: cfg)
    try:
        return ref_specs.build_cell(arch, shape_name, ref_mesh)
    finally:
        from repro.models.sharding_hooks import set_activation_sharder as ref_set

        ref_set(None)


def _ref_bytes(abstract, shardings) -> int:
    per = jax.tree_util.tree_map(
        lambda a, s: math.prod(s.shard_shape(a.shape)) * a.dtype.itemsize, abstract, shardings
    )
    return int(sum(jax.tree_util.tree_leaves(per)))


def _port_bytes(cell) -> dict:
    if cell.shape.kind == "train":
        (st, b), (st_sh, b_sh) = cell.args, cell.in_shardings
        return {
            "params": tree_shard_nbytes(st["params"], st_sh["params"]),
            "opt": tree_shard_nbytes(st["opt"], st_sh["opt"]),
            "batch": tree_shard_nbytes(b, b_sh),
        }
    a, s = cell.args, cell.in_shardings
    out = {"params": tree_shard_nbytes(a[0], s[0])}
    out["cache" if cell.shape.kind == "decode" else "batch"] = tree_shard_nbytes(a[1], s[1])
    out["batch" if cell.shape.kind == "decode" else "cache"] = tree_shard_nbytes(a[2], s[2])
    return out


def _want_bytes(cell) -> dict:
    if cell.shape.kind == "train":
        (st, b), (st_sh, b_sh) = cell.args, cell.in_shardings
        return {
            "params": _ref_bytes(st["params"], st_sh["params"]),
            "opt": _ref_bytes(st["opt"], st_sh["opt"]),
            "batch": _ref_bytes(b, b_sh),
        }
    a, s = cell.args, cell.in_shardings
    out = {"params": _ref_bytes(a[0], s[0])}
    out["cache" if cell.shape.kind == "decode" else "batch"] = _ref_bytes(a[1], s[1])
    out["batch" if cell.shape.kind == "decode" else "cache"] = _ref_bytes(a[2], s[2])
    return out


def _cells():
    out = []
    for arch in SMOKE_ARCHS:
        cfg = smoke(get_config(arch))
        out += [(arch, s.name, True) for s in SHAPES if shape_applicable(cfg, s)[0]]
    return out + [("stablelm-1.6b", "train_4k", False)]


@pytest.mark.parametrize("arch,shape_name,small", _cells())
def test_cell_bytes_per_rank_match_reference(mesh, monkeypatch, arch, shape_name, small):
    cfg = smoke(get_config(arch)) if small else get_config(arch)
    cell = build_cell(arch, shape_name, mesh, cfg=cfg)
    want = _want_bytes(_ref_cell(arch, shape_name, monkeypatch, small))
    assert _port_bytes(cell) == want
    assert cell.meta["mesh"] == {"data": 16, "model": 16}
    assert cell.meta["params"] == cfg.num_params()


MOE_BODY = """
import numpy as np
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import Replicate, Shard, distribute_tensor

from repro_torch.analysis.collectives import CollectiveCounter
from repro_torch.configs import get_config, smoke
from repro_torch.distributed.sharding import param_rules, placements, spec_for_param
from repro_torch.models import moe
from repro_torch.models.sharding_hooks import set_activation_sharder


def main(rank, world, tmp):
    cfg = smoke(get_config("olmoe-1b-7b"))
    mesh = init_device_mesh("cpu", (1, 2), mesh_dim_names=("data", "model"))
    set_activation_sharder(None, mesh=mesh, fsdp=False)
    rules = param_rules(cfg, mesh, fsdp=False)
    g = torch.Generator().manual_seed(0)
    p = {}
    for k, s in moe.moe_specs(cfg).items():
        pl = placements(spec_for_param(s.axes, s.shape, rules, mesh), mesh)
        p[k] = distribute_tensor(torch.randn(s.shape, generator=g), mesh, pl).requires_grad_()
    x = distribute_tensor(torch.randn(2, 16, cfg.d_model, generator=g), mesh, [Shard(0), Replicate()])
    with CollectiveCounter() as counter:
        out, aux = moe.moe_ffn(cfg, p, x)
        (out.sum() + aux).full_tensor().backward()
    counts = {str(k): v for k, v in counter.get_comm_counts().items()}
    return {"records": counter.records, "stats": counter.stats(), "counts": counts}
"""


@pytest.fixture(scope="module")
def moe_records(tmp_path_factory):
    return run_ranks(2, MOE_BODY, tmp_path_factory.mktemp("moe_coll"), timeout=240)


def _hlo(records, trips: int) -> str:
    """``records`` as HLO instruction lines (kind and result shape) in the
    body of a ``while`` loop of ``trips`` trips, the form the reference's
    parser reads."""
    body = "\n".join(
        f"  %c{i} = {dt}[{','.join(map(str, shape))}]{{0}} {kind}(%x), replica_groups={{}}"
        for i, (kind, dt, shape) in enumerate(records)
    )
    return f"""HloModule step

%body.1 (p: (s32[], f32[8])) -> (s32[], f32[8]) {{
{body}
  ROOT %t = tuple()
}}

%cond.1 (p: (s32[], f32[8])) -> pred[] {{
  %c = s32[] constant({trips})
  ROOT %lt = pred[] compare(%i, %c), direction=LT
}}

ENTRY %main (a: f32[8]) -> f32[8] {{
  %w = (s32[], f32[8]) while(%init), condition=%cond.1, body=%body.1
  ROOT %r = f32[8] get-tuple-element(%w), index=1
}}
"""


@pytest.mark.parametrize("trips", [1, 16])
def test_collective_bytes_match_reference_parser(moe_records, trips):
    """Per layer: the token all-gather over ``model`` (sequence
    parallelism) and its reduce-scatter, aux's mean, and their transposes
    in the backward; gloo runs a reduce-scatter as an all-reduce, and the
    counter records what ran."""
    recs = [tuple(r) for r in moe_records["records"]]
    kinds = {k for k, _, _ in recs}
    assert {"all-gather", "all-reduce"} <= kinds
    want = collective_wire_bytes(_hlo(recs, trips))
    got = C.collective_stats(recs * trips)
    for k in ("all-gather", "all-reduce", "reduce-scatter", "all-to-all", "wire_bytes"):
        assert got[k] == want.get(k, 0), k
    assert got["count"] == len(recs) * trips and want["count"] == len(recs)
    assert sum(got["calls"].values()) == got["count"]
    comm_counts = sum(moe_records["counts"].values())
    assert comm_counts == len(recs)  # CommDebugMode's own count of the same calls


def test_shape_bytes_copied():
    for s in ("f32[1024]", "(f32[4], bf16[8])", "pred[3,5]", "s32[]", "u8[7]"):
        assert C.shape_bytes(s) == ref_shape_bytes(s)
    assert C.HLO_DTYPES[torch.bfloat16] == "bf16"
    np.testing.assert_equal(C.collective_stats([])["wire_bytes"], 0)
