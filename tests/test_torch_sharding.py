"""The port's sharding rules (``distributed.sharding``) against the
reference's, leaf for leaf, on abstract meshes of the production shapes
(``(16, 16)`` and ``(2, 16, 16)``: no 256 devices needed on either side,
``jax.sharding.AbstractMesh`` and ``sharding.AbstractMesh``): every
parameter's spec for all ten configs with FSDP on and off, the decode
caches' specs per family, and the batch and label specs at divisible and
non-divisible batches.  Specs are compared as tuples, a one-axis tuple
read as its name (as ``PartitionSpec`` prints it).  Also: the placements a
spec makes, and the hooks' identity with nothing registered."""

import pytest

torch = pytest.importorskip("torch")

from jax.sharding import AbstractMesh as RefAbstractMesh  # noqa: E402
from jax.sharding import NamedSharding as RefNamedSharding  # noqa: E402

from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.configs.base import SHAPES_BY_NAME as REF_SHAPES  # noqa: E402
from repro.configs.base import shape_applicable as ref_shape_applicable  # noqa: E402
from repro.distributed import sharding as RS  # noqa: E402
from repro.models import model as RM  # noqa: E402
from repro.models.layers import ParamSpec as RefParamSpec  # noqa: E402
from repro_torch.configs import get_config, list_archs  # noqa: E402
from repro_torch.configs.base import SHAPES, SHAPES_BY_NAME, shape_applicable  # noqa: E402
from repro_torch.distributed import sharding as SH  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models import sharding_hooks as hooks  # noqa: E402
from repro_torch.models.layers import iter_specs  # noqa: E402

MESHES = {
    "pod16x16": ((16, 16), ("data", "model")),
    "pod2x16x16": ((2, 16, 16), ("pod", "data", "model")),
}


def _norm(spec) -> tuple:
    return tuple(m[0] if isinstance(m, tuple) and len(m) == 1 else m for m in spec)


def _meshes(name):
    shape, axes = MESHES[name]
    return SH.AbstractMesh(shape, axes), RefAbstractMesh(shape, axes)


def _ref_leaves(tree, prefix=()):
    if isinstance(tree, RefParamSpec):
        yield prefix, tree
        return
    for k in sorted(tree):
        yield from _ref_leaves(tree[k], prefix + (k,))


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("fsdp", [True, False], ids=["fsdp", "tp-only"])
@pytest.mark.parametrize("arch", list_archs())
def test_param_specs_match_reference(arch, fsdp, mesh_name):
    mesh, ref_mesh = _meshes(mesh_name)
    cfg, ref_cfg = get_config(arch), ref_get_config(arch)
    rules = SH.param_rules(cfg, mesh, fsdp=fsdp)
    ref_rules = RS.param_rules(ref_cfg, ref_mesh, fsdp=fsdp)
    assert rules == ref_rules
    got = {
        keys: SH.spec_for_param(s.axes, s.shape, rules, mesh)
        for keys, s in iter_specs(M.param_specs(cfg))
    }
    want = {
        keys: RS.spec_for_param(s.axes, s.shape, ref_rules, ref_mesh)
        for keys, s in _ref_leaves(RM.param_specs(ref_cfg))
    }
    assert set(got) == set(want)
    for keys in want:
        assert _norm(got[keys]) == _norm(tuple(want[keys])), keys
    tree = SH.param_shardings(cfg, mesh, fsdp=fsdp)
    for keys, s in iter_specs(M.param_specs(cfg)):
        node = tree
        for k in keys:
            node = node[k]
        assert node.spec == got[keys]


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("arch", list_archs())
def test_cache_specs_match_reference(arch, mesh_name):
    mesh, ref_mesh = _meshes(mesh_name)
    cfg, ref_cfg = get_config(arch), ref_get_config(arch)
    for shape in SHAPES:
        if shape.kind == "train" or not shape_applicable(cfg, shape)[0]:
            continue
        assert ref_shape_applicable(ref_cfg, REF_SHAPES[shape.name])[0]
        for B in (shape.global_batch, 3):
            clen = min(shape.seq_len, cfg.sliding_window or shape.seq_len)
            got = SH.cache_pspecs(cfg, mesh, shape, B, clen)
            want = RS.cache_pspecs(ref_cfg, ref_mesh, REF_SHAPES[shape.name], B, clen)

            def walk(g, w, path=()):
                if isinstance(w, dict):
                    assert set(g) == set(w), path
                    for k in w:
                        walk(g[k], w[k], path + (k,))
                else:
                    assert _norm(g) == _norm(tuple(w)), (shape.name, B, path)

            walk(got, want)


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("arch", ["stablelm-1.6b", "whisper-base"])
@pytest.mark.parametrize("B", [512, 256, 48, 16, 3, 1])
def test_batch_specs_match_reference(arch, mesh_name, B):
    mesh, ref_mesh = _meshes(mesh_name)
    got = SH.batch_shardings(get_config(arch), mesh, B)
    want = RS.batch_shardings(ref_get_config(arch), ref_mesh, B)
    assert set(got) == set(want)
    for k in want:
        assert _norm(got[k].spec) == _norm(tuple(want[k].spec)), k
    want_labels = RS.label_sharding(ref_mesh, B).spec
    assert _norm(SH.label_sharding(mesh, B).spec) == _norm(tuple(want_labels))
    assert isinstance(want["tokens"], RefNamedSharding)


def test_placements_and_shard_shapes():
    from torch.distributed.tensor import Replicate, Shard

    mesh = SH.AbstractMesh((2, 16, 16), ("pod", "data", "model"))
    sh = SH.NamedSharding(mesh, (("pod", "data"), None, "model"))
    assert sh.placements == (Shard(0), Shard(0), Shard(2))
    assert sh.shard_shape((64, 7, 32)) == (2, 7, 2)
    assert sh.shard_nbytes((64, 7, 32), torch.bfloat16) == 2 * 7 * 2 * 2
    assert SH.replicated(mesh).placements == (Replicate(),) * 3
    assert SH.activation_spec(mesh, (64, 32, 8), "resid", seq_parallel=True) == (
        ("pod", "data"),
        "model",
        None,
    )
    assert SH.activation_spec(mesh, (1, 32, 8), "resid") is None  # batch-1 cells
    assert SH.activation_spec(mesh, (64, 32, 8), "cache") is None
    assert SHAPES_BY_NAME["long_500k"].global_batch == 1


def test_hooks_are_the_identity_with_nothing_registered():
    x = torch.randn(2, 3, 4)
    assert hooks.current_mesh() is None and not hooks.params_fsdp()
    for kind in ("resid", "logits", "attn_io", "batch0", "moe_buf"):
        assert hooks.shard_activations(x, kind) is x
    assert hooks.gather_sequence(x) is x
