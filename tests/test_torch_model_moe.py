"""The port's MoE stack against the JAX package: ``prefill`` and
``decode_step`` logits on ``smoke(olmoe-1b-7b)`` (QK-norm, 4 experts top-2 on
every layer), with the same weights on both sides, and the parameter tree's
round trip through ``state_tree`` and ``model_from_reference``.

The logits comparison is ``tests/test_torch_model.py``'s, run on this arch:
weights from the port's seeded init go to the reference as its parameter
tree, the KV store has the compute dtype on both sides, and the logits
tolerances are 1e-4 in float32 and 0.5 in bfloat16.  QK-norm bounds each
head's q and k to norm ``sqrt(head_dim)``, so the scores stay of unit scale
and the bfloat16 runs keep the same expert choices on both sides here
(measured: at most 1.9e-6 in float32 and 0.031, two bf16 steps, in bfloat16,
on logits of magnitude up to ~3.5).  Decode routes every slot's row, each row
its own group, as the reference does.
"""

import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.configs import smoke as ref_smoke  # noqa: E402
from repro.models import model as RM  # noqa: E402
from repro_torch.configs import get_config, smoke  # noqa: E402
from repro_torch.interop import model_from_reference  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from test_torch_model import prefill_and_decode_gap  # noqa: E402

ARCH = "olmoe-1b-7b"


def test_configs_match_reference():
    ref = ref_get_config(ARCH)
    assert dataclasses.asdict(get_config(ARCH)) == dataclasses.asdict(ref)
    assert get_config(ARCH).num_params() == ref.num_params()
    for overrides in ({}, {"moe_num_shared": 1}):
        got = smoke(get_config(ARCH), **overrides)
        want = ref_smoke(ref, **overrides)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
        assert got.num_params() == want.num_params()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_and_decode_match_reference(dtype, record_property):
    record_property("max_abs_logit_gap", prefill_and_decode_gap(ARCH, {}, dtype))


def test_converter_round_trip_with_moe_and_qk_norm_leaves():
    cfg = smoke(get_config(ARCH), moe_num_shared=1)
    tree = M.init_params(cfg, 3, device="cpu", compute_dtype=torch.float32).state_tree()
    layer = tree["layers"]
    assert "ffn" not in layer
    moe_leaves = {"router", "w_gate", "w_up", "w_down", "ws_gate", "ws_up", "ws_down"}
    assert set(layer["moe"]) == moe_leaves
    assert layer["moe"]["w_down"].shape == (2, 4, 64, 64)  # [L, E, f, d]
    np.testing.assert_array_equal(layer["attn"]["q_norm"], 1.0)  # ones, as the reference
    model = model_from_reference(cfg, tree, device="cpu", compute_dtype=torch.bfloat16)
    assert model.layers[1].moe.w_gate.dtype == torch.bfloat16
    assert model.layers[1].attn.k_norm.dtype == torch.float32  # norm scales stay float32
    back = model_from_reference(cfg, tree, device="cpu", compute_dtype=torch.float32).state_tree()
    for path, leaf in jax.tree_util.tree_leaves_with_path(tree):
        np.testing.assert_array_equal(
            leaf, functools.reduce(lambda t, k: t[k.key], path, back), err_msg=str(path)
        )


def test_reference_init_tree_loads():
    """The reference's own init output converts as it is (numpy leaves)."""
    ref_cfg = ref_smoke(ref_get_config(ARCH))
    params = jax.tree_util.tree_map(np.asarray, RM.init_params(ref_cfg, 0))
    cfg = smoke(get_config(ARCH))
    model = model_from_reference(cfg, params, device="cpu", compute_dtype=torch.float32)
    moe = params["layers"]["moe"]
    np.testing.assert_array_equal(model.layers[1].moe.w_up.numpy(), moe["w_up"][1])
    np.testing.assert_array_equal(model.layers[0].moe.router.numpy(), moe["router"][0])
    q_norm = params["layers"]["attn"]["q_norm"][0]
    np.testing.assert_array_equal(model.layers[0].attn.q_norm.numpy(), q_norm)
