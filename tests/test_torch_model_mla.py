"""The port's MLA stack against the JAX package on ``smoke(deepseek-v2-lite-16b)``
(MLA with kv_lora_rank 32, qk_nope 16, qk_rope 8, v_head 16; 4 experts top-2
and 2 shared on every layer): ``prefill`` and ``decode_step`` logits in both
decode forms through the latent rows of the pool, the parameter tree's round
trip, the engine's tokens and block placement against the reference's
engine, and the refusal to build a training model.

The logits comparison is ``tests/test_torch_model.py``'s, run on this arch:
weights from the port's seeded init go to the reference as its parameter
tree, the KV store has the compute dtype on both sides, and the logits
tolerances are 1e-4 in float32 and 0.5 in bfloat16.  XLA's CPU backend runs
no bf16 x bf16 -> float32 dot of the shape the reference's absorbed decode
takes, so in bfloat16 the port's absorbed form is held to the reference's
non-absorbed decode (the same function); in float32 each form is held to
its own.  The engine comparison is ``tests/test_torch_serving.py``'s, in
float32: the port's engine decodes in the absorbed form, the reference's
in the non-absorbed one.
"""

import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.serving.engine as ref_engine  # noqa: E402
from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.configs import smoke as ref_smoke  # noqa: E402
from repro.models import model as RM  # noqa: E402
from repro_torch.configs import get_config, smoke  # noqa: E402
from repro_torch.interop import model_from_reference  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.configs.base import RunConfig  # noqa: E402
from repro_torch.train.step import init_train_state  # noqa: E402
from test_torch_model import prefill_and_decode_gap  # noqa: E402
from test_torch_serving import SPEC, MarginEngine, _drive, _reference_model_module  # noqa: E402

ARCH = "deepseek-v2-lite-16b"


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("absorbed", [True, False], ids=["absorbed", "non_absorbed"])
def test_prefill_and_decode_match_reference(dtype, absorbed, record_property):
    ref_absorbed = absorbed and dtype == "float32"
    gap = prefill_and_decode_gap(ARCH, {}, dtype, mla_absorbed=absorbed, ref_absorbed=ref_absorbed)
    record_property("max_abs_logit_gap", gap)


def test_converter_round_trip_with_mla_leaves():
    cfg = smoke(get_config(ARCH))
    tree = M.init_params(cfg, 3, device="cpu", compute_dtype=torch.float32).state_tree()
    attn = tree["layers"]["attn"]
    assert set(attn) == {"wq", "w_dkv", "w_kpe", "kv_norm", "w_uk", "w_uv", "wo"}
    assert attn["wq"].shape == (2, 64, 4, 24) and attn["w_uv"].shape == (2, 32, 4, 16)
    assert {"ws_gate", "ws_up", "ws_down"} <= set(tree["layers"]["moe"])
    np.testing.assert_array_equal(attn["kv_norm"], 1.0)  # ones, as the reference
    model = model_from_reference(cfg, tree, device="cpu", compute_dtype=torch.bfloat16)
    assert model.layers[1].attn.w_uk.dtype == torch.bfloat16
    assert model.layers[1].attn.kv_norm.dtype == torch.float32  # norm scales stay float32
    assert model.kv_row_shape() == (2, 40) and model.kv_width() == 80
    back = model_from_reference(cfg, tree, device="cpu", compute_dtype=torch.float32).state_tree()
    for path, leaf in jax.tree_util.tree_leaves_with_path(tree):
        np.testing.assert_array_equal(
            leaf, functools.reduce(lambda t, k: t[k.key], path, back), err_msg=str(path)
        )


def test_reference_init_tree_loads_and_counts():
    """The reference's own init output converts as it is, and the parameter
    counts agree (16.2 B at full width)."""
    ref_cfg = ref_smoke(ref_get_config(ARCH))
    params = jax.tree_util.tree_map(np.asarray, RM.init_params(ref_cfg, 0))
    cfg = smoke(get_config(ARCH))
    assert dataclasses.asdict(cfg) == dataclasses.asdict(ref_cfg)
    model = model_from_reference(cfg, params, device="cpu", compute_dtype=torch.float32)
    attn, moe = params["layers"]["attn"], params["layers"]["moe"]
    np.testing.assert_array_equal(model.layers[1].attn.w_dkv.numpy(), attn["w_dkv"][1])
    np.testing.assert_array_equal(model.layers[0].attn.w_kpe.numpy(), attn["w_kpe"][0])
    np.testing.assert_array_equal(model.layers[1].moe.ws_down.numpy(), moe["ws_down"][1])
    n_leaves = sum(np.size(x) for x in jax.tree_util.tree_leaves(params))
    # the analytic count leaves out the layers' kv_norm scales and the final
    # norm's, as the reference's does
    uncounted = cfg.num_layers * cfg.kv_lora_rank + cfg.d_model
    assert cfg.num_params() == ref_cfg.num_params() == n_leaves - uncounted
    assert get_config(ARCH).num_params() == ref_get_config(ARCH).num_params()


def test_engine_matches_reference(monkeypatch, record_property):
    """The port's engine (absorbed decode over the pool's latent rows)
    against the reference's (non-absorbed decode over its dense cache), in
    float32: slots per step, blocks, steps, done flags and tokens (with
    ``tests/test_torch_serving.py``'s near-tie allowance)."""
    cfg = smoke(get_config(ARCH))
    tree = M.init_params(cfg, 0, device="cpu", compute_dtype=torch.float32).state_tree()
    monkeypatch.setattr(ref_engine, "M", _reference_model_module(jnp.float32))
    model = model_from_reference(
        cfg, tree, device="cpu", compute_dtype=torch.float32, kv_dtype=torch.float32
    )
    prompts = serve.make_prompts(cfg, SPEC, seed=4)
    ref = ref_engine.ServingEngine(
        ref_smoke(ref_get_config(ARCH)),
        jax.tree_util.tree_map(jnp.asarray, tree),
        max_batch=SPEC.max_batch,
        max_len=SPEC.max_len,
        block_size=SPEC.block_size,
    )
    ref_reqs = [ref.submit(p, max_new_tokens=SPEC.max_new_tokens) for p in prompts]
    ours, reqs = serve.new_engine(cfg, model, SPEC, prompts, engine_cls=MarginEngine)
    assert ours.kv.shape[2] == model.kv_width() == cfg.num_layers * cfg.latent_dim
    assert _drive(ours) == _drive(ref)  # slots per step, every request's blocks
    assert ours.steps == ref.steps
    assert [r.done for r in reqs] == [r.done for r in ref_reqs] == [True] * SPEC.requests
    record_property("smallest_top2_margin", min(ours.margins.values()))
    for r, rr in zip(reqs, ref_reqs):
        parts = [i for i, (a, b) in enumerate(zip(r.out_tokens, rr.out_tokens)) if a != b]
        split = parts[0] if parts else None
        if split is not None:
            margin = ours.margins[(r.rid, split)]
            assert margin <= 2e-4, f"request {r.rid} parts at token {split}, margin {margin}"


def test_mla_training_is_refused():
    cfg = smoke(get_config(ARCH))
    with pytest.raises(NotImplementedError, match="next slice"):
        M.init_params(cfg, 0, device="cpu", param_dtype=torch.float32)
    model = M.init_params(cfg, 0, device="cpu", compute_dtype=torch.float32)
    with pytest.raises(NotImplementedError, match="next slice"):
        M.forward_train(model, torch.zeros(1, 8, dtype=torch.long))
    with pytest.raises(NotImplementedError, match="next slice"):
        init_train_state(cfg, RunConfig(arch=ARCH), device="cpu")
