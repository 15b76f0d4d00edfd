"""The port's hybrid stack (jamba-1.5-large-398b) against the JAX package on
the CPU, serving: prefill and decode logits, the SSM state and conv window
after each, the engine against the reference ``ServingEngine`` on a
FULL_SSD-shaped smoke mix, and the launcher's refusals; the weights, pairs
and tolerances of ``tests/test_torch_hybrid.py`` (its docstring gives them
and their reasons)."""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.serving.engine as ref_engine  # noqa: E402
from repro.models import model as RM  # noqa: E402
from repro.serving import record as ref_record  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels.banked_copy.ops import banked_copy  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.serving import record  # noqa: E402
from test_torch_hybrid import (  # noqa: E402
    ARCH,
    BLOCKS,
    DTYPES,
    SMOKE_SSD,
    STATE_REL,
    TOL,
    _np,
    _pair,
)
from test_torch_record import _key  # noqa: E402
from test_torch_serving import _drive, _reference_model_module  # noqa: E402


def prefill_and_decode_gap(num_layers: int, dtype: str) -> float:
    """Two prompts (two 32-token chunks, and 11 tokens) prefilled and
    decoded for 4 steps on both sides; each step's logits held to
    ``TOL[dtype]`` and, in float32, the SSM state and conv window to the
    reference's after the prefills and after the decode steps.  The
    reference splices each B = 1 cache into a B = 2 one (batch on axis 2
    for the SSM leaves, as its engine); the port scatters
    each prompt's K/V burst into seeded block tables and writes the slot's
    SSM state in place."""
    cfg, model, rcfg, params = _pair(num_layers, dtype)
    jdt = DTYPES[dtype][1]
    ref_prefill = jax.jit(functools.partial(RM.prefill, rcfg, compute_dtype=jdt))
    ref_decode = jax.jit(functools.partial(RM.decode_step, rcfg, compute_dtype=jdt))
    rng = np.random.default_rng(11)
    prompts = [rng.integers(0, cfg.vocab_size, n) for n in (64, 11)]
    T, bs, NB = 72, 8, 24
    row = model.kv_row_shape()
    cache = RM.init_cache(rcfg, 2, T, dtype=jdt)
    pool = torch.zeros(NB, bs, model.kv_width(), dtype=model.kv_dtype)
    tables = rng.permutation(NB)[:20].reshape(2, 10).astype(np.int32)
    ssm = model.init_ssm_cache(2)
    worst = 0.0

    def splice(path, dst, src, b):
        ax = 2 if "ssm" in jax.tree_util.keystr(path) else 1
        return dst.at[(slice(None),) * ax + (slice(b, b + 1),)].set(src)

    for b, p in enumerate(prompts):
        batch = {"tokens": jnp.asarray(p, jnp.int32)[None]}
        want, tmp = ref_prefill(params, batch, RM.init_cache(rcfg, 1, T, dtype=jdt))
        cache = jax.tree_util.tree_map_with_path(
            lambda path, d, s, b=b: splice(path, d, s, b), cache, tmp
        )
        nblk = -(-len(p) // bs)
        burst = torch.zeros(1, nblk, bs, pool.shape[2], dtype=pool.dtype)
        kv_out = burst.view(1, nblk * bs, *row)[:, : len(p)]
        got = M.prefill(model, torch.from_numpy(p)[None], kv_out, ssm.slot(b))
        np.testing.assert_allclose(_np(got), _np(want), rtol=0, atol=TOL[dtype], err_msg="prefill")
        worst = max(worst, float(np.abs(_np(got) - _np(want)).max()))
        banked_copy(pool, burst, torch.from_numpy(tables[b : b + 1, :nblk]))

    if dtype == "float32":  # the prefills' final states and conv tails
        np.testing.assert_allclose(_np(ssm.ssm), _np(cache["ssm"]["ssm"]), rtol=0, atol=1e-4)
        np.testing.assert_allclose(_np(ssm.conv), _np(cache["ssm"]["conv"]), rtol=2**-7, atol=1e-4)
    pos = np.array([len(p) for p in prompts])
    for step in range(4):
        toks = rng.integers(0, cfg.padded_vocab, (2, 1))
        want, cache = ref_decode(params, cache, jnp.asarray(toks, jnp.int32), jnp.asarray(pos))
        w = np.stack([[0, 1], tables[[0, 1], pos // bs], pos % bs]).astype(np.int64)
        w = torch.from_numpy(w)
        lengths = torch.from_numpy((pos + 1).astype(np.int32))
        paged = M.PagedKV(
            pool.view(NB, bs, *row), torch.from_numpy(tables), lengths, w[0], w[1], w[2]
        )
        got = M.decode_step(model, torch.from_numpy(toks), torch.from_numpy(pos), paged, ssm)
        np.testing.assert_allclose(
            _np(got), _np(want), rtol=0, atol=TOL[dtype], err_msg=f"decode step {step}"
        )
        worst = max(worst, float(np.abs(_np(got) - _np(want)).max()))
        pos = pos + 1
    if dtype == "float32":  # after the decode steps, which read the bf16 conv window
        want_ssm = _np(cache["ssm"]["ssm"])
        scale = np.abs(want_ssm).max()
        np.testing.assert_allclose(_np(ssm.ssm), want_ssm, rtol=0, atol=STATE_REL * scale)
        np.testing.assert_allclose(_np(ssm.conv), _np(cache["ssm"]["conv"]), rtol=2**-7, atol=1e-4)
    return worst


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("blocks", list(BLOCKS), ids=list(BLOCKS))
def test_prefill_and_decode_match_reference(blocks, dtype, record_property):
    record_property("max_abs_logit_gap", prefill_and_decode_gap(BLOCKS[blocks], dtype))


def test_engine_matches_reference(monkeypatch):
    """The port's engine (pool rows for the attention layers, each slot's
    SSM state beside them) and the reference's ``ServingEngine`` on a
    FULL_SSD-shaped smoke mix: the same slots every step, the same blocks,
    the same KV access record and the same tokens (float32 compute)."""
    spec = SMOKE_SSD
    cfg, model, rcfg, params = _pair(8, "float32")
    monkeypatch.setattr(ref_engine, "M", _reference_model_module(jnp.float32))
    prompts = serve.make_prompts(cfg, spec, seed=2)
    serve.check_mix(cfg, spec, prompts)
    assert any(len(p) > 32 for p in prompts) and any(len(p) < 32 for p in prompts)
    ref_rec = ref_record.KVAccessRecorder()
    ref = ref_engine.ServingEngine(
        rcfg,
        params,
        max_batch=spec.max_batch,
        max_len=spec.max_len,
        block_size=spec.block_size,
        recorder=ref_rec,
    )
    ref_reqs = [ref.submit(p, max_new_tokens=spec.max_new_tokens) for p in prompts]
    rec = record.KVAccessRecorder()
    ours, reqs = serve.new_engine(cfg, model, spec, prompts, recorder=rec)
    assert ours.kv_layers.shape[2:] == (1, 2, 1, 16)
    assert ours.ssm.ssm.shape == (1, 7, spec.max_batch, 8, 16, 16)
    assert _drive(ours) == _drive(ref)
    assert ours.steps == ref.steps
    assert _key(rec.record) == _key(ref_rec.record)
    assert [r.out_tokens for r in reqs] == [r.out_tokens for r in ref_reqs]


def test_the_launcher_refuses_what_the_reference_asserts():
    full = get_config(ARCH)
    with pytest.raises(ValueError, match="FULL_SSD"):
        serve.check_mix(full, serve.FULL, serve.make_prompts(full, serve.FULL))
    serve.check_mix(full, serve.FULL_SSD, serve.make_prompts(full, serve.FULL_SSD))
    cfg, model, _, _ = _pair(8, "float32")
    eng, _ = serve.new_engine(cfg, model, serve.SMOKE, [np.arange(40) % 7])
    with pytest.raises(ValueError, match="whole number of chunks"):
        eng.run()  # 40 tokens: no whole number of 32-token chunks
