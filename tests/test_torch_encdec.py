"""The port's encoder-decoder stack (whisper-base) against the JAX package on
the CPU, serving, at ``smoke(whisper-base, encoder_seq_len=100)``: two
encoder and two decoder layers of width 64 (4 heads of 16) over 100 frames,
which is no multiple of the flash kernel's 64-row tile, so the last key
tile is ragged and masked by its true length.

Weights come from the port's seeded init (``state_tree``) and go to the
reference as its parameter tree; frames and prompts are drawn with numpy
from a seed.  The reference model attends with ``chunked_attention`` at
prefill and ``direct_attention`` at decode (its Pallas flash kernel, which
leaves padded keys unmasked when non-causal, is not on this path), so the
port's model is held to the reference model.  Tolerances, set after a
first run (measured values in brackets): float32 logits 2e-4 (9.1e-5 at
prefill; of order 4: one float32 summation order against another through
two encoder and two decoder layers whose norms carry random scales, as
``tests/test_torch_hybrid.py``'s bound for a stack that deep), the
encoder's output 1e-4 (3.5e-5, of order 4), the cross K/V written at
prefill within 1e-4 of their largest entry (1.2e-5); bfloat16 logits 0.5
(``tests/test_torch_model.py``'s: both frameworks round products and
activations to bf16 at different places; 0.095 at prefill), the encoder's
bf16 output held to the reference's float32 one within 1.25x the
reference's own bf16 run's distance from it (``BF16_OWN_GAP``: 0.415
against the reference's 0.422), the bf16 cross K/V within 5e-2 of their
largest entry (2.9e-2: they project the encoder's bf16 output, whose two
runs part by 0.105 of ~4).  The float32 runs give both sides a float32
cache, as the dense parity tests do: a bf16 cache under float32 compute
amplifies summation order.  The engines' token streams are compared
exactly in float32.
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
from repro.models import layers as ref_layers  # noqa: E402
from repro.models import model as RM  # noqa: E402
from repro.serving import record as ref_record  # noqa: E402
from repro_torch.configs import get_config, list_archs, smoke  # noqa: E402
from repro_torch.interop import model_from_reference  # noqa: E402
from repro_torch.kernels.banked_copy.ops import banked_copy  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import layers  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models.layers import iter_specs, keystr  # noqa: E402
from repro_torch.serving import record  # noqa: E402
from test_torch_record import _key  # noqa: E402
from test_torch_serving import _drive, _reference_model_module  # noqa: E402

ARCH = "whisper-base"
#: the smoke config's encoder length: no multiple of the kernel's 64-row tile
ENC = 100
TOL = {"float32": 2e-4, "bfloat16": 0.5}
ENC_TOL = 1e-4  # float32
CROSS_REL = {"float32": 1e-4, "bfloat16": 5e-2}
#: bf16 encoder output against the reference's float32 one, as a multiple
#: of the reference's own bf16 output's distance from it
BF16_OWN_GAP = 1.25
DTYPES = {"float32": (torch.float32, jnp.float32), "bfloat16": (torch.bfloat16, jnp.bfloat16)}
#: a smoke mix of SPEECH's shape: 6 requests on 4 slots (a second wave,
#: blocks freed and reused), prompts of 4..15 tokens, 8-token blocks
SMOKE_SPEECH = serve.ServeSpec(
    requests=6, prompt_lo=4, prompt_hi=16, max_new_tokens=8, max_batch=4, max_len=48, block_size=8
)


def _np(x):
    return np.asarray(x, np.float32) if not torch.is_tensor(x) else x.float().numpy()


def _paths(tree):
    return sorted(
        (jax.tree_util.keystr(p), tuple(np.shape(x)))
        for p, x in jax.tree_util.tree_leaves_with_path(tree)
    )


def _cfgs():
    return smoke(get_config(ARCH), encoder_seq_len=ENC), ref_smoke(
        ref_get_config(ARCH), encoder_seq_len=ENC
    )


def _pair(dtype: str):
    """(port cfg, port model, reference cfg, reference params), shared weights;
    the norms' scales and biases and the FFN's biases drawn off their init
    constants (ones and zeros), as a trained model's, so that each takes part."""
    cfg, rcfg = _cfgs()
    tree = M.init_params(cfg, 0, device="cpu", compute_dtype=torch.float32).state_tree()
    rng = np.random.default_rng(5)
    for keys, spec in iter_specs(M.param_specs(cfg)):
        if spec.init in ("ones", "zeros"):
            node = functools.reduce(lambda t, k: t[k], keys[:-1], tree)
            node[keys[-1]] = (
                float(spec.init == "ones") + 0.1 * rng.normal(size=spec.shape)
            ).astype(np.float32)
    td = DTYPES[dtype][0]
    model = model_from_reference(cfg, tree, device="cpu", compute_dtype=td, kv_dtype=td)
    return cfg, model, rcfg, jax.tree_util.tree_map(jnp.asarray, tree)


def _frames(cfg, B, seed=3):
    return np.random.default_rng(seed).normal(size=(B, cfg.encoder_seq_len, cfg.d_model)).astype(
        np.float32
    )


def test_config_counts_and_tree_match_reference():
    cfg, rcfg = get_config(ARCH), ref_get_config(ARCH)
    assert len(list_archs()) == 10 and list_archs()[-1] == ARCH
    assert dataclasses.asdict(cfg) == dataclasses.asdict(rcfg)
    assert cfg.num_params() == rcfg.num_params() == 98_581_504
    specs = sorted((keystr(k), v.shape) for k, v in iter_specs(M.param_specs(cfg)))
    assert specs == _paths(RM.abstract_params(rcfg))  # full size, from specs only
    s, rs = _cfgs()
    assert dataclasses.asdict(smoke(cfg)) == dataclasses.asdict(ref_smoke(rcfg))
    assert smoke(cfg).encoder_seq_len == 16 and smoke(cfg).num_encoder_layers == 2
    assert dataclasses.asdict(s) == dataclasses.asdict(rs) and s.num_params() == rs.num_params()
    model = M.empty_model(cfg, device="meta")
    # the reference counts one scale a layer's norm, no final norm and no
    # bias: 32 LayerNorms' biases, the two final norms' scales and 6 + 6
    # layers' b_in and b_out more than num_params
    extra = 34 * 512 + 12 * (2048 + 512)
    assert sum(p.numel() for p in model.parameters()) == cfg.num_params() + extra
    assert model.kv_row_shape() == (6, 2, 8, 64) and model.kv_width() == 6144
    cross = M.CrossKV.empty(cfg, 8, 16, dtype=torch.bfloat16, device="meta")
    assert cross.kv.shape == (8 * 94, 16, 6, 2, 8, 64) and cross.block_table.shape == (8, 94)
    assert cross.nbytes() / 8 == 94 * 16 * 6 * 2 * 8 * 64 * 2 == 18_481_152


def test_tree_round_trips():
    cfg, model, rcfg, params = _pair("float32")
    assert _paths(params) == _paths(RM.abstract_params(rcfg))
    back = model.state_tree()
    for path, leaf in jax.tree_util.tree_leaves_with_path(params):
        np.testing.assert_array_equal(
            np.asarray(leaf),
            functools.reduce(lambda t, k: t[k.key], path, back),
            err_msg=jax.tree_util.keystr(path),
        )
    np.testing.assert_array_equal(
        model.encoder.layers[1].ffn.w_in.numpy(), params["encoder"]["layers"]["ffn"]["w_in"][1]
    )
    np.testing.assert_array_equal(
        model.layers[1].cross.wk.numpy(), params["layers"]["cross"]["wk"][1]
    )


def test_sinusoids_match_reference():
    got = layers.sinusoidal_positions(1500, 512)
    np.testing.assert_allclose(
        got.numpy(), _np(ref_layers.sinusoidal_positions(1500, 512)), rtol=0, atol=1e-5
    )
    pos = np.random.default_rng(1).integers(0, 4096, (3, 7))
    got = layers.sinusoidal_at(torch.from_numpy(pos), 64)
    want = ref_layers.sinusoidal_at(jnp.asarray(pos), 64)
    assert got.shape == (3, 7, 64) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), _np(want), rtol=0, atol=1e-5)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_encoder_matches_reference(dtype, record_property):
    cfg, model, rcfg, params = _pair(dtype)
    jdt = DTYPES[dtype][1]
    frames = _frames(cfg, 2)
    encode = jax.jit(functools.partial(RM._whisper_encode, rcfg))
    want = encode(params, jnp.asarray(frames).astype(jdt))
    with torch.no_grad():
        got = model.encode(torch.from_numpy(frames))
    assert got.shape == (2, ENC, cfg.d_model) and got.dtype == model.compute_dtype
    gap = float(np.abs(_np(got) - _np(want)).max())
    record_property("max_abs_gap", gap)
    if dtype == "float32":
        assert gap <= ENC_TOL
        return
    want32 = _np(encode(params, jnp.asarray(frames)))
    own = float(np.abs(_np(want) - want32).max())
    assert float(np.abs(_np(got) - want32).max()) <= BF16_OWN_GAP * own, (gap, own)


def _cross_close(got, want, dtype, what):
    scale = np.abs(want).max()
    np.testing.assert_allclose(_np(got), want, rtol=0, atol=CROSS_REL[dtype] * scale, err_msg=what)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_prefill_and_decode_match_reference(dtype, record_property):
    """Two prompts (9 and 14 tokens) over frames of their own, prefilled and
    decoded for 6 steps on both sides: every step's logits within
    ``TOL[dtype]``, the cross K/V written at prefill against the
    reference's ``ck``/``cv``.  The reference splices each B = 1 cache into
    a B = 2 one, as its engine; the port scatters each prompt's self K/V
    burst into seeded block tables and writes the slot's cross rows."""
    cfg, model, rcfg, params = _pair(dtype)
    td, jdt = DTYPES[dtype]
    ref_prefill = jax.jit(functools.partial(RM.prefill, rcfg, compute_dtype=jdt))
    ref_decode = jax.jit(functools.partial(RM.decode_step, rcfg, compute_dtype=jdt))
    rng = np.random.default_rng(11)
    prompts = [rng.integers(0, cfg.vocab_size, n) for n in (9, 14)]
    frames = _frames(cfg, 2, seed=4)
    T, bs, NB = 24, 4, 16
    row = model.kv_row_shape()
    cache = RM.init_cache(rcfg, 2, T, dtype=jdt)
    pool = torch.zeros(NB, bs, model.kv_width(), dtype=model.kv_dtype)
    tables = rng.permutation(NB)[:12].reshape(2, 6).astype(np.int32)
    cross = model.init_cross_kv(2, 8)
    assert cross.block_table.shape == (2, 13)  # ceil(100 / 8) blocks a slot
    worst = 0.0
    for b, p in enumerate(prompts):
        batch = {"tokens": jnp.asarray(p, jnp.int32)[None]}
        batch["frames"] = jnp.asarray(frames[b : b + 1])
        want, tmp = ref_prefill(params, batch, RM.init_cache(rcfg, 1, T, dtype=jdt))
        cache = jax.tree_util.tree_map(lambda d, s, b=b: d.at[:, b : b + 1].set(s), cache, tmp)
        nblk = -(-len(p) // bs)
        burst = torch.zeros(1, nblk, bs, pool.shape[2], dtype=pool.dtype)
        kv_out = burst.view(1, nblk * bs, *row)[:, : len(p)]
        got = M.prefill(
            model,
            torch.from_numpy(p)[None],
            kv_out,
            frames=torch.from_numpy(frames[b : b + 1]),
            cross_out=cross.slot(b),
        )
        np.testing.assert_allclose(_np(got), _np(want), rtol=0, atol=TOL[dtype], err_msg="prefill")
        worst = max(worst, float(np.abs(_np(got) - _np(want)).max()))
        banked_copy(pool, burst, torch.from_numpy(tables[b : b + 1, :nblk]))
        written = cross.slot(b)[0]  # [T_enc, L, 2, G, D]
        assert written.dtype == td
        for n, name in enumerate(("ck", "cv")):
            want_kv = np.moveaxis(_np(tmp[name][:, 0]), 0, 1)  # [T_enc, L, G, D]
            _cross_close(written[:, :, n], want_kv, dtype, f"prompt {b} {name}")
    pos = np.array([len(p) for p in prompts])
    for step in range(6):
        toks = rng.integers(0, cfg.padded_vocab, (2, 1))
        want, cache = ref_decode(params, cache, jnp.asarray(toks, jnp.int32), jnp.asarray(pos))
        w = np.stack([[0, 1], tables[[0, 1], pos // bs], pos % bs]).astype(np.int64)
        w = torch.from_numpy(w)
        lengths = torch.from_numpy((pos + 1).astype(np.int32))
        paged = M.PagedKV(
            pool.view(NB, bs, *row), torch.from_numpy(tables), lengths, w[0], w[1], w[2]
        )
        got = M.decode_step(
            model, torch.from_numpy(toks), torch.from_numpy(pos), paged, cross=cross
        )
        np.testing.assert_allclose(
            _np(got), _np(want), rtol=0, atol=TOL[dtype], err_msg=f"decode step {step}"
        )
        worst = max(worst, float(np.abs(_np(got) - _np(want)).max()))
        pos = pos + 1
    record_property("max_abs_logit_gap", worst)


def test_engine_matches_reference(monkeypatch):
    """The port's engine (self K/V in the pool, each slot's cross K/V beside
    it, zero frames at each admission) and the reference's
    ``ServingEngine``: the same slots every step, the same blocks, the same
    KV access record and the same tokens (float32 compute)."""
    spec = SMOKE_SPEECH
    cfg, model, rcfg, params = _pair("float32")
    monkeypatch.setattr(ref_engine, "M", _reference_model_module(jnp.float32))
    prompts = serve.make_prompts(cfg, spec, seed=3)
    serve.check_mix(cfg, spec, prompts)
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
    assert ours.kv_layers.shape[2:] == (2, 2, 4, 16)
    assert ours.cross.kv.shape == (4 * 13, 8, 2, 2, 4, 16)
    assert _drive(ours) == _drive(ref)
    assert ours.steps == ref.steps
    assert _key(rec.record) == _key(ref_rec.record)
    assert [r.out_tokens for r in reqs] == [r.out_tokens for r in ref_reqs]
    assert ours.stats.admissions == spec.requests


def test_launcher_serves_speech_and_refuses_full(capsys):
    full = get_config(ARCH)
    with pytest.raises(ValueError, match="SPEECH"):
        serve.check_mix(full, serve.FULL, serve.make_prompts(full, serve.FULL))
    with pytest.raises(ValueError, match="SPEECH"):
        serve.check_mix(full, serve.FULL_SSD, serve.make_prompts(full, serve.FULL_SSD))
    prompts = serve.make_prompts(full, serve.SPEECH)
    serve.check_mix(full, serve.SPEECH, prompts)
    lens = [len(p) for p in prompts]
    assert len(lens) == 16 and 4 <= min(lens) and max(lens) <= 224
    assert max(lens) + serve.SPEECH.max_new_tokens < serve.SPEECH.max_len == 448
    serve.main(["--arch", ARCH, "--smoke", "--device", "cpu"])
    out = capsys.readouterr().out.strip().splitlines()[-1]
    assert '"done": 8' in out and '"device": "cpu"' in out
