"""The port's SSM stack (mamba2-1.3b: SSD, tied embeddings) against the JAX
package on the CPU, the same numbers on both sides.

Tolerances, float32: 2e-5 on the mixer's pieces (``_causal_conv``,
``ssd_chunked``, ``ssm_block``; the same float32 arithmetic in another
summation order, outputs of order 1), 1e-4 on logits (as
``tests/test_torch_model.py``, logits of order 1-4); bfloat16 logits 0.5
(the reasons there: both frameworks round products and activations to bf16
at different places).  Token streams of the engines are compared exactly
(float32 compute, the SSM conv window in bf16 on both sides as the
reference's cache keeps it).
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
from repro.models import ssm as RS  # noqa: E402
from repro.serving import record as ref_record  # noqa: E402
from repro_torch.configs import get_config, smoke  # noqa: E402
from repro_torch.configs.base import ModelConfig, RunConfig  # noqa: E402
from repro_torch.interop import model_from_reference  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models import ssm  # noqa: E402
from repro_torch.models.layers import iter_specs, keystr  # noqa: E402
from repro_torch.serving import record  # noqa: E402
from repro_torch.train import step as S  # noqa: E402
from test_torch_record import _key  # noqa: E402
from test_torch_serving import _drive, _reference_model_module  # noqa: E402

ARCH = "mamba2-1.3b"
TOL = 2e-5
LOGIT_TOL = {"float32": 1e-4, "bfloat16": 0.5}
DTYPES = {"float32": (torch.float32, jnp.float32), "bfloat16": (torch.bfloat16, jnp.bfloat16)}


def _cfgs(**overrides):
    return smoke(get_config(ARCH), **overrides), ref_smoke(ref_get_config(ARCH), **overrides)


def _close(got, want, tol=TOL, msg=""):
    got = got.float().numpy() if torch.is_tensor(got) else np.asarray(got, np.float32)
    np.testing.assert_allclose(got, np.asarray(want, np.float32), rtol=0, atol=tol, err_msg=msg)


def test_config_counts_and_smoke_match_reference():
    cfg, ref = get_config(ARCH), ref_get_config(ARCH)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(ref)
    assert cfg.num_params() == ref.num_params() == 1345512448
    assert (cfg.d_inner, cfg.ssm_num_heads, cfg.ssm_conv_dim) == (4096, 64, 4352)
    s, rs = _cfgs()
    assert dataclasses.asdict(s) == dataclasses.asdict(rs)
    assert s.num_params() == rs.num_params()
    # 100.7 MB of state a slot at full width: 48 layers of 64 x 64 x 128 float32 + conv
    c = ssm.init_ssm_cache(cfg, cfg.num_layers, 1, device="meta")
    assert c.nbytes() == 48 * (64 * 64 * 128 * 4 + 3 * 4352 * 2) == 101_916_672


@pytest.mark.parametrize("S", [1, 7, 64])
def test_causal_conv_matches_reference(S):
    rng = np.random.default_rng(S)
    x = rng.normal(size=(2, S, 24)).astype(np.float32)
    w = rng.normal(size=(4, 24)).astype(np.float32)
    got = ssm._causal_conv(torch.from_numpy(x), torch.from_numpy(w))
    _close(got, RS._causal_conv(jnp.asarray(x), jnp.asarray(w)))


def _ssd_inputs(rng, b, s, h, p, g, n):
    x = rng.normal(size=(b, s, h, p)).astype(np.float32)
    a_log = -rng.uniform(0.01, 0.5, size=(b, s, h)).astype(np.float32)
    B = rng.normal(size=(b, s, g, n)).astype(np.float32) * 0.5
    C = rng.normal(size=(b, s, g, n)).astype(np.float32) * 0.5
    return x, a_log, B, C


@pytest.mark.parametrize(
    "s,chunk,g,initial",
    [(32, 32, 1, False), (96, 32, 1, False), (96, 32, 2, True), (64, 16, 1, True)],
    ids=["one-chunk", "three-chunks", "groups-initial-state", "four-chunks-initial-state"],
)
def test_ssd_chunked_matches_reference(s, chunk, g, initial):
    rng = np.random.default_rng(s + chunk + g)
    b, h, p, n = 2, 4, 8, 16
    x, a_log, B, C = _ssd_inputs(rng, b, s, h, p, g, n)
    init = rng.normal(size=(b, h, p, n)).astype(np.float32) if initial else None
    t = torch.from_numpy
    y, st = ssm.ssd_chunked(t(x), t(a_log), t(B), t(C), chunk, None if init is None else t(init))
    ry, rst = RS.ssd_chunked(
        *map(jnp.asarray, (x, a_log, B, C)), chunk, None if init is None else jnp.asarray(init)
    )
    _close(y, ry, 5 * TOL)
    _close(st, rst, 5 * TOL)
    assert st.dtype == torch.float32 and y.dtype == torch.float32


def test_ssd_chunked_refuses_what_the_reference_asserts():
    rng = np.random.default_rng(0)
    x, a_log, B, C = _ssd_inputs(rng, 1, 40, 2, 4, 1, 8)
    with pytest.raises(AssertionError):
        RS.ssd_chunked(*map(jnp.asarray, (x, a_log, B, C)), 32)
    with pytest.raises(ValueError, match="whole number of chunks"):
        ssm.ssd_chunked(*map(torch.from_numpy, (x, a_log, B, C)), 32)


def _block_pair(cfg, seed=0):
    """A port ``SSMBlock`` (float32) and the reference's parameter dict of the
    same random numbers (A_log, dt_bias, D and the norm not at their init
    constants, so each takes part)."""
    rng = np.random.default_rng(seed)
    p = {}
    for name, spec in ssm.ssm_specs(cfg).items():
        scale = 1 / np.sqrt(spec.shape[-2]) if len(spec.shape) > 1 else 0.5
        p[name] = (rng.normal(size=spec.shape) * scale).astype(np.float32)
    p["norm"] += 1.0
    blk = ssm.SSMBlock(cfg, torch.float32)
    with torch.no_grad():
        for name, val in p.items():
            getattr(blk, name).copy_(torch.from_numpy(val))
    return blk, {k: jnp.asarray(v) for k, v in p.items()}


def test_ssm_block_three_modes_match_reference():
    cfg, rcfg = _cfgs()
    blk, rp = _block_pair(cfg)
    rng = np.random.default_rng(1)
    u = rng.normal(size=(2, 64, cfg.d_model)).astype(np.float32)
    t = torch.from_numpy
    # train: no state
    want, _ = RS.ssm_block(rcfg, rp, jnp.asarray(u))
    _close(blk(t(u)), want, msg="train")
    # prefill from a nonzero state, two chunks; then a short prompt (S < W - 1)
    for S_ in (64, 2):
        cache = ssm.init_ssm_cache(cfg, 1, 2, conv_dtype=torch.float32)
        st0 = rng.normal(size=cache.ssm.shape[1:]).astype(np.float32)
        cache.ssm[0] = t(st0)
        rc = {"ssm": jnp.asarray(st0), "conv": jnp.zeros(cache.conv.shape[1:], jnp.float32)}
        want, rnew = RS.ssm_block(rcfg, rp, jnp.asarray(u[:, :S_]), cache_layer=rc)
        layer = ssm.SSMCache(cache.ssm[0], cache.conv[0])
        _close(blk(t(u[:, :S_]), layer), want, msg=f"prefill S={S_}")
        _close(layer.ssm, rnew["ssm"], msg="prefill state")
        _close(layer.conv, rnew["conv"], msg="prefill conv tail")
    # decode: one recurrent step from the prefill's state, three times
    for step in range(3):
        u1 = rng.normal(size=(2, 1, cfg.d_model)).astype(np.float32)
        want, rnew = RS.ssm_block(
            rcfg, rp, jnp.asarray(u1), cache_layer={"ssm": rnew["ssm"], "conv": rnew["conv"]},
            decode=True,
        )
        _close(blk(t(u1), layer, decode=True), want, msg=f"decode {step}")
        _close(layer.ssm, rnew["ssm"], msg="decode state")
        _close(layer.conv, rnew["conv"], msg="decode conv window")


def test_chunked_prefill_and_recurrent_decode_agree():
    """The two forms of one function: a prompt through the chunked prefill,
    and the same tokens one at a time through the recurrence from a zero
    state, end in the same state, conv window and output (float32)."""
    cfg, _ = _cfgs()
    blk, _ = _block_pair(cfg, seed=3)
    u = np.random.default_rng(4).normal(size=(2, 64, cfg.d_model)).astype(np.float32)
    u = torch.from_numpy(u)
    a = ssm.init_ssm_cache(cfg, 1, 2, conv_dtype=torch.float32)
    b = ssm.init_ssm_cache(cfg, 1, 2, conv_dtype=torch.float32)
    y = blk(u, ssm.SSMCache(a.ssm[0], a.conv[0]))
    ys = [blk(u[:, i : i + 1], ssm.SSMCache(b.ssm[0], b.conv[0]), decode=True) for i in range(64)]
    _close(torch.cat(ys, 1), y.numpy(), 1e-4)
    _close(b.ssm, a.ssm.numpy(), 1e-4)
    _close(b.conv, a.conv.numpy())  # the raw projections of one token against of 64


def _model_pair(dtype, kv_dtype=None):
    cfg, rcfg = _cfgs()
    tree = M.init_params(cfg, 0, device="cpu", compute_dtype=torch.float32).state_tree()
    with torch.no_grad():  # A_log and dt_bias off their constants, as a trained model's
        rng = np.random.default_rng(7)
        for k in ("A_log", "dt_bias"):
            tree["layers"]["ssm"][k] = rng.normal(size=tree["layers"]["ssm"][k].shape).astype(
                np.float32
            ) * 0.5
    td = DTYPES[dtype][0]
    model = model_from_reference(
        cfg, tree, device="cpu", compute_dtype=td, kv_dtype=kv_dtype or torch.bfloat16
    )
    return cfg, rcfg, tree, model


def test_tree_has_no_lm_head_and_round_trips():
    cfg, rcfg, tree, model = _model_pair("float32")
    ref_tree = RM.init_params(rcfg, 0)
    def paths(t):
        return sorted(jax.tree_util.keystr(p) for p, _ in jax.tree_util.tree_leaves_with_path(t))

    assert paths(tree) == paths(ref_tree)
    assert "lm_head" not in tree and model.lm_head is None
    assert model.kv_row_shape() == (0,) and model.kv_width() == 0
    back = model.state_tree()
    for path, leaf in jax.tree_util.tree_leaves_with_path(tree):
        np.testing.assert_array_equal(
            leaf, functools.reduce(lambda t, k: t[k.key], path, back), err_msg=str(path)
        )


def test_tied_logits_match_reference():
    cfg, rcfg, tree, model = _model_pair("float32")
    x = np.random.default_rng(2).normal(size=(2, 3, cfg.d_model)).astype(np.float32)
    params = jax.tree_util.tree_map(jnp.asarray, tree)
    got = model._logits(torch.from_numpy(x))
    _close(got, model.final_norm(torch.from_numpy(x)) @ model.embed.T, 0)
    # the reference's _logits takes x already normed
    want = RM._logits(rcfg, params, RM.apply_norm(rcfg, params["final_norm"], jnp.asarray(x)))
    _close(got, want, 1e-5)
    assert want.shape == got.shape == (2, 3, cfg.padded_vocab)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_prefill_and_decode_match_reference(dtype, record_property):
    cfg, rcfg, tree, model = _model_pair(dtype)
    jdt = DTYPES[dtype][1]
    params = jax.tree_util.tree_map(jnp.asarray, tree)
    ref_prefill = jax.jit(functools.partial(RM.prefill, rcfg, compute_dtype=jdt))
    ref_decode = jax.jit(functools.partial(RM.decode_step, rcfg, compute_dtype=jdt))
    rng = np.random.default_rng(11)
    prompts = [rng.integers(0, cfg.vocab_size, n) for n in (64, 64)]  # two chunks each
    tokens = np.stack(prompts)
    batch = {"tokens": jnp.asarray(tokens, jnp.int32)}
    want, rcache = ref_prefill(params, batch, RM.init_cache(rcfg, 2, 0))
    cache = model.init_ssm_cache(2)
    got = M.prefill(model, torch.from_numpy(tokens), ssm_out=cache)
    worst = float(np.abs(got.float().numpy() - np.asarray(want, np.float32)).max())
    _close(got, want, LOGIT_TOL[dtype], "prefill")
    pos = np.full(2, 64)
    for step in range(4):
        toks = rng.integers(0, cfg.padded_vocab, (2, 1))
        args = jnp.asarray(toks, jnp.int32), jnp.asarray(pos, jnp.int32)
        want, rcache = ref_decode(params, rcache, *args)
        got = M.decode_step(model, torch.from_numpy(toks), torch.from_numpy(pos), cache)
        _close(got, want, LOGIT_TOL[dtype], f"decode {step}")
        worst = max(worst, float(np.abs(got.float().numpy() - np.asarray(want, np.float32)).max()))
        pos = pos + 1
    if dtype == "float32":
        _close(cache.ssm, rcache["ssm"], 1e-4, "state")
    record_property("max_abs_logit_gap", worst)


def test_engine_matches_reference(monkeypatch):
    spec = serve.SMOKE
    cfg, rcfg, tree, model = _model_pair("float32")
    monkeypatch.setattr(ref_engine, "M", _reference_model_module(jnp.float32))
    prompts = serve.make_prompts(cfg, spec, seed=6)
    serve.check_mix(cfg, spec, prompts)
    ref_rec = ref_record.KVAccessRecorder()
    ref = ref_engine.ServingEngine(
        rcfg,
        jax.tree_util.tree_map(jnp.asarray, tree),
        max_batch=spec.max_batch,
        max_len=spec.max_len,
        block_size=spec.block_size,
        recorder=ref_rec,
    )
    ref_reqs = [ref.submit(p, max_new_tokens=spec.max_new_tokens) for p in prompts]
    rec = record.KVAccessRecorder()
    ours, reqs = serve.new_engine(cfg, model, spec, prompts, recorder=rec)
    assert ours.kv is None and ours.ssm.ssm.shape == (cfg.num_layers, spec.max_batch, 8, 16, 16)
    assert _drive(ours) == _drive(ref)
    assert ours.steps == ref.steps
    assert _key(rec.record) == _key(ref_rec.record)  # the pool's blocks, as the reference's
    assert [r.out_tokens for r in reqs] == [r.out_tokens for r in ref_reqs]


def test_the_engine_and_launcher_refuse_what_the_reference_asserts():
    cfg, _, _, model = _model_pair("float32")
    eng, _ = serve.new_engine(cfg, model, serve.SMOKE, [np.arange(40) % 7])
    with pytest.raises(ValueError, match="whole number of chunks"):
        eng.run()  # 40 tokens: no whole number of 32-token chunks
    full = get_config(ARCH)
    with pytest.raises(ValueError, match="FULL_SSD"):
        serve.check_mix(full, serve.FULL, serve.make_prompts(full, serve.FULL))
    prompts = serve.make_prompts(full, serve.FULL_SSD)
    serve.check_mix(full, serve.FULL_SSD, prompts)
    lens = [len(p) for p in prompts]
    assert all(n <= 256 or n % 256 == 0 for n in lens) and len(lens) == 16
    draws = serve.make_prompts(full, serve.FULL)
    assert all(np.array_equal(p, q[: len(p)]) for p, q in zip(prompts, draws))


def test_forward_train_is_refused():
    """The SSM stack's training forward is no longer refused (it came with
    the hybrid stacks): it runs, with no aux loss, and its logits are the
    serving forward's; nor is the encoder-decoder family (whisper), whose
    parameter specs are the reference's tree."""
    cfg, _ = _cfgs()
    state = S.init_train_state(cfg, RunConfig(compute_dtype="float32"), 0, device="cpu")
    tokens = torch.randint(0, cfg.vocab_size, (2, 32), generator=torch.Generator().manual_seed(0))
    logits, aux = M.forward_train(state.model, tokens)
    assert float(aux) == 0.0 and logits.shape == (2, 32, cfg.padded_vocab)
    with torch.no_grad():
        last = M.prefill(state.model, tokens)
    _close(logits[:, -1:].detach(), last.numpy(), 1e-5)
    whisper = ModelConfig(**dataclasses.asdict(ref_get_config("whisper-base")))
    specs = sorted((keystr(k), v.shape) for k, v in iter_specs(M.param_specs(whisper)))
    ref_tree = RM.abstract_params(ref_get_config("whisper-base"))
    leaves = jax.tree_util.tree_leaves_with_path(ref_tree)
    assert specs == sorted((jax.tree_util.keystr(p), tuple(x.shape)) for p, x in leaves)
