"""The port's hybrid stack (jamba-1.5-large-398b: super-blocks of one GQA
attention layer and seven SSD layers, a dense FFN at even positions and MoE
at odd ones) against the JAX package on the CPU, the same numbers on both
sides, at ``smoke(jamba)`` (one super-block) and ``smoke(jamba,
num_layers=16)`` (two).

Weights come from the port's seeded init (``state_tree``) and go to the
reference as its parameter tree.  The attention cache has the compute dtype
on both sides and the SSM conv window bf16 on both (the reference's hybrid
cache keeps it so whatever the attention cache's dtype).  Tolerances on the
logits (of order 4-8): float32 2e-4 (the same float32 arithmetic in another
summation order: SSD's chunk einsums, the MoE's combine; twice the dense
tests' 1e-4 for a stack of up to 16 layers: two super-blocks measured
1.1e-4); bfloat16 0.5
(``tests/test_torch_model.py``'s reasons: both frameworks round products
and activations to bf16 at different places; measured up to ~0.2 here).
The engines' token streams are compared exactly (float32 compute).
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
from repro.serving import record as ref_record  # noqa: E402
from repro_torch.configs import get_config, list_archs, smoke  # noqa: E402
from repro_torch.interop import model_from_reference  # noqa: E402
from repro_torch.kernels.banked_copy.ops import banked_copy  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models.layers import iter_specs, keystr  # noqa: E402
from repro_torch.serving import record  # noqa: E402
from test_torch_record import _key  # noqa: E402
from test_torch_serving import _drive, _reference_model_module  # noqa: E402

ARCH = "jamba-1.5-large-398b"
TOL = {"float32": 2e-4, "bfloat16": 0.5}
DTYPES = {"float32": (torch.float32, jnp.float32), "bfloat16": (torch.bfloat16, jnp.bfloat16)}
BLOCKS = {"one-block": 8, "two-blocks": 16}
#: the float32 SSM state after decode steps, as a share of its largest
#: entry: each step reads the conv window in bf16 on both sides, and a
#: float32 projection a last bit apart can round to the neighbouring bf16
#: value (one ulp, 2^-7 relative; near 0, where the projection's float32
#: sum cancels, up to 1e-4 apart: the window is compared so), which moves
#: the state by ~1e-3 of its scale (measured 1.3e-3 at one block)
STATE_REL = 5e-3
#: bf16 training logits: held to the reference's float32 logits within this
#: multiple of the reference's own bf16 run's distance from them (or
#: ``TOL``, whichever is larger): at two super-blocks the fan-in init's
#: network amplifies bf16 rounding, and the reference's own bf16 logits are
#: 1.63 from its float32 ones (the port's 1.55; one block: 0.37 and 0.36)
BF16_OWN_GAP = 1.25
#: a smoke mix shaped as FULL_SSD: prompts above the 32-token chunk cut to
#: whole chunks, 4 slots, so that two waves share the engine
SMOKE_SSD = serve.ServeSpec(
    requests=8,
    prompt_lo=4,
    prompt_hi=80,
    max_new_tokens=8,
    max_batch=4,
    max_len=128,
    block_size=8,
    chunk=32,
)


def _np(x):
    return np.asarray(x, np.float32) if not torch.is_tensor(x) else x.float().numpy()


def _paths(tree):
    return sorted(
        (jax.tree_util.keystr(p), tuple(np.shape(x)))
        for p, x in jax.tree_util.tree_leaves_with_path(tree)
    )


def _pair(num_layers: int, dtype: str):
    """(port cfg, port model, reference cfg, reference params) with shared
    weights; ``A_log`` and ``dt_bias`` drawn off their init constants, as a
    trained model's, so that each takes part."""
    cfg = smoke(get_config(ARCH), num_layers=num_layers)
    rcfg = ref_smoke(ref_get_config(ARCH), num_layers=num_layers)
    tree = M.init_params(cfg, 0, device="cpu", compute_dtype=torch.float32).state_tree()
    rng = np.random.default_rng(7)
    for k in ("A_log", "dt_bias"):
        leaf = tree["layers"]["mamba"]["ssm"][k]
        tree["layers"]["mamba"]["ssm"][k] = (rng.normal(size=leaf.shape) * 0.5).astype(np.float32)
    td = DTYPES[dtype][0]
    model = model_from_reference(cfg, tree, device="cpu", compute_dtype=td, kv_dtype=td)
    return cfg, model, rcfg, jax.tree_util.tree_map(jnp.asarray, tree)


def test_config_counts_and_layout_match_reference():
    cfg, rcfg = get_config(ARCH), ref_get_config(ARCH)
    assert ARCH in list_archs() and len(list_archs()) == 9
    assert dataclasses.asdict(cfg) == dataclasses.asdict(rcfg)
    assert cfg.num_params() == rcfg.num_params() == 397_710_883_072
    for i in range(cfg.num_layers):
        assert cfg.is_attn_layer(i) == rcfg.is_attn_layer(i) == (i % 8 == 0)
        assert cfg.is_moe_layer(i) == rcfg.is_moe_layer(i) == (i % 2 == 1)
    for n in BLOCKS.values():
        s, rs = smoke(cfg, num_layers=n), ref_smoke(rcfg, num_layers=n)
        assert dataclasses.asdict(s) == dataclasses.asdict(rs)
        assert s.num_params() == rs.num_params()
        specs = sorted((keystr(k), v.shape) for k, v in iter_specs(M.param_specs(s)))
        assert specs == _paths(RM.abstract_params(rs))
    assert smoke(cfg).num_layers == ref_smoke(rcfg).num_layers == 8
    # the serving cut: one super-block, 8 of 16 experts, every width the published one
    cut = serve.cut(cfg, layers=8, experts=8)
    rcut = dataclasses.replace(rcfg, num_layers=8, moe_num_experts=8)
    assert cut.num_params() == rcut.num_params() == 25_816_920_320
    model = M.empty_model(cut, device="meta")
    assert sum(p.numel() for p in model.parameters()) == cut.num_params() + 8192  # final norm
    assert model.kv_row_shape() == (1, 2, 8, 128) and model.kv_width() == 2048
    ssm = model.init_ssm_cache(8)
    assert ssm.ssm.shape == (1, 7, 8, 256, 64, 128) and ssm.conv.shape == (1, 7, 8, 3, 16640)
    assert ssm.nbytes() / 8 == 7 * (256 * 64 * 128 * 4 + 3 * 16640 * 2) == 59_419_136


@pytest.mark.parametrize("blocks", list(BLOCKS), ids=list(BLOCKS))
def test_tree_round_trips(blocks):
    cfg, model, rcfg, params = _pair(BLOCKS[blocks], "float32")
    nb = BLOCKS[blocks] // 8
    assert _paths(params) == _paths(RM.abstract_params(rcfg))
    assert params["layers"]["moe"]["moe"]["w_gate"].shape == (nb, 4, 4, 64, 64)
    assert params["layers"]["attn"]["attn"]["wq"].shape == (nb, 64, 4, 16)
    back = model.state_tree()
    for path, leaf in jax.tree_util.tree_leaves_with_path(params):
        np.testing.assert_array_equal(
            np.asarray(leaf),
            functools.reduce(lambda t, k: t[k.key], path, back),
            err_msg=jax.tree_util.keystr(path),
        )
    # block 1's SSM layer 3 is the leaf's slice [1, 3]
    if nb == 2:
        np.testing.assert_array_equal(
            model.layers[1].mamba[3].ssm.w_x.numpy(), params["layers"]["mamba"]["ssm"]["w_x"][1, 3]
        )


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("blocks", list(BLOCKS), ids=list(BLOCKS))
def test_forward_train_matches_reference(blocks, dtype, record_property):
    cfg, model, rcfg, params = _pair(BLOCKS[blocks], dtype)
    jdt = DTYPES[dtype][1]
    tokens = np.random.default_rng(3).integers(0, cfg.vocab_size, (2, 64))
    want, want_aux = jax.jit(
        functools.partial(RM.forward_train, rcfg, compute_dtype=jdt, remat_policy="none")
    )(params, {"tokens": jnp.asarray(tokens, jnp.int32)})
    with torch.no_grad():
        got, aux = M.forward_train(model, torch.from_numpy(tokens), remat_policy="none")
    gap = float(np.abs(_np(got) - _np(want)).max())
    record_property("max_abs_logit_gap", gap)
    if dtype == "bfloat16":  # held to the float32 function as the reference's bf16 run is
        want32, _ = jax.jit(
            functools.partial(
                RM.forward_train, rcfg, compute_dtype=jnp.float32, remat_policy="none"
            )
        )(params, {"tokens": jnp.asarray(tokens, jnp.int32)})
        own = float(np.abs(_np(want) - _np(want32)).max())
        bound = max(TOL[dtype], BF16_OWN_GAP * own)
        assert float(np.abs(_np(got) - _np(want32)).max()) <= bound, (gap, own)
        np.testing.assert_allclose(float(aux), float(want_aux), rtol=1e-2)
        return
    np.testing.assert_allclose(_np(got), _np(want), rtol=0, atol=TOL[dtype])
    np.testing.assert_allclose(float(aux), float(want_aux), rtol=1e-5)


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
