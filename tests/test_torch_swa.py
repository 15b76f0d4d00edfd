"""Sliding-window attention in the port (h2o-danube-1.8b) against the JAX
package on the CPU.

  * ``paged_attention_ref`` with a window against the reference's decode
    attention (``direct_attention(..., window=w)``) on the same gathered K/V
    and positions, float32, within 2e-6 (one float32 summation order
    against another); ``paged_attention_split_ref`` (the GQA kernel's split
    and merge, a split wholly before the window giving no partial) against
    ``paged_attention_ref`` at h2o-danube's 33-split table with the window's
    start inside a split, on a split boundary and after 16 and more dead
    splits, within 2e-6;
  * smoke(h2o-danube-1.8b) (window 16): prefill and decode logits against
    the reference's ``prefill``/``decode_step``, whose cache rolls 16 slots,
    with a 32-token prompt (the reference's rolling prefill: two windows)
    and an 11-token one, decoded for 10 steps across the window; the same
    tolerances as ``tests/test_torch_model.py`` (float32 1e-4, bfloat16 0.5,
    the reasons there);
  * the engine on ``serve.SMOKE`` (prompts of 4..15 tokens, 8 new tokens,
    64-token contexts: decode crosses the 16-token window) against the
    reference engine, whose cache is ``cache_length(cfg, 64) = 16`` slots:
    slots per step, blocks, step count, the KV access record and every
    token, in float32;
  * ``forward_train``'s gradients at the smoke size against
    ``jax.value_and_grad`` of the reference run in float64, sequences of 40
    tokens (2.5 windows), within 2e-4 of a leaf's largest entry
    (``tests/test_torch_train_dense.py``'s bound and reason).
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
from repro.models import attention as ref_attn  # noqa: E402
from repro.models import model as RM  # noqa: E402
from repro.models.layers import cross_entropy as ref_cross_entropy  # noqa: E402
from repro.serving import record as ref_record  # noqa: E402
from repro_torch.configs import get_config, smoke  # noqa: E402
from repro_torch.configs.base import RunConfig  # noqa: E402
from repro_torch.interop import model_from_reference, train_state_to_reference  # noqa: E402
from repro_torch.kernels.banked_copy.ops import banked_copy  # noqa: E402
from repro_torch.kernels.paged_attention.ref import (  # noqa: E402
    paged_attention_ref,
    paged_attention_split_ref,
)
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.serving import record  # noqa: E402
from repro_torch.train import step as S  # noqa: E402
from repro_torch.tree import leaves_with_path  # noqa: E402
from test_torch_record import _key  # noqa: E402
from test_torch_serving import _drive, _reference_model_module  # noqa: E402

ARCH = "h2o-danube-1.8b"
TOL = {"float32": 1e-4, "bfloat16": 0.5}
DTYPES = {"float32": (torch.float32, jnp.float32), "bfloat16": (torch.bfloat16, jnp.bfloat16)}
GRAD_TOL = 2e-4


def test_config_and_smoke_match_reference():
    cfg, ref = get_config(ARCH), ref_get_config(ARCH)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(ref)
    assert cfg.num_params() == ref.num_params() == 1835130880
    assert dataclasses.asdict(smoke(cfg)) == dataclasses.asdict(ref_smoke(ref))
    assert smoke(cfg).sliding_window == 16


def _pool_case(rng, B, G, m, D, bs, mb, lengths):
    NB = B * mb + 3
    k = rng.normal(size=(NB, bs, G, D)).astype(np.float32)
    v = rng.normal(size=(NB, bs, G, D)).astype(np.float32)
    q = rng.normal(size=(B, G * m, D)).astype(np.float32)
    tbl = np.full((B, mb), -1, np.int32)
    perm = rng.permutation(NB)
    for b, n in enumerate(lengths):
        used = -(-n // bs)
        tbl[b, :used] = perm[b * mb : b * mb + used]
    return q, k, v, tbl, np.asarray(lengths, np.int32)


@pytest.mark.parametrize("window", [1, 5, 16, 37, 64, 200])
def test_paged_window_matches_reference_decode_attention(window):
    rng = np.random.default_rng(window)
    B, G, m, D, bs, mb = 4, 2, 4, 16, 8, 12
    lengths = [96, 61, 1, 0]  # a full table, a ragged one, one token, an idle slot
    q, k, v, tbl, lens = _pool_case(rng, B, G, m, D, bs, mb, lengths)
    t = torch.from_numpy
    got = paged_attention_ref(t(q), t(k), t(v), t(tbl), t(lens), window=window).numpy()
    for b, n in enumerate(lengths):
        if n == 0:
            np.testing.assert_array_equal(got[b], 0.0)
            continue
        tok = np.arange(n)
        kb = k[tbl[b, tok // bs], tok % bs]  # [n, G, D]
        vb = v[tbl[b, tok // bs], tok % bs]
        want = ref_attn.direct_attention(
            jnp.asarray(q[b].reshape(1, 1, G, m, D)),
            jnp.asarray(kb[None]),
            jnp.asarray(vb[None]),
            jnp.asarray([[n - 1]]),
            jnp.asarray(tok[None]),
            window=window,
        )
        np.testing.assert_allclose(got[b], np.asarray(want).reshape(G * m, D), rtol=0, atol=2e-6)


@pytest.mark.parametrize(
    "lengths",
    [
        [8224, 8192, 5000, 0],  # the WINDOW mix's longest: 16 dead splits, then 17 live
        [8320, 4352, 4097, 300],  # past 16 dead splits; start on a split boundary; 1 dead
        [4096, 4200, 1, 4095],  # one window exactly; the start inside split 0
    ],
    ids=["16-dead", "past-16-dead", "edges"],
)
def test_split_replay_with_window_matches_plain(lengths):
    rng = np.random.default_rng(sum(lengths))
    B, G, m, D, bs, mb = 4, 1, 2, 16, 16, 520  # h2o-danube's table: 33 splits of 256 tokens
    q, k, v, tbl, lens = _pool_case(rng, B, G, m, D, bs, mb, lengths)
    args = [torch.from_numpy(a) for a in (q, k, v, tbl, lens)]
    want = paged_attention_ref(*args, window=4096)
    got = paged_attention_split_ref(*args, blocks_per_split=16, window=4096)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=2e-6)
    unwindowed = paged_attention_ref(*args)
    assert not torch.allclose(want[:2], unwindowed[:2], atol=1e-3)  # the window masks
    with pytest.raises(ValueError, match="window"):
        paged_attention_split_ref(*args, splits=16, window=4096)


def _pair(dtype):
    cfg = smoke(get_config(ARCH))
    tree = M.init_params(cfg, 0, device="cpu", compute_dtype=torch.float32).state_tree()
    td = DTYPES[dtype][0]
    model = model_from_reference(cfg, tree, device="cpu", compute_dtype=td, kv_dtype=td)
    return ref_smoke(ref_get_config(ARCH)), jax.tree_util.tree_map(jnp.asarray, tree), cfg, model


def _np(x):
    return np.asarray(x, np.float32) if not torch.is_tensor(x) else x.float().numpy()


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_prefill_and_decode_across_the_window_match_reference(dtype, record_property):
    ref_cfg, ref_params, cfg, model = _pair(dtype)
    jdt = DTYPES[dtype][1]
    win = cfg.sliding_window
    assert RM.cache_length(ref_cfg, 64) == win
    ref_prefill = jax.jit(functools.partial(RM.prefill, ref_cfg, compute_dtype=jdt))
    ref_decode = jax.jit(functools.partial(RM.decode_step, ref_cfg, compute_dtype=jdt))
    rng = np.random.default_rng(12)
    prompts = [rng.integers(0, cfg.vocab_size, n) for n in (2 * win, 11)]
    bs, mb = 4, 12
    NB, row = 2 * mb, model.kv_row_shape()
    pool = torch.zeros(NB, bs, model.kv_width(), dtype=model.kv_dtype)
    tables = rng.permutation(NB).reshape(2, mb).astype(np.int32)
    cache = RM.init_cache(ref_cfg, 2, win, dtype=jdt)
    worst = 0.0
    for b, p in enumerate(prompts):
        batch = {"tokens": jnp.asarray(p, jnp.int32)[None]}
        want, tmp = ref_prefill(ref_params, batch, RM.init_cache(ref_cfg, 1, win, dtype=jdt))
        cache = jax.tree_util.tree_map(lambda d, s, b=b: d.at[:, b : b + 1].set(s), cache, tmp)
        nblk = -(-len(p) // bs)
        burst = torch.zeros(1, nblk, bs, pool.shape[2], dtype=pool.dtype)
        kv_out = burst.view(1, nblk * bs, *row)[:, : len(p)]
        got = M.prefill(model, torch.from_numpy(p)[None], kv_out)
        np.testing.assert_allclose(_np(got), _np(want), rtol=0, atol=TOL[dtype], err_msg="prefill")
        worst = max(worst, float(np.abs(_np(got) - _np(want)).max()))
        banked_copy(pool, burst, torch.from_numpy(tables[b : b + 1, :nblk]))
    pos = np.array([len(p) for p in prompts])
    for step in range(10):  # the 11-token prompt's decode crosses position 16
        toks = rng.integers(0, cfg.padded_vocab, (2, 1))
        want, cache = ref_decode(
            ref_params, cache, jnp.asarray(toks, jnp.int32), jnp.asarray(pos, jnp.int32)
        )
        w = np.stack([[0, 1], tables[[0, 1], pos // bs], pos % bs]).astype(np.int64)
        w = torch.from_numpy(w)
        paged = M.PagedKV(
            pool.view(NB, bs, *row),
            torch.from_numpy(tables),
            torch.from_numpy((pos + 1).astype(np.int32)),
            w[0],
            w[1],
            w[2],
        )
        got = M.decode_step(model, torch.from_numpy(toks), torch.from_numpy(pos), paged)
        np.testing.assert_allclose(
            _np(got), _np(want), rtol=0, atol=TOL[dtype], err_msg=f"decode step {step}"
        )
        worst = max(worst, float(np.abs(_np(got) - _np(want)).max()))
        pos = pos + 1
    record_property("max_abs_logit_gap", worst)


def test_engine_matches_reference_across_the_window(monkeypatch):
    spec = serve.SMOKE
    cfg = smoke(get_config(ARCH))
    tree = M.init_params(cfg, 0, device="cpu", compute_dtype=torch.float32).state_tree()
    monkeypatch.setattr(ref_engine, "M", _reference_model_module(jnp.float32))
    model = model_from_reference(
        cfg, tree, device="cpu", compute_dtype=torch.float32, kv_dtype=torch.float32
    )
    prompts = serve.make_prompts(cfg, spec, seed=5)
    assert max(map(len, prompts)) + spec.max_new_tokens > cfg.sliding_window
    ref_rec = ref_record.KVAccessRecorder()
    ref = ref_engine.ServingEngine(
        ref_smoke(ref_get_config(ARCH)),
        jax.tree_util.tree_map(jnp.asarray, tree),
        max_batch=spec.max_batch,
        max_len=spec.max_len,
        block_size=spec.block_size,
        recorder=ref_rec,
    )
    assert ref.cache["k"].shape[2] == cfg.sliding_window  # the reference rolls 16 slots
    ref_reqs = [ref.submit(p, max_new_tokens=spec.max_new_tokens) for p in prompts]
    rec = record.KVAccessRecorder()
    ours, reqs = serve.new_engine(cfg, model, spec, prompts, recorder=rec)
    assert _drive(ours) == _drive(ref)
    assert ours.steps == ref.steps
    assert _key(rec.record) == _key(ref_rec.record)
    assert [r.out_tokens for r in reqs] == [r.out_tokens for r in ref_reqs]


def test_forward_train_gradients_match_jax_grad():
    cfg = smoke(get_config(ARCH))
    run = RunConfig(compute_dtype="float32", remat_policy="none")
    state = S.init_train_state(cfg, run, 0, device="cpu")
    rcfg = ref_smoke(ref_get_config(ARCH))
    tree = train_state_to_reference(state)["params"]
    rng = np.random.default_rng(3)
    batch = {
        "tokens": rng.integers(0, cfg.vocab_size, (2, 40)).astype(np.int32),
        "labels": rng.integers(0, cfg.vocab_size, (2, 40)).astype(np.int32),
    }

    def loss_fn(p):
        tokens = {"tokens": jnp.asarray(batch["tokens"])}
        logits, _ = RM.forward_train(
            rcfg, p, tokens, compute_dtype=jnp.float64, remat_policy="none"
        )
        return ref_cross_entropy(logits, jnp.asarray(batch["labels"]), rcfg.vocab_size)

    with jax.enable_x64(True):
        params = jax.tree_util.tree_map(lambda x: jnp.asarray(x, jnp.float64), tree)
        loss, want = jax.value_and_grad(loss_fn)(params)
        loss, want = float(loss), jax.tree_util.tree_map(np.asarray, want)
    grads, metrics = S.make_grad_fn(cfg, run)(state, batch)
    np.testing.assert_allclose(float(metrics["loss"]), loss, rtol=1e-5)
    want = dict(leaves_with_path(want))
    got = dict(leaves_with_path(grads))
    assert sorted(got) == sorted(want)
    for path, g in got.items():
        scale = np.abs(want[path]).max()
        np.testing.assert_allclose(
            g.numpy(), want[path], rtol=0, atol=GRAD_TOL * scale, err_msg=path
        )
    # the window shapes the gradients: without it they differ
    nowin = dataclasses.replace(cfg, sliding_window=0)
    state0 = S.init_train_state(nowin, run, 0, device="cpu")
    grads0, _ = S.make_grad_fn(nowin, run)(state0, batch)
    wq = ("layers", "attn", "wq")
    g1 = dict(leaves_with_path(grads))
    g0 = dict(leaves_with_path(grads0))
    key = next(p for p in g1 if all(k in p for k in wq))
    assert not torch.allclose(g1[key], g0[key], atol=1e-6)
