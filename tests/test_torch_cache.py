"""The port's contiguous-cache serving steps (``models.model.init_cache``,
``prefill_cache``, ``decode_step_cache``; ``train.step.make_prefill_step``
and ``make_decode_step``) against the reference's ``init_cache``,
``prefill`` and ``decode_step``, on the dense and MoE smoke configs, with
the same weights on both sides (``test_torch_model._pair``).  The other
families' files (``test_torch_cache_{swa,mla,ssm,encdec}.py``) import
``run_pair`` from here.

Both sides prefill two prompts of ``S`` tokens into ``T``-slot caches,
then decode a few steps; every step's logits and, after the last, every
cache leaf are held to the reference's.  Caches take the compute dtype
(float32 here, as the pool-form tests' stores do).  Tolerances: float32
logits (magnitude ~4) within 1e-4 and cache leaves within 1e-5 of each
leaf's largest entry (K reaches ~10), the same float32 arithmetic in
another order of summation (an SSM's conv window, bf16 on both sides,
within one bf16 step; the port's paged kernel
adds over the cache's slots in splits, the reference's softmax in one
pass); bfloat16 logits within 0.5, as ``test_torch_model.py`` explains.
The cache form is also held to the port's own pool form
(``prefill``/``decode_step`` through a paged pool) on the same prompts,
within 1e-5: the same kernels over the same rows.
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import RunConfig as RefRunConfig  # noqa: E402
from repro.models import model as RM  # noqa: E402
from repro.train import step as RS  # noqa: E402
from repro_torch.configs.base import RunConfig  # noqa: E402
from repro_torch.kernels.banked_copy.ops import banked_copy  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models.attention import mla_cache_tree  # noqa: E402
from repro_torch.train import step as S_  # noqa: E402
from test_torch_model import DTYPES, _np, _pair  # noqa: E402

TOL = {"float32": 1e-4, "bfloat16": 0.5}
CACHE_TOL = 1e-5
POOL_TOL = 1e-5


def port_tree(cfg, cache: dict) -> dict:
    """The port's cache as the reference's tree (MLA: ``c_kv``/``k_pe``)."""
    if cfg.use_mla:
        return mla_cache_tree(cache, cfg)
    return cache


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, (*prefix, k))
        else:
            yield (*prefix, k), v


def run_pair(
    arch,
    *,
    overrides=None,
    dtype="float32",
    S=8,
    T=16,
    pos0=None,
    steps=4,
    absorbed=False,
    ref_absorbed=None,
    frames=False,
    seed=0,
    pair=None,
):
    """Prefill two prompts of ``S`` tokens into ``T``-slot caches on both
    sides, then ``steps`` decode steps from ``pos0`` (default ``S``; a list
    is one position a row).  Returns ``(port logits, reference logits)``
    per call (prefill first) as float32 numpy, both final caches as
    reference-shaped trees of numpy arrays, and the port's model and its
    decode inputs ``(tokens, positions)`` per step."""
    ref_cfg, ref_params, cfg, model = pair or _pair(arch, overrides or {}, dtype)
    tdt, jdt = DTYPES[dtype]
    ref_absorbed = absorbed if ref_absorbed is None else ref_absorbed
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (2, S)).astype(np.int32)
    batch, fr = {"tokens": jnp.asarray(toks)}, None
    if frames:
        fr = rng.standard_normal((2, cfg.encoder_seq_len, cfg.d_model)).astype(np.float32)
        batch["frames"] = jnp.asarray(fr)
    ref_prefill = jax.jit(functools.partial(RM.prefill, ref_cfg, compute_dtype=jdt))
    ref_decode = jax.jit(
        functools.partial(RM.decode_step, ref_cfg, compute_dtype=jdt, mla_absorbed=ref_absorbed)
    )
    want, rc = ref_prefill(ref_params, batch, RM.init_cache(ref_cfg, 2, T, dtype=jdt))
    cache = M.init_cache(cfg, 2, T, tdt, device="cpu")
    got, cache = M.prefill_cache(
        model, torch.from_numpy(toks), cache, frames=None if fr is None else torch.from_numpy(fr)
    )
    out = [(_np(got), _np(want))]
    pos = np.asarray(S if pos0 is None else pos0)
    inputs = []
    for _ in range(steps):
        t = rng.integers(0, cfg.vocab_size, (2, 1)).astype(np.int32)
        want, rc = ref_decode(ref_params, rc, jnp.asarray(t), jnp.asarray(pos, jnp.int32))
        got, cache = M.decode_step_cache(
            model, cache, torch.from_numpy(t), torch.from_numpy(pos), mla_absorbed=absorbed
        )
        out.append((_np(got), _np(want)))
        inputs.append((t, pos.copy()))
        pos = np.asarray(pos + 1)
    port = {k: _np(v) for k, v in _leaves(port_tree(cfg, cache))}
    ref = {tuple(p.key for p in path): np.asarray(v) for path, v in
           jax.tree_util.tree_leaves_with_path(rc)}
    return out, port, ref, model, toks, inputs


def check_pair(res, dtype="float32", tol=None, cache_tol=CACHE_TOL):
    """Every call's logits within ``TOL[dtype]`` (or ``tol``) and, in
    float32, every cache leaf within ``cache_tol`` of its largest entry
    (``pos`` exactly)."""
    out, port, ref = res[:3]
    for i, (got, want) in enumerate(out):
        name = "prefill" if i == 0 else f"decode step {i - 1}"
        np.testing.assert_allclose(got, want, rtol=0, atol=tol or TOL[dtype], err_msg=name)
    assert set(port) == set(ref)
    for k in ref:
        assert port[k].shape == ref[k].shape, k
        if k[-1] == "pos":
            np.testing.assert_array_equal(port[k], ref[k], err_msg=str(k))
        elif dtype == "float32":
            atol = cache_tol * max(1.0, float(np.abs(ref[k]).max()))
            # an SSM's conv window is bf16 on both sides: a float32 difference
            # past a rounding boundary moves it by one bf16 step (2 ** -7 relative)
            rtol = 2**-7 if k[-1] == "conv" else 0
            np.testing.assert_allclose(port[k], ref[k], rtol=rtol, atol=atol, err_msg=str(k))


def pool_logits(model, toks, inputs, *, absorbed=False):
    """The port's pool form on the same prompts and decode inputs: the
    prompts' K/V bursts scattered into a pool of 4-row blocks by
    ``banked_copy``, each step through ``PagedKV``.  Returns the prefill's
    and each step's logits."""
    B, S = toks.shape
    bs = 4
    steps = len(inputs)
    nblk = -(-(S + steps) // bs)
    row = model.kv_row_shape()
    pool = torch.zeros(B * nblk, bs, model.kv_width(), dtype=model.kv_dtype)
    tables = np.arange(B * nblk, dtype=np.int32).reshape(B, nblk)[:, ::-1].copy()
    out = []
    for b in range(B):
        nb = -(-S // bs)
        burst = torch.zeros(1, nb, bs, pool.shape[2], dtype=pool.dtype)
        kv_out = burst.view(1, nb * bs, *row)[:, :S]
        out.append(_np(M.prefill(model, torch.from_numpy(toks[b : b + 1]), kv_out)))
        banked_copy(pool, burst, torch.from_numpy(tables[b : b + 1, :nb]))
    res = [np.concatenate(out)]
    for t, pos in inputs:
        pos = np.broadcast_to(pos, (B,))
        w = torch.from_numpy(np.stack([np.arange(B), tables[np.arange(B), pos // bs], pos % bs]))
        paged = M.PagedKV(
            pool.view(B * nblk, bs, *row),
            torch.from_numpy(tables),
            torch.from_numpy((pos + 1).astype(np.int32)),
            *w.long(),
        )
        res.append(
            _np(M.decode_step(model, torch.from_numpy(t), torch.from_numpy(pos.copy()), paged,
                              mla_absorbed=absorbed))
        )
    return res


CASES = {
    "stablelm-mha": ("stablelm-1.6b", {}),
    "stablelm-gqa": ("stablelm-1.6b", {"num_kv_heads": 2}),
    "olmoe": ("olmoe-1b-7b", {}),
}


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("case", list(CASES))
def test_prefill_and_decode_match_reference(case, dtype):
    arch, overrides = CASES[case]
    check_pair(run_pair(arch, overrides=overrides, dtype=dtype), dtype)


@pytest.mark.parametrize("case", ["stablelm-gqa", "olmoe"])
def test_per_row_positions(case):
    """``pos`` a ``[B]`` vector: row 1 rewinds into its prompt (slots past
    its position hold later positions, which the reference's mask and the
    port's ``lengths = pos + 1`` both leave out)."""
    arch, overrides = CASES[case]
    check_pair(run_pair(arch, overrides=overrides, S=8, pos0=[8, 5], steps=5))


def test_cache_longer_than_the_context_and_a_full_one():
    """A cache of exactly the context's slots (the last step writes its last
    slot) and one of an odd length (blocks of one row)."""
    check_pair(run_pair("stablelm-1.6b", overrides={"num_kv_heads": 2}, S=8, T=12, steps=4))
    check_pair(run_pair("stablelm-1.6b", overrides={"num_kv_heads": 2}, S=8, T=13, steps=3))


@pytest.mark.parametrize("case", ["stablelm-gqa", "olmoe"])
def test_cache_form_matches_pool_form(case):
    arch, overrides = CASES[case]
    out, _, _, model, toks, inputs = run_pair(arch, overrides=overrides, S=9, pos0=[9, 6])
    for i, (got, want) in enumerate(zip([o[0] for o in out], pool_logits(model, toks, inputs))):
        np.testing.assert_allclose(got, want, rtol=0, atol=POOL_TOL, err_msg=f"call {i}")


@pytest.mark.parametrize("arch", ["stablelm-1.6b", "deepseek-v2-lite-16b", "mamba2-1.3b",
                                  "jamba-1.5-large-398b", "whisper-base"])
def test_init_cache_tree_matches_reference(arch):
    """Leaves, shapes and dtypes of ``init_cache`` against the reference's
    (MLA's latent row as its ``c_kv`` and ``k_pe``), ``pos`` -1, zeros."""
    ref_cfg, _, cfg, _ = _pair(arch, {}, "float32")
    ref = RM.init_cache(ref_cfg, 3, 16, dtype=jnp.bfloat16)
    port = M.init_cache(cfg, 3, 16, device="cpu")
    got = {k: _np(v) for k, v in _leaves(port_tree(cfg, port))}
    want = {tuple(p.key for p in path): np.asarray(v, np.float32)
            for path, v in jax.tree_util.tree_leaves_with_path(ref)}
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=str(k))
    dt = {k: str(v.dtype) for k, v in _leaves(port)}
    rdt = {tuple(p.key for p in path): str(v.dtype)
           for path, v in jax.tree_util.tree_leaves_with_path(ref)}
    for k, v in dt.items():
        if k[-1] != "latent":
            assert v.replace("torch.", "") == rdt[k], k
    assert M.cache_length(cfg, 32768) == RM.cache_length(ref_cfg, 32768)


def test_prefill_and_decode_steps_match_reference():
    """``make_prefill_step``/``make_decode_step`` against the reference's
    jitted steps (float32 compute), with ``pos`` a scalar; a model built
    for another compute dtype is refused."""
    arch = "stablelm-1.6b"
    ref_cfg, ref_params, cfg, model = _pair(arch, {"num_kv_heads": 2}, "float32")
    run = RunConfig(compute_dtype="float32")
    rrun = RefRunConfig(compute_dtype="float32")
    rng = np.random.default_rng(5)
    toks = rng.integers(0, cfg.vocab_size, (2, 8)).astype(np.int32)
    want, rc = jax.jit(RS.make_prefill_step(ref_cfg, rrun))(
        ref_params, {"tokens": jnp.asarray(toks)}, RM.init_cache(ref_cfg, 2, 12, jnp.float32)
    )
    cache = M.init_cache(cfg, 2, 12, torch.float32, device="cpu")
    got, cache = S_.make_prefill_step(cfg, run)(model, {"tokens": torch.from_numpy(toks)}, cache)
    np.testing.assert_allclose(_np(got), _np(want), rtol=0, atol=TOL["float32"])
    ref_dec = jax.jit(RS.make_decode_step(ref_cfg, rrun))
    dec = S_.make_decode_step(cfg, run)
    for pos in range(8, 12):
        t = rng.integers(0, cfg.vocab_size, (2, 1)).astype(np.int32)
        want, rc = ref_dec(ref_params, rc, jnp.asarray(t), jnp.int32(pos))
        got, cache = dec(model, cache, torch.from_numpy(t), pos)
        np.testing.assert_allclose(_np(got), _np(want), rtol=0, atol=TOL["float32"])
    with pytest.raises(ValueError, match="computes in bfloat16"):
        S_.make_decode_step(cfg, RunConfig())(model, cache, torch.from_numpy(t), 11)
