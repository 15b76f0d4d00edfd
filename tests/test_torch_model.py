"""The port's dense stack against the JAX package: ``prefill`` and
``decode_step`` logits on ``smoke(stablelm-1.6b)`` and on a GQA variant
(``num_kv_heads=2``), with the same weights on both sides.

Weights come from the port's seeded init (``state_tree``) and go to the
reference as its parameter tree, so both sides hold the same numbers in every
process.  The KV store has the compute dtype on both sides (the reference's
``init_cache`` takes it): a bfloat16 store under float32 compute would turn a
last-bit difference of the two float32 sums into a whole bf16 step of K or V
now and then.  Tolerances on the logits (whose magnitude is ~4):
  float32: 1e-4 — the same float32 arithmetic in another summation order;
  bfloat16: 0.5 — the two frameworks round matmul outputs, activations and
  the attention weights (the reference rounds P to bf16 before P·V, the port
  does not) at different places, and the fan-in init's sharp attention
  amplifies a rounding step: on the GQA case below the reference's own
  bfloat16 decode logits differ from its float32 ones by up to 0.41.
The decode side goes through the port's pool: each prompt's K/V burst is
scattered into seeded block tables by ``banked_copy`` and decode attends
through them, where the reference keeps a dense cache.
"""

import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.configs import smoke as ref_smoke  # noqa: E402
from repro.models import model as RM  # noqa: E402
from repro_torch.configs import get_config, smoke  # noqa: E402
from repro_torch.interop import model_from_reference  # noqa: E402
from repro_torch.kernels.banked_copy.ops import banked_copy  # noqa: E402
from repro_torch.models import model as M  # noqa: E402

ARCH = "stablelm-1.6b"
TOL = {"float32": 1e-4, "bfloat16": 0.5}
DTYPES = {"float32": (torch.float32, jnp.float32), "bfloat16": (torch.bfloat16, jnp.bfloat16)}


def _pair(arch, overrides, dtype):
    """(ref cfg, ref params, port cfg, port model) with shared weights."""
    cfg = smoke(get_config(arch), **overrides)
    tree = M.init_params(cfg, 0, device="cpu", compute_dtype=torch.float32).state_tree()
    td = DTYPES[dtype][0]
    model = model_from_reference(cfg, tree, device="cpu", compute_dtype=td, kv_dtype=td)
    ref_cfg = ref_smoke(ref_get_config(arch), **overrides)
    return ref_cfg, jax.tree_util.tree_map(jnp.asarray, tree), cfg, model


def _np(x):
    return np.asarray(x, np.float32) if not torch.is_tensor(x) else x.float().numpy()


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("overrides", [{}, {"num_kv_heads": 2}], ids=["mha", "gqa"])
def test_prefill_and_decode_match_reference(overrides, dtype):
    prefill_and_decode_gap(ARCH, overrides, dtype)


def prefill_and_decode_gap(arch: str, overrides: dict, dtype: str) -> float:
    """Two prompts prefilled and decoded for 4 steps on both sides of
    ``smoke(arch)``; each step's logits held to ``TOL[dtype]``.  Returns the
    largest gap seen (``tests/test_torch_model_moe.py`` runs it on its arch)."""
    ref_cfg, ref_params, cfg, model = _pair(arch, overrides, dtype)
    jdt = DTYPES[dtype][1]
    ref_prefill = jax.jit(functools.partial(RM.prefill, ref_cfg, compute_dtype=jdt))
    ref_decode = jax.jit(functools.partial(RM.decode_step, ref_cfg, compute_dtype=jdt))
    rng = np.random.default_rng(11)
    prompts = [rng.integers(0, cfg.vocab_size, n) for n in (11, 6)]
    T, bs, NB = 24, 4, 16
    L, G, D = cfg.num_layers, cfg.num_kv_heads, cfg.resolved_head_dim
    worst = 0.0

    # reference: B=1 prefills into their own caches, spliced into a B=2 cache
    cache = RM.init_cache(ref_cfg, 2, T, dtype=jdt)
    # port: the same prompts' K/V bursts scattered into the pool
    pool = torch.zeros(NB, bs, L * 2 * G * D, dtype=model.kv_dtype)
    perm = rng.permutation(NB)
    tables = np.stack([perm[:6], perm[6:12]]).astype(np.int32)
    for b, p in enumerate(prompts):
        batch = {"tokens": jnp.asarray(p, jnp.int32)[None]}
        want, tmp = ref_prefill(ref_params, batch, RM.init_cache(ref_cfg, 1, T, dtype=jdt))
        cache = jax.tree_util.tree_map(lambda d, s, b=b: d.at[:, b : b + 1].set(s), cache, tmp)
        nblk = -(-len(p) // bs)
        burst = torch.zeros(1, nblk, bs, pool.shape[2], dtype=pool.dtype)
        kv_out = burst.view(1, nblk * bs, L, 2, G, D)[:, : len(p)]
        got = M.prefill(model, torch.from_numpy(p)[None], kv_out)
        np.testing.assert_allclose(_np(got), _np(want), rtol=0, atol=TOL[dtype], err_msg="prefill")
        worst = max(worst, float(np.abs(_np(got) - _np(want)).max()))
        banked_copy(pool, burst, torch.from_numpy(tables[b : b + 1, :nblk]))

    pos = np.array([len(p) for p in prompts])
    for step in range(4):
        toks = rng.integers(0, cfg.padded_vocab, (2, 1))
        want, cache = ref_decode(
            ref_params, cache, jnp.asarray(toks, jnp.int32), jnp.asarray(pos, jnp.int32)
        )
        blk = tables[[0, 1], pos // bs]
        w = torch.from_numpy(np.stack([[0, 1], blk, pos % bs]).astype(np.int64))
        lengths = torch.from_numpy((pos + 1).astype(np.int32))
        paged = M.PagedKV(
            pool.view(NB, bs, L, 2, G, D), torch.from_numpy(tables), lengths, w[0], w[1], w[2]
        )
        got = M.decode_step(model, torch.from_numpy(toks), torch.from_numpy(pos), paged)
        np.testing.assert_allclose(
            _np(got), _np(want), rtol=0, atol=TOL[dtype], err_msg=f"decode step {step}"
        )
        worst = max(worst, float(np.abs(_np(got) - _np(want)).max()))
        pos = pos + 1
    return worst


def test_converter_round_trip_and_casts():
    cfg = smoke(get_config(ARCH), num_kv_heads=2)
    tree = M.init_params(cfg, 3, device="cpu", compute_dtype=torch.float32).state_tree()
    model = model_from_reference(cfg, tree, device="cpu", compute_dtype=torch.bfloat16)
    assert model.layers[1].attn.wq.dtype == torch.bfloat16
    assert model.layers[1].attn_norm.scale.dtype == torch.float32  # norms stay float32
    assert model.final_norm.bias.dtype == torch.float32
    back = model_from_reference(cfg, tree, device="cpu", compute_dtype=torch.float32).state_tree()
    for path, leaf in jax.tree_util.tree_leaves_with_path(tree):
        np.testing.assert_array_equal(
            leaf, functools.reduce(lambda t, k: t[k.key], path, back), err_msg=str(path)
        )
    bad = dict(tree, embed=tree["embed"][:, :8])
    with pytest.raises(ValueError, match="shape"):
        model.load_tree(bad)


def test_reference_init_tree_loads():
    """The reference's own init output converts as it is (numpy leaves)."""
    ref_cfg = ref_smoke(ref_get_config(ARCH))
    params = jax.tree_util.tree_map(np.asarray, RM.init_params(ref_cfg, 0))
    cfg = smoke(get_config(ARCH))
    assert dataclasses.asdict(cfg) == dataclasses.asdict(ref_cfg)
    model = model_from_reference(cfg, params, device="cpu", compute_dtype=torch.float32)
    w_up = params["layers"]["ffn"]["w_up"]
    np.testing.assert_array_equal(model.layers[0].ffn.w_up.numpy(), w_up[0])
    np.testing.assert_array_equal(model.lm_head.numpy(), params["lm_head"])


def test_model_defaults_to_cuda():
    cfg = smoke(get_config(ARCH))
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA card; the default is taken")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        M.init_params(cfg)
