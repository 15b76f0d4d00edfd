"""MLA's pieces of the port against the JAX package, on ``smoke(deepseek-v2-lite-16b)``
(kv_lora_rank 32, qk_nope 16, qk_rope 8, v_head 16, 4 heads) and at the
latent call's full shapes where they are cheap: ``MLAAttention``'s prefill
and both decode forms against the reference's ``mla_attention``, the plain
flash attention at a V width of its own against ``chunked_attention`` and
``attention_ref``, and the plain latent paged call against the reference's
``paged_attention_ref`` with the latent pool passed as K and V.

Inputs come from numpy seeds and go to both sides.  Tolerances of the
attention layer, as the largest abs difference over the largest abs entry
of the reference's output (magnitudes up to ~15 here):
  float32: 2e-6 (the same float32 arithmetic in another summation order;
  the absorbed form sums the scores' two parts in one dot product where the
  reference adds two);
  bfloat16: 1e-2, 2.5 bf16 steps at the top of the range (both sides round
  the projections, the up-projected K and V and the output to bf16 at the
  same places, but the reference rounds P to bf16 before P V and the port's
  plain versions do not);
  bfloat16 across forms: 3e-2 (measured 9.0e-3).  XLA's CPU backend runs no
  bf16 x bf16 -> float32 dot of the shape the reference's absorbed decode
  takes, so in bf16 the port's absorbed form is held to the reference's
  non-absorbed one: the same function, with ``q_nope w_uk`` rounded to bf16
  where the other form rounds the up-projected K and V.
The plain kernels' versions: abs 2e-5 in float32, 2e-2 (flash) and 3e-2
(paged) in bf16 on outputs of magnitude ~1, ``tests/test_kernels.py``'s.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.configs import smoke as ref_smoke  # noqa: E402
from repro.kernels.flash_attention.ref import attention_ref  # noqa: E402
from repro.kernels.paged_attention.ref import paged_attention_ref as ref_paged  # noqa: E402
from repro.models import attention as RA  # noqa: E402
from repro_torch.configs import check_supported, get_config, smoke  # noqa: E402
from repro_torch.kernels.flash_attention.ref import (  # noqa: E402
    flash_attention_fwd_ref,
    flash_attention_ref,
)
from repro_torch.kernels.paged_attention.ops import LATENT, blocks_per_split  # noqa: E402
from repro_torch.kernels.paged_attention.ref import (  # noqa: E402
    paged_attention_ref,
    paged_attention_split_ref,
)
from repro_torch.models.attention import MLAAttention, PagedKV, mla_specs  # noqa: E402

ARCH = "deepseek-v2-lite-16b"
DTYPES = {"float32": (torch.float32, jnp.float32), "bfloat16": (torch.bfloat16, jnp.bfloat16)}
TOL = {"float32": 2e-6, "bfloat16": 1e-2, "across forms": 3e-2}
#: the reference's layer, jitted (its bf16 products with float32 results run
#: only compiled on this CPU)
REF_MLA = jax.jit(RA.mla_attention, static_argnums=0, static_argnames=("decode", "absorbed"))


def _np(x):
    return x.float().numpy() if torch.is_tensor(x) else np.asarray(x, np.float32)


def _port(a, dtype) -> torch.Tensor:
    """numpy ``a`` rounded to ``dtype`` as the JAX side rounds it."""
    return torch.from_numpy(np.array(jnp.asarray(a, DTYPES[dtype][1]), np.float32)).to(
        DTYPES[dtype][0]
    )


def _close(got, want, dtype, msg):
    got, want = _np(got), _np(want)
    gap = float(np.abs(got - want).max() / np.abs(want).max())
    assert gap <= TOL[dtype], f"{msg}: {gap} of the largest entry"


def _layer(cfg, rng, dtype):
    """One MLA layer's weights by the reference's init rules (numpy), the
    port's module holding them and the reference's ``p``."""
    p = {}
    for name, spec in mla_specs(cfg).items():
        if spec.init == "ones":
            p[name] = np.ones(spec.shape, np.float32)
        else:
            p[name] = (rng.standard_normal(spec.shape) / np.sqrt(spec.shape[-2])).astype(np.float32)
    p["kv_norm"] = (1 + 0.1 * rng.standard_normal(p["kv_norm"].shape)).astype(np.float32)
    mod = MLAAttention(cfg, DTYPES[dtype][0])
    with torch.no_grad():
        for name, val in p.items():
            getattr(mod, name).copy_(torch.from_numpy(val))
    return mod, {k: jnp.asarray(v) for k, v in p.items()}


def test_mla_config_is_the_reference_and_served():
    cfg, ref = get_config(ARCH), ref_get_config(ARCH)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(ref)
    check_supported(cfg)  # served: no raise
    assert cfg.latent_dim == 576 and cfg.num_params() == ref.num_params() == 16_210_309_120
    got, want = smoke(cfg), ref_smoke(ref)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.num_params() == want.num_params() and got.latent_dim == 40
    assert set(mla_specs(cfg)) == set(RA.mla_specs(ref))
    for name, spec in mla_specs(cfg).items():
        assert spec.shape == RA.mla_specs(ref)[name].shape, name


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_mla_prefill_and_both_decode_forms_match_reference(dtype):
    """A B = 2 prefill of 11 tokens into the reference's cache and the port's
    staging rows (scattered into pool blocks), then 3 decode steps at ragged
    positions in each form; outputs and the cached rows held to the
    reference's."""
    cfg, ref_cfg = smoke(get_config(ARCH)), ref_smoke(ref_get_config(ARCH))
    rng = np.random.default_rng(5)
    td, jdt = DTYPES[dtype]
    mod, p = _layer(cfg, rng, dtype)
    B, S, T, bs, NB = 2, 11, 24, 4, 16
    W = cfg.latent_dim
    x = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(S), (B, S))

    cache = RA.init_mla_cache(ref_cfg, 1, B, T, dtype=jdt)
    layer0 = {k: v[0] for k, v in cache.items()}
    xj, pj, slot = jnp.asarray(x, jdt), jnp.asarray(pos), jnp.int32(0)
    want, layer0 = REF_MLA(ref_cfg, p, xj, pj, cache_layer=layer0, cache_slot=slot)
    kv_out = torch.zeros(B, S, W, dtype=td)
    positions = torch.from_numpy(pos.copy())
    got = mod.prefill(_port(x, dtype), positions, kv_out, kv_dtype=td, impl="kernel")
    _close(got, want, dtype, "prefill")
    rows = np.concatenate([_np(layer0["c_kv"]), _np(layer0["k_pe"])], -1)[:, :S]
    _close(kv_out, rows, dtype, "latent rows")

    # the port's pool: one layer of latent rows, each slot's tokens in its own blocks
    pool = torch.zeros(NB, bs, 1, W, dtype=td)
    tables = rng.permutation(NB)[: 2 * (T // bs)].reshape(2, T // bs).astype(np.int32)
    for b in range(B):
        for t in range(S):
            pool[tables[b, t // bs], t % bs, 0] = kv_out[b, t]
    lens = np.array([S, S - 3])  # slot 1 decodes from position 8 on
    caches = {True: (layer0, pool.clone()), False: (layer0, pool.clone())}
    for step in range(3):
        xd = rng.standard_normal((B, 1, cfg.d_model)).astype(np.float32)
        for absorbed, (ref_layer, ref_pool) in list(caches.items()):
            # XLA's CPU backend has no bf16 x bf16 -> float32 dot of the shape
            # the reference's absorbed form takes: in bf16 both of the port's
            # forms are held to the reference's non-absorbed one (the same function)
            want, ref_layer = REF_MLA(
                ref_cfg,
                p,
                jnp.asarray(xd, jdt),
                jnp.asarray(lens[:, None]),
                cache_layer=ref_layer,
                cache_slot=jnp.asarray(lens),
                decode=True,
                absorbed=absorbed and dtype == "float32",
            )
            w = torch.from_numpy(np.stack([[0, 1], tables[[0, 1], lens // bs], lens % bs]))
            lengths = torch.from_numpy((lens + 1).astype(np.int32))
            paged = PagedKV(ref_pool, torch.from_numpy(tables), lengths, w[0], w[1], w[2])
            xt, positions = _port(xd, dtype), torch.from_numpy(lens[:, None])
            got = mod.decode(xt, positions, paged, 0, impl="kernel", absorbed=absorbed)
            across = absorbed and dtype == "bfloat16"
            _close(got, want, "across forms" if across else dtype, f"step {step}, {absorbed=}")
            caches[absorbed] = (ref_layer, ref_pool)
        lens = lens + 1


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize(
    "B,S,T,H,G,D,Dv,causal",
    [
        (1, 37, 37, 4, 4, 24, 16, True),  # smoke(deepseek-v2-lite-16b)'s prefill
        (2, 130, 130, 2, 2, 192, 128, True),  # the full widths
        (1, 64, 100, 4, 2, 192, 128, False),  # GQA 2:1, ragged T, no mask
    ],
)
def test_plain_flash_at_its_own_v_width_matches_reference(B, S, T, H, G, D, Dv, causal, dtype):
    rng = np.random.default_rng(S + D)
    q = rng.standard_normal((B, S, H, D)).astype(np.float32)
    k = rng.standard_normal((B, T, G, D)).astype(np.float32)
    v = rng.standard_normal((B, T, G, Dv)).astype(np.float32)
    scale = (D + 7) ** -0.5  # not D ** -0.5: the caller's scale is used
    jdt = DTYPES[dtype][1]
    M = H // G
    qp = jnp.broadcast_to(jnp.arange(S), (B, S))
    kp = jnp.broadcast_to(jnp.arange(T), (B, T))
    qj = jnp.asarray(q, jdt).reshape(B, S, G, M, D)
    kj, vj = jnp.asarray(k, jdt), jnp.asarray(v, jdt)
    want = RA.chunked_attention(
        qj, kj, vj, qp, kp, causal=causal, scale=scale, q_block=64, kv_block=64
    ).reshape(B, S, H, Dv)
    qt, kt, vt = (_port(a, dtype) for a in (q, k, v))
    got = flash_attention_ref(qt, kt, vt, causal=causal, scale=scale)
    assert got.shape == (B, S, H, Dv)
    tol = 2e-5 if dtype == "float32" else 2e-2
    np.testing.assert_allclose(_np(got), _np(want), rtol=0, atol=tol)
    got_blockwise, _ = flash_attention_fwd_ref(
        qt, kt, vt, causal=causal, scale=scale, q_block=48, kv_block=32
    )
    np.testing.assert_allclose(_np(got_blockwise), _np(want), rtol=0, atol=tol)
    if G == H:  # attention_ref takes the heads pre-broadcast
        bh = lambda a: jnp.asarray(a, jdt).transpose(0, 2, 1, 3).reshape(B * H, -1, a.shape[-1])
        ref = attention_ref(bh(q), bh(k), bh(v), causal=causal, scale=scale)
        ref = np.asarray(ref, np.float32).reshape(B, H, S, Dv).transpose(0, 2, 1, 3)
        np.testing.assert_allclose(_np(got), ref, rtol=0, atol=tol)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_plain_latent_paged_call_matches_reference(dtype):
    """The latent call at its full shapes (16 heads, K rows of 576, V their
    first 512 columns) over a strided layer view of an all-layer pool, ragged
    lengths, a ragged last block and an idle slot (length 0, all -1 row),
    against the reference's ``paged_attention_ref`` with the latent pool as K
    and as V, its output cut to 512; and the split-and-merge arithmetic at
    the latent call's split against the plain version."""
    H, Dk, Dv = LATENT
    rng = np.random.default_rng(7)
    B, NB, bs, mb, L = 4, 40, 8, 9, 3
    lens = np.array([65, 9, 0, 72], np.int32)  # 65: a ragged last block; 0: idle
    pool = rng.standard_normal((NB, bs, L, Dk)).astype(np.float32)
    q = rng.standard_normal((B, H, Dk)).astype(np.float32) * 0.3
    perm = rng.permutation(NB)
    tables = np.full((B, mb), -1, np.int32)
    used = 0
    for b, n in enumerate(lens):
        nb = -(-int(n) // bs)
        tables[b, :nb] = perm[used : used + nb]
        used += nb
    scale = 192**-0.5
    jdt = DTYPES[dtype][1]
    lat_j = jnp.asarray(pool[:, :, 1], jdt)[:, :, None]
    want = ref_paged(
        jnp.asarray(q, jdt), lat_j, lat_j, jnp.asarray(tables), jnp.asarray(lens), scale=scale
    )[..., :Dv]
    kv = _port(pool, dtype)[:, :, 1, None]
    qt = _port(q, dtype)
    lt, tt = torch.from_numpy(lens), torch.from_numpy(tables)
    got = paged_attention_ref(qt, kv, kv[..., :Dv], tt, lt, scale=scale)
    assert got.shape == (B, H, Dv)
    live = lens > 0  # the reference returns V's mean over block 0 for an idle slot
    tol = 2e-5 if dtype == "float32" else 3e-2
    np.testing.assert_allclose(_np(got)[live], _np(want)[live], rtol=0, atol=tol)
    assert (got[~torch.from_numpy(live)] == 0).all()
    bps = blocks_per_split(bs, latent=True)
    split = paged_attention_split_ref(
        qt, kv, kv[..., :Dv], tt, lt, blocks_per_split=bps, scale=scale
    )
    np.testing.assert_allclose(_np(split), _np(got), rtol=0, atol=tol)
