"""The plain versions of the three attention kernels at head dim 80
(stablelm-3b; the kernels' D = 80 instantiations are held to these on the
card) against the JAX package, on the same numpy-seeded inputs:

  * flash: ``flash_attention_ref`` against the reference's ``attention_ref``
    and, in float32, its Pallas kernel in interpret mode (float32 2e-5, bf16
    2e-2: ``tests/test_torch_attention_kernels.py``'s bounds); the forward's
    log-sum-exp against ``_flash_fwd_scan`` and the plain backward against
    ``jax.vjp`` of ``chunked_attention`` (whose custom VJP is
    ``_flash_vjp_bwd``), float32 within 1e-5 (``tests/test_torch_flash_bwd.py``'s
    bound and small blocks);
  * the bf16 kernels' roundings replayed in float32 at D = 80: P rounded
    before P V within flash's 2e-2, and the backward's within half the
    card's bound (5e-3 of the largest entry);
  * paged: ``paged_attention_ref`` against the reference's ``ref.py`` and, in
    float32, its Pallas kernel in interpret mode, at 1, 2, 4 and 8 query
    heads per KV group (float32 2e-5, bf16 3e-2), and the kernel's split and
    merge arithmetic (``paged_attention_split_ref``) against the plain
    version.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels.flash_attention.kernel import flash_attention_fwd  # noqa: E402
from repro.kernels.flash_attention.ref import attention_ref  # noqa: E402
from repro.kernels.paged_attention.ops import paged_attention as ref_paged_kernel  # noqa: E402
from repro.kernels.paged_attention.ref import paged_attention_ref as ref_paged  # noqa: E402
from repro.models import attention as RA  # noqa: E402
from repro_torch.kernels.flash_attention.ref import (  # noqa: E402
    flash_attention_bwd_ref,
    flash_attention_fwd_ref,
    flash_attention_ref,
)
from repro_torch.kernels.paged_attention.ref import (  # noqa: E402
    paged_attention_ref,
    paged_attention_split_ref,
)
from test_torch_attention_kernels import DTYPES, _flash_rounded_p, _np, _to_port  # noqa: E402
from test_torch_flash_bwd import (  # noqa: E402
    BF16_ROUNDING_TOL,
    _bf16,
    _bwd_with_bf16_roundings,
    _positions,
)

D = 80
TOL = 1e-5
QB, KB = 16, 32


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize(
    "BH,BG,S,T,causal,win",
    [(4, 4, 128, 128, True, 0), (4, 2, 128, 256, False, 0), (2, 1, 256, 256, True, 32)],
)
def test_flash_plain_matches_reference(BH, BG, S, T, causal, win, dtype):
    rng = np.random.default_rng(BH * S + T + win)
    q, k, v = rng.normal(size=(BH, S, D)), rng.normal(size=(BG, T, D)), rng.normal(size=(BG, T, D))
    jd = DTYPES[dtype][1]
    jq, jk, jv = (jnp.asarray(a, jd) for a in (q, k, v))
    kb, vb = jnp.repeat(jk, BH // BG, 0), jnp.repeat(jv, BH // BG, 0)
    wants = [attention_ref(jq, kb, vb, causal=causal, window=win)]
    if dtype == "float32":
        wants.append(
            flash_attention_fwd(
                jq, jk, jv, causal=causal, window=win, q_block=128, kv_block=128, interpret=True
            )
        )
    pq, pk, pv = (_to_port(a, dtype).transpose(0, 1)[None] for a in (q, k, v))
    got = flash_attention_ref(pq, pk, pv, causal=causal, window=win)[0].transpose(0, 1)
    assert got.shape == (BH, S, D)
    tol = 2e-5 if dtype == "float32" else 2e-2
    for want in wants:
        np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol)


def _inputs(B, S, T, H, G):
    rng = np.random.default_rng(S * 100 + T + H)
    q = rng.standard_normal((B, S, H, D), dtype=np.float32)
    k = rng.standard_normal((B, T, G, D), dtype=np.float32)
    v = rng.standard_normal((B, T, G, D), dtype=np.float32)
    dout = rng.standard_normal((B, S, H, D), dtype=np.float32)
    return q, k, v, dout


#: B, S, T, H, G, causal, window: causal MHA, GQA 2:1 with a ragged S, ragged
#: T with no mask, a window
TRAIN_CASES = [
    (2, 64, 64, 4, 4, True, 0),
    (1, 45, 45, 4, 2, True, 0),
    (1, 40, 71, 2, 1, False, 0),
    (1, 64, 64, 4, 2, True, 24),
]


@pytest.mark.parametrize("B,S,T,H,G,causal,window", [c for c in TRAIN_CASES if c[1] % QB == 0])
def test_plain_forward_lse_matches_reference_scan(B, S, T, H, G, causal, window):
    q, k, v, _ = _inputs(B, S, T, H, G)
    pad = -T % KB
    kp = np.pad(k, ((0, 0), (0, pad), (0, 0), (0, 0)))
    vp = np.pad(v, ((0, 0), (0, pad), (0, 0), (0, 0)))
    kv_pos = jnp.pad(_positions(B, T), ((0, 0), (0, pad)), constant_values=-1)
    qg = jnp.asarray(q).reshape(B, S, G, H // G, D)
    args = (jnp.asarray(kp), jnp.asarray(vp), _positions(B, S), kv_pos)
    out, lse = RA._flash_fwd_scan(qg, *args, causal, window, QB, KB, D**-0.5, False)
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    blocks = dict(causal=causal, window=window, q_block=QB, kv_block=KB)
    got_out, got_lse = flash_attention_fwd_ref(tq, tk, tv, **blocks)
    np.testing.assert_allclose(got_out.numpy(), np.asarray(out).reshape(B, S, H, D), TOL, TOL)
    np.testing.assert_allclose(got_lse.numpy(), np.asarray(lse).reshape(B, H, S), TOL, TOL)


@pytest.mark.parametrize("B,S,T,H,G,causal,window", TRAIN_CASES)
def test_plain_backward_matches_reference_vjp(B, S, T, H, G, causal, window):
    q, k, v, dout = _inputs(B, S, T, H, G)
    blocks = dict(causal=causal, window=window, q_block=QB, kv_block=KB)

    def attend(q, k, v):
        qg = q.reshape(B, S, G, H // G, D)
        o = RA.chunked_attention(qg, k, v, _positions(B, S), _positions(B, T), **blocks)
        return o.reshape(B, S, H, D)

    _, vjp = jax.vjp(attend, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = vjp(jnp.asarray(dout))
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    out, lse = flash_attention_fwd_ref(tq, tk, tv, **blocks)
    got = flash_attention_bwd_ref(tq, tk, tv, out, lse, torch.from_numpy(dout), **blocks)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        assert a.shape[-1] == D
        np.testing.assert_allclose(a.numpy(), np.asarray(b), TOL, TOL, err_msg=name)


@pytest.mark.parametrize(
    "B,S,T,H,G,causal,window",
    [(1, 517, 517, 8, 8, True, 0), (1, 100, 333, 8, 1, False, 0), (1, 300, 300, 8, 2, True, 64)],
)
def test_flash_bf16_p_rounding_stays_within_tolerance(B, S, T, H, G, causal, window):
    """The bf16 forward kernel's one extra rounding (P to bf16 before P V)
    at D = 80 keeps the output within flash's bf16 bound of 2e-2."""
    rng = np.random.default_rng(S + T + D)
    q, k, v = (
        torch.from_numpy(rng.normal(size=s).astype(np.float32)).bfloat16()
        for s in ((B, S, H, D), (B, T, G, D), (B, T, G, D))
    )
    got = _flash_rounded_p(q, k, v, causal=causal, window=window)
    want = flash_attention_ref(q, k, v, causal=causal, window=window)
    torch.testing.assert_close(got.float(), want.float(), rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize("H,G", [(4, 4), (4, 1)], ids=["mha", "gqa4"])
def test_bf16_roundings_of_the_backward_stay_within_half_the_card_bound(H, G):
    """At S = 1024, causal: each of dQ, dK, dV with the bf16 backward
    kernel's roundings replayed, against ``jax.vjp`` of ``chunked_attention``
    on the same bf16 inputs, within 5e-3 of its largest entry."""
    B, S = 1, 1024
    rng = np.random.default_rng(D + G)
    q, dout = (rng.standard_normal((B, S, H, D), dtype=np.float32) for _ in range(2))
    k, v = (rng.standard_normal((B, S, G, D), dtype=np.float32) for _ in range(2))
    q, k, v, dout = (_bf16(torch.from_numpy(x)) for x in (q, k, v, dout))

    def attend(q, k, v):
        qg = q.reshape(B, S, G, H // G, D)
        o = RA.chunked_attention(qg, k, v, _positions(B, S), _positions(B, S), causal=True)
        return o.reshape(B, S, H, D)

    _, vjp = jax.vjp(attend, *(jnp.asarray(x.numpy()) for x in (q, k, v)))
    want = vjp(jnp.asarray(dout.numpy()))
    out, lse = flash_attention_fwd_ref(q, k, v, causal=True)
    got = _bwd_with_bf16_roundings(q, k, v, _bf16(out), lse, dout, causal=True, window=0)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        b = torch.from_numpy(np.array(b))
        rel = float((a - b).abs().max() / b.abs().max())
        assert rel <= BF16_ROUNDING_TOL, (name, rel)


def _paged_inputs(rng, B, H, G, NB, bs, mb):
    q, kp, vp = (rng.normal(size=s) for s in ((B, H, D), (NB, bs, G, D), (NB, bs, G, D)))
    tbl = np.full((B, mb), -1, np.int32)
    lens = np.zeros((B,), np.int32)
    for b in range(B - 1):  # the last request is empty
        n = int(rng.integers(1, mb + 1))
        tbl[b, :n] = rng.choice(NB, n, replace=False)
        lens[b] = n * bs - int(rng.integers(0, bs))
    return q, kp, vp, tbl, lens


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("heads_per_group", [1, 2, 4, 8])
def test_paged_plain_matches_reference(heads_per_group, dtype):
    G = 2
    B, H, NB, bs, mb = 3, G * heads_per_group, 32, 8, 6
    q, kp, vp, tbl, lens = _paged_inputs(np.random.default_rng(H), B, H, G, NB, bs, mb)
    jd = DTYPES[dtype][1]
    args = [jnp.asarray(a, jd) for a in (q, kp, vp)] + [jnp.asarray(tbl), jnp.asarray(lens)]
    wants = [ref_paged(*args)]
    if dtype == "float32":
        wants.append(ref_paged_kernel(*args, interpret=True))
    got = paged_attention_ref(
        *(_to_port(a, dtype) for a in (q, kp, vp)), torch.from_numpy(tbl), torch.from_numpy(lens)
    )
    # the empty request gets 0, as the Pallas kernel gives it (the reference's
    # ref.py a mean of V: ROADMAP Queue 3), so the live requests are compared
    assert got.shape == (B, H, D) and bool((got[B - 1] == 0).all())
    tol = 2e-5 if dtype == "float32" else 3e-2
    for want in wants:
        np.testing.assert_allclose(_np(got)[: B - 1], _np(want)[: B - 1], rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5), (torch.bfloat16, 3e-2)])
@pytest.mark.parametrize("bps", [1, 3, 8])
def test_paged_split_and_merge_matches_plain(bps, dtype, tol):
    """The kernel's split and merge arithmetic at D = 80, 4 heads a group:
    splits of one block to more than the table, an empty request."""
    rng = np.random.default_rng(bps)
    q, kp, vp, tbl, lens = _paged_inputs(rng, 5, 8, 2, 64, 4, 9)
    q, kp, vp = (torch.from_numpy(x.astype(np.float32)).to(dtype) for x in (q, kp, vp))
    tbl, lens = torch.from_numpy(tbl), torch.from_numpy(lens)
    got = paged_attention_split_ref(q, kp, vp, tbl, lens, blocks_per_split=bps)
    want = paged_attention_ref(q, kp, vp, tbl, lens)
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)
    assert (got[4] == 0).all()
