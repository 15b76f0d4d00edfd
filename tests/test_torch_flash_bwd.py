"""The port's flash attention for training against the JAX package, on the
CPU: the plain blockwise forward's log-sum-exp against the reference's
``_flash_fwd_scan``, and the plain blockwise backward against ``jax.vjp`` of
``chunked_attention`` (whose custom VJP is ``_flash_vjp_bwd``), float32, on
the same numpy-seeded inputs.  Small blocks (q 16, kv 32) so that every case
crosses several blocks both ways.  Tolerance 1e-5 (abs and rel): the same
float32 arithmetic in another order.  The autograd Function of the port (what
the training forward calls; its kernel wrapper takes the plain versions on
CPU tensors) is held to autograd through the plain ``flash_attention_ref``.
The bf16 tensor-core backward's roundings (bf16 operands, P and dS rounded
to bf16 before the products they feed, float32 sums over 64 x 64 tiles,
bf16 outputs), replayed here in float32, are held to ``jax.vjp`` within
half of the card's bound of 1e-2.  MLA's widths (q/k 192, v 128) go through
the plain forward and backward against ``jax.vjp`` too.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.models import attention as RA  # noqa: E402
from repro_torch.kernels.flash_attention.ops import flash_attention_train  # noqa: E402
from repro_torch.kernels.flash_attention.ref import (  # noqa: E402
    attention_mask,
    flash_attention_bwd_ref,
    flash_attention_fwd_ref,
    flash_attention_ref,
)

TOL = 1e-5
QB, KB = 16, 32

CASES = [  # B, S, T, H, G, D, causal, window
    (2, 64, 64, 4, 4, 16, True, 0),  # causal
    (1, 64, 64, 4, 2, 16, True, 0),  # GQA, M = 2
    (2, 45, 45, 4, 2, 16, True, 0),  # ragged S
    (1, 40, 71, 2, 1, 32, False, 0),  # ragged T, no mask
    (1, 64, 64, 4, 2, 16, True, 24),  # window
]


def _inputs(B, S, T, H, G, D):
    rng = np.random.default_rng(S * 100 + T + H)
    q = rng.standard_normal((B, S, H, D), dtype=np.float32)
    k = rng.standard_normal((B, T, G, D), dtype=np.float32)
    v = rng.standard_normal((B, T, G, D), dtype=np.float32)
    dout = rng.standard_normal((B, S, H, D), dtype=np.float32)
    return q, k, v, dout


def _positions(B, n):
    return jnp.broadcast_to(jnp.arange(n, dtype=jnp.int32)[None], (B, n))


@pytest.mark.parametrize("B,S,T,H,G,D,causal,window", [c for c in CASES if c[1] % QB == 0])
def test_plain_forward_lse_matches_reference_scan(B, S, T, H, G, D, causal, window):
    q, k, v, _ = _inputs(B, S, T, H, G, D)
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


@pytest.mark.parametrize("B,S,T,H,G,D,causal,window", CASES)
def test_plain_backward_matches_reference_vjp(B, S, T, H, G, D, causal, window):
    q, k, v, dout = _inputs(B, S, T, H, G, D)

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
        np.testing.assert_allclose(a.numpy(), np.asarray(b), TOL, TOL, err_msg=name)


@pytest.mark.parametrize("B,S,T,H,causal", [(2, 45, 45, 2, True), (1, 40, 71, 2, False)])
def test_plain_backward_at_mla_widths_matches_reference_vjp(B, S, T, H, causal):
    """MLA's training widths, q/k 192 and v 128 (one KV group a head), at
    scale 192^-0.5, as ``mla_attention`` calls ``chunked_attention``."""
    rng = np.random.default_rng(S + T)
    q, k = (rng.standard_normal((B, n, H, 192), dtype=np.float32) for n in (S, T))
    v = rng.standard_normal((B, T, H, 128), dtype=np.float32)
    dout = rng.standard_normal((B, S, H, 128), dtype=np.float32)
    blocks = dict(causal=causal, q_block=QB, kv_block=KB)

    def attend(q, k, v):
        o = RA.chunked_attention(
            q[:, :, :, None], k, v, _positions(B, S), _positions(B, T), scale=192**-0.5, **blocks
        )
        return o[:, :, :, 0]

    want_out, vjp = jax.vjp(attend, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = vjp(jnp.asarray(dout))
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    out, lse = flash_attention_fwd_ref(tq, tk, tv, scale=192**-0.5, **blocks)
    np.testing.assert_allclose(out.numpy(), np.asarray(want_out), TOL, TOL)
    got = flash_attention_bwd_ref(
        tq, tk, tv, out, lse, torch.from_numpy(dout), scale=192**-0.5, **blocks
    )
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        assert a.shape == b.shape
        np.testing.assert_allclose(a.numpy(), np.asarray(b), TOL, TOL, err_msg=name)


@pytest.mark.parametrize("B,S,T,H,G,D,causal,window", CASES)
def test_autograd_function_matches_autograd_of_plain_attention(B, S, T, H, G, D, causal, window):
    q, k, v, dout = _inputs(B, S, T, H, G, D)
    grads = []
    for fn in (flash_attention_train, flash_attention_ref):
        xs = [torch.from_numpy(x).requires_grad_(True) for x in (q, k, v)]
        out = fn(*xs, causal=causal, window=window)
        out.backward(torch.from_numpy(dout))
        grads.append((out.detach(), *(x.grad for x in xs)))
    for name, a, b in zip(("out", "dq", "dk", "dv"), *grads):
        torch.testing.assert_close(a, b, rtol=TOL, atol=TOL, msg=name)


def test_rows_without_keys_get_zero_and_minus_infinity():
    q = torch.randn(1, 3, 2, 16)
    k = torch.zeros(1, 0, 1, 16)
    out, lse = flash_attention_fwd_ref(q, k, k, causal=False)
    assert bool((out == 0).all()) and bool(torch.isneginf(lse).all())
    dq, dk, dv = flash_attention_bwd_ref(q, k, k, out, lse, torch.ones_like(q), causal=False)
    assert bool((dq == 0).all()) and dk.shape == (1, 0, 1, 16)


#: the bf16 roundings' bound: half of the card's ``BWD_REL_TOL`` for bf16
BF16_ROUNDING_TOL = 5e-3


def _bf16(x):
    return x.to(torch.bfloat16).float()


def _bwd_with_bf16_roundings(q, k, v, out, lse, dout, *, causal, window, tile=64):
    """The bf16 backward kernel's arithmetic on float32 tensors whose values
    are bf16: D from the bf16 output, P and dS rounded to bf16 before the
    products they feed (dV += P^T dO, dQ += dS K, dK += dS^T Q), float32
    sums over tile x tile blocks, the outputs rounded to bf16."""
    B, S, H, D = q.shape
    T, G = k.shape[1], k.shape[2]
    M = H // G
    scale = D**-0.5
    qg, do = q.reshape(B, S, G, M, D), dout.reshape(B, S, G, M, D)
    drow = (do * out.reshape(B, S, G, M, D)).sum(-1).permute(0, 2, 3, 1)  # [B, G, M, S]
    lse = lse.reshape(B, G, M, S)
    mask = attention_mask(S, T, causal=causal, window=window)
    dq = torch.zeros((B, S, G, M, D))
    dk, dv = torch.zeros((B, T, G, D)), torch.zeros((B, T, G, D))
    for j0 in range(0, T, tile):
        kj, vj = k[:, j0 : j0 + tile], v[:, j0 : j0 + tile]
        for i0 in range(0, S, tile):
            ok = mask[i0 : i0 + tile, j0 : j0 + tile]
            if not bool(ok.any()):
                continue  # the kernels never load a fully masked tile
            qi, doi = qg[:, i0 : i0 + tile], do[:, i0 : i0 + tile]
            s = torch.einsum("bqgmd,btgd->bgmqt", qi, kj) * scale
            p = torch.where(ok, torch.exp(s - lse[..., i0 : i0 + tile, None]), 0.0)
            dp = torch.einsum("bqgmd,btgd->bgmqt", doi, vj)
            ds = _bf16(p * (dp - drow[..., i0 : i0 + tile, None]) * scale)
            dv[:, j0 : j0 + tile] += torch.einsum("bgmqt,bqgmd->btgd", _bf16(p), doi)
            dq[:, i0 : i0 + tile] += torch.einsum("bgmqt,btgd->bqgmd", ds, kj)
            dk[:, j0 : j0 + tile] += torch.einsum("bgmqt,bqgmd->btgd", ds, qi)
    return _bf16(dq.reshape(B, S, H, D)), _bf16(dk), _bf16(dv)


@pytest.mark.parametrize("H,G", [(4, 4), (4, 1)], ids=["mha", "gqa4"])
@pytest.mark.parametrize("D", [64, 128])
def test_bf16_roundings_of_the_kernel_stay_within_half_the_card_bound(D, H, G):
    """At S = 1024, causal: the largest abs difference of each of dQ, dK, dV
    from ``jax.vjp`` of ``chunked_attention`` on the same bf16 inputs, over
    its largest abs entry, is at most 5e-3."""
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
