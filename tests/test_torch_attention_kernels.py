"""The plain versions of the port's flash-attention, paged-attention and
banked-copy kernels against the JAX package's ``ref.py`` oracles and its
Pallas kernels in interpret mode, at the shapes of ``tests/test_kernels.py``
and with the same tolerances (float32 2e-5; bf16 2e-2 flash, 3e-2 paged;
banked_copy exact).  Also the wrappers' dispatch: plain version for CPU
tensors, kernel or an error otherwise."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.banked_copy.kernel import banked_copy as ref_banked_copy_kernel  # noqa: E402
from repro.kernels.banked_copy.ref import banked_copy_ref as ref_banked_copy  # noqa: E402
from repro.kernels.flash_attention.kernel import flash_attention_fwd  # noqa: E402
from repro.kernels.flash_attention.ref import attention_ref  # noqa: E402
from repro.kernels.paged_attention.ops import paged_attention as ref_paged_kernel  # noqa: E402
from repro.kernels.paged_attention.ref import paged_attention_ref as ref_paged  # noqa: E402
from repro_torch.kernels import LAUNCHES  # noqa: E402
from repro_torch.kernels.banked_copy.ops import banked_copy  # noqa: E402
from repro_torch.kernels.banked_copy.ref import banked_copy_ref  # noqa: E402
from repro_torch.kernels.flash_attention.ops import flash_attention  # noqa: E402
from repro_torch.kernels.flash_attention.ref import (  # noqa: E402
    attention_mask,
    flash_attention_ref,
)
from repro_torch.kernels.paged_attention.ops import blocks_per_split, paged_attention  # noqa: E402
from repro_torch.kernels.paged_attention.ref import (  # noqa: E402
    paged_attention_ref,
    paged_attention_split_ref,
)

DTYPES = {"float32": (torch.float32, jnp.float32), "bfloat16": (torch.bfloat16, jnp.bfloat16)}


def _np(x):
    """float32 (or integer) numpy of a torch tensor or JAX array."""
    if torch.is_tensor(x):
        return x.float().numpy() if x.is_floating_point() else x.numpy()
    a = np.asarray(x)
    return a if a.dtype.kind in "iu" else a.astype(np.float32)


def _to_port(a: np.ndarray, dtype) -> torch.Tensor:
    """The JAX test's array, rounded as the JAX side rounds it."""
    return torch.from_numpy(np.array(jnp.asarray(a, DTYPES[dtype][1]), np.float32)).to(
        DTYPES[dtype][0]
    )


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize(
    "BH,BG,S,T,D,causal,win",
    [
        (4, 2, 256, 256, 64, True, 0),
        (2, 2, 512, 512, 128, True, 0),
        (4, 4, 256, 512, 64, False, 0),
        (2, 1, 256, 256, 64, True, 64),
    ],
)
def test_flash_plain_matches_reference(BH, BG, S, T, D, causal, win, dtype):
    rng = np.random.default_rng(BH * S + T + win)
    q = rng.normal(size=(BH, S, D))
    k = rng.normal(size=(BG, T, D))
    v = rng.normal(size=(BG, T, D))
    jd = DTYPES[dtype][1]
    jq, jk, jv = (jnp.asarray(a, jd) for a in (q, k, v))
    m = BH // BG
    kb, vb = jnp.repeat(jk, m, 0), jnp.repeat(jv, m, 0)
    wants = [attention_ref(jq, kb, vb, causal=causal, window=win)]
    if dtype == "float32":  # interpret mode is slow; the JAX tests hold it to the oracle in bf16
        pallas = flash_attention_fwd(
            jq, jk, jv, causal=causal, window=win, q_block=128, kv_block=128, interpret=True
        )
        wants.append(pallas)
    # port layout: one batch row, heads on axis 2 ([B, S, H, D], [B, T, G, D])
    pq, pk, pv = (_to_port(a, dtype).transpose(0, 1)[None] for a in (q, k, v))
    got = flash_attention_ref(pq, pk, pv, causal=causal, window=win)[0].transpose(0, 1)
    tol = 2e-5 if dtype == "float32" else 2e-2
    for want in wants:
        np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol)


def test_flash_masks_ragged_keys_by_true_length():
    """T = 600 non-causal: the reference's ops.py pads T to 1024 and leaks the
    padding (ROADMAP Queue 3); the port attends to the 600 keys only."""
    rng = np.random.default_rng(5)
    q, k, v = (rng.normal(size=(2, n, 64)).astype(np.float32) for n in (256, 600, 600))
    want = attention_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=False)
    t = [torch.from_numpy(a).transpose(0, 1)[None] for a in (q, k, v)]
    got = flash_attention_ref(*t, causal=False)[0].transpose(0, 1)
    np.testing.assert_allclose(got.numpy(), _np(want), rtol=2e-5, atol=2e-5)


def _paged_inputs(rng, B, mb, NB, bs, empty=()):
    tbl = np.full((B, mb), -1, np.int32)
    lens = np.zeros((B,), np.int32)
    for b in range(B):
        if b in empty:
            continue
        n = int(rng.integers(1, mb + 1))
        tbl[b, :n] = rng.choice(NB, n, replace=False)
        lens[b] = n * bs - int(rng.integers(0, bs))
    return tbl, lens


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize(
    "B,H,G,D,NB,bs,mb",
    [(2, 8, 2, 64, 16, 16, 4), (3, 4, 1, 128, 32, 8, 6), (2, 16, 4, 64, 64, 32, 3)],
)
def test_paged_plain_matches_reference(B, H, G, D, NB, bs, mb, dtype):
    rng = np.random.default_rng(B * H + NB)
    q = rng.normal(size=(B, H, D))
    kp = rng.normal(size=(NB, bs, G, D))
    vp = rng.normal(size=(NB, bs, G, D))
    tbl, lens = _paged_inputs(rng, B, mb, NB, bs)
    jd = DTYPES[dtype][1]
    args = [jnp.asarray(a, jd) for a in (q, kp, vp)] + [jnp.asarray(tbl), jnp.asarray(lens)]
    wants = [ref_paged(*args)]
    if dtype == "float32":  # as for flash: interpret mode in float32 only
        wants.append(ref_paged_kernel(*args, interpret=True))
    got = paged_attention_ref(
        *(_to_port(a, dtype) for a in (q, kp, vp)), torch.from_numpy(tbl), torch.from_numpy(lens)
    )
    tol = 2e-5 if dtype == "float32" else 3e-2
    for want in wants:
        np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol)


def test_paged_empty_request_gets_zero():
    """A request with no valid block returns 0, as the Pallas kernel does
    (the reference's ref.py returns a mean of V there: ROADMAP Queue 3);
    the other rows still match the oracle."""
    rng = np.random.default_rng(6)
    B, H, G, D, NB, bs, mb = 3, 8, 2, 64, 16, 16, 4
    q, kp, vp = (
        rng.normal(size=s).astype(np.float32) for s in ((B, H, D), (NB, bs, G, D), (NB, bs, G, D))
    )
    tbl, lens = _paged_inputs(rng, B, mb, NB, bs, empty=(1,))
    args = [jnp.asarray(a) for a in (q, kp, vp, tbl, lens)]
    pallas = _np(ref_paged_kernel(*args, interpret=True))
    oracle = _np(ref_paged(*args))
    got = paged_attention_ref(*(torch.from_numpy(a) for a in (q, kp, vp, tbl, lens))).numpy()
    np.testing.assert_array_equal(got[1], 0.0)
    np.testing.assert_array_equal(pallas[1], 0.0)
    assert np.abs(oracle[1]).max() > 0.1  # the reference's fault, not carried over
    np.testing.assert_allclose(got[[0, 2]], oracle[[0, 2]], rtol=2e-5, atol=2e-5)


def test_paged_plain_reads_strided_pool_views_and_skips_unset_rows():
    """The engine's pool holds every layer's K and V per token row: a layer's
    K is a strided view, and rows past a request's length may hold anything
    (here NaN) without reaching the result."""
    rng = np.random.default_rng(7)
    NB, bs, L, G, D = 8, 4, 3, 2, 16
    pool = torch.from_numpy(rng.normal(size=(NB, bs, L, 2, G, D)).astype(np.float32))
    tbl = torch.tensor([[5, 2, -1], [7, -1, -1]], dtype=torch.int32)
    lens = torch.tensor([6, 3], dtype=torch.int32)
    pool[2, 2:] = float("nan")
    pool[7, 3:] = float("nan")
    q = torch.from_numpy(rng.normal(size=(2, 4, D)).astype(np.float32))
    got = paged_attention_ref(q, pool[:, :, 1, 0], pool[:, :, 1, 1], tbl, lens)
    dense = paged_attention_ref(
        q, pool[:, :, 1, 0].contiguous(), pool[:, :, 1, 1].contiguous(), tbl, lens
    )
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, dense, rtol=0, atol=0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int32"])
@pytest.mark.parametrize(
    "B,nblk,NB,bs,W", [(2, 4, 32, 16, 128), (3, 2, 16, 8, 256), (1, 8, 64, 32, 64)]
)
def test_banked_copy_plain_matches_reference(B, nblk, NB, bs, W, dtype):
    rng = np.random.default_rng(B * nblk + NB)
    if dtype == "int32":
        pool = rng.integers(0, 100, (NB, bs, W)).astype(np.int32)
        new = rng.integers(0, 100, (B, nblk, bs, W)).astype(np.int32)
        jd = td = None
    else:
        pool = rng.normal(size=(NB, bs, W))
        new = rng.normal(size=(B, nblk, bs, W))
        td, jd = DTYPES[dtype]
    tbl = np.full((B, nblk), -1, np.int32)
    used = rng.choice(NB, B * nblk, replace=False)
    k = 0
    for b in range(B):
        n = int(rng.integers(1, nblk + 1))
        tbl[b, :n] = used[k : k + n]
        k += n
    jpool, jnew = (jnp.asarray(a, jd) for a in (pool, new))
    oracle = np.asarray(ref_banked_copy(jpool, jnew, jnp.asarray(tbl)))
    pallas = np.asarray(ref_banked_copy_kernel(jpool, jnew, jnp.asarray(tbl), interpret=True))
    if dtype == "int32":
        ppool, pnew = torch.from_numpy(pool), torch.from_numpy(new)
    else:
        ppool, pnew = _to_port(pool, dtype), _to_port(new, dtype)
    got = banked_copy_ref(ppool, pnew, torch.from_numpy(tbl))
    assert got.data_ptr() == ppool.data_ptr()  # in place
    for want in (oracle, pallas):
        np.testing.assert_array_equal(_np(got), _np(want))


def test_wrappers_take_plain_version_on_cpu_and_refuse_other_devices():
    rng = np.random.default_rng(8)
    q = torch.from_numpy(rng.normal(size=(1, 5, 4, 32)).astype(np.float32))
    k = torch.from_numpy(rng.normal(size=(1, 5, 2, 32)).astype(np.float32))
    pool = torch.zeros(4, 2, 3)
    tbl = torch.tensor([[1, -1]], dtype=torch.int32)
    before = dict(LAUNCHES)
    torch.testing.assert_close(flash_attention(q, k, k), flash_attention_ref(q, k, k))
    pq, pk = q[:, 0], k.reshape(5, 1, 2, 32)
    lens = torch.tensor([1], dtype=torch.int32)
    torch.testing.assert_close(
        paged_attention(pq, pk, pk, tbl, lens), paged_attention_ref(pq, pk, pk, tbl, lens)
    )
    banked_copy(pool, torch.ones(1, 2, 2, 3), tbl)
    assert pool[1].eq(1).all() and pool.sum() == 6
    assert LAUNCHES == before  # the plain versions launch nothing
    meta = [t.to("meta") for t in (q, k, pq, pk, pool, tbl, lens)]
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention(meta[0], meta[1], meta[1])
    with pytest.raises(ValueError, match="CUDA"):
        paged_attention(meta[2], meta[3], meta[3], meta[5], meta[6])
    with pytest.raises(ValueError, match="CUDA"):
        banked_copy(meta[4], torch.ones(1, 2, 2, 3, device="meta"), meta[5])
    assert LAUNCHES == before


# ------------------------------------------------ the redesigned kernels' arithmetic


def _split_inputs(rng, dtype):
    """Five requests over a 9-block table of 4-token blocks: ragged, with a
    hole of -1 blocks (empty splits), length at the table's end, length past
    it (clamped), and an empty request."""
    B, H, G, D, NB, bs, mb = 5, 16, 2, 32, 64, 4, 9
    q, kp, vp = (
        torch.from_numpy(rng.normal(size=s).astype(np.float32)).to(dtype)
        for s in ((B, H, D), (NB, bs, G, D), (NB, bs, G, D))
    )
    tbl = torch.from_numpy(rng.choice(NB, (B, mb), replace=False).astype(np.int32))
    tbl[1, 2:6] = -1
    tbl[4] = -1
    lens = torch.tensor([23, 30, mb * bs, mb * bs + 5, 0], dtype=torch.int32)
    return q, kp, vp, tbl, lens


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5), (torch.bfloat16, 3e-2)])
@pytest.mark.parametrize("bps", range(1, 11))
def test_paged_split_and_merge_matches_plain(bps, dtype, tol):
    """The CUDA kernel's arithmetic: splits of every size from one block to
    more than the table, empty splits inside a request, the empty request."""
    q, kp, vp, tbl, lens = _split_inputs(np.random.default_rng(9), dtype)
    got = paged_attention_split_ref(q, kp, vp, tbl, lens, blocks_per_split=bps)
    want = paged_attention_ref(q, kp, vp, tbl, lens)
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)
    assert (got[4] == 0).all()


def test_paged_split_size_covers_whole_blocks():
    assert [blocks_per_split(bs) for bs in (1, 3, 16, 32, 256, 512)] == [256, 86, 16, 8, 1, 1]


def _flash_rounded_p(q, k, v, *, causal, window, tile=64):
    """The bf16 flash kernel's arithmetic: per 64-key tile an online softmax
    in float32, P (against the running max) rounded to bf16 before P V, the
    sum of P kept unrounded."""
    B, S, H, D = q.shape
    T, G = k.shape[1], k.shape[2]
    qf = q.float().reshape(B, S, G, H // G, D) * D**-0.5
    kf, vf = k.float(), v.float()
    ok = attention_mask(S, T, causal=causal, window=window)
    m = torch.full((B, G, H // G, S), -torch.inf)
    l = torch.zeros((B, G, H // G, S))
    o = torch.zeros((B, G, H // G, S, D))
    for k0 in range(0, T, tile):
        s = torch.einsum("bsgmd,btgd->bgmst", qf, kf[:, k0 : k0 + tile])
        s = s.masked_fill(~ok[:, k0 : k0 + tile], -torch.inf)
        m_new = torch.maximum(m, s.amax(-1))
        base = torch.where(m_new == -torch.inf, 0.0, m_new)
        alpha = torch.exp(m - base)
        p = torch.exp(s - base[..., None])
        l = l * alpha + p.sum(-1)
        pv = torch.einsum("bgmst,btgd->bgmsd", p.bfloat16().float(), vf[:, k0 : k0 + tile])
        o = o * alpha[..., None] + pv
        m = m_new
    out = torch.where((l > 0)[..., None], o / torch.where(l > 0, l, 1.0)[..., None], 0.0)
    return out.permute(0, 3, 1, 2, 4).reshape(B, S, H, D).bfloat16()


@pytest.mark.parametrize(
    "B,S,T,H,G,D,causal,window",
    [
        (1, 256, 256, 4, 2, 64, True, 0),
        (1, 512, 512, 2, 2, 128, True, 0),
        (1, 256, 600, 4, 4, 64, False, 0),
        (1, 256, 256, 2, 1, 64, True, 64),
        (2, 77, 77, 8, 2, 16, True, 0),
        (1, 517, 517, 32, 32, 64, True, 0),
        (1, 1, 1, 4, 4, 64, True, 0),
        (1, 15, 15, 4, 4, 64, True, 0),
        (1, 2048, 2048, 4, 1, 64, True, 0),
        (1, 100, 333, 8, 1, 32, False, 0),
        (1, 300, 300, 32, 4, 64, True, 64),
        (2, 200, 200, 16, 4, 128, True, 0),
    ],
)
def test_flash_bf16_p_rounding_stays_within_tolerance(B, S, T, H, G, D, causal, window):
    """Rounding P to bf16 before P V (the tensor-core kernel's one new
    rounding) keeps the output within flash's bf16 tolerance of 2e-2, at the
    card tests' shapes."""
    rng = np.random.default_rng(S + T + D)
    q, k, v = (
        torch.from_numpy(rng.normal(size=s).astype(np.float32)).bfloat16()
        for s in ((B, S, H, D), (B, T, G, D), (B, T, G, D))
    )
    got = _flash_rounded_p(q, k, v, causal=causal, window=window)
    want = flash_attention_ref(q, k, v, causal=causal, window=window)
    torch.testing.assert_close(got.float(), want.float(), rtol=2e-2, atol=2e-2)
