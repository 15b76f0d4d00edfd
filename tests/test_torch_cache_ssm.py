"""The contiguous cache of the SSM and hybrid stacks against the
reference's: ``smoke(mamba2-1.3b)`` (the ``{"ssm", "conv"}`` tree, a
two-chunk prompt, the recurrent decode) and ``smoke(jamba-1.5-large-398b)``
(one super-block: the attention layer's K/V ``[nb, ...]`` beside the SSM
state ``[nb, P - 1, B, ...]``, batch on axis 2); the cache form against
the pool form (``prefill(ssm_out=)``/``decode_step(ssm_cache=)``).
Tolerances as ``test_torch_cache.py``."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.models import model as M  # noqa: E402
from repro_torch.models.ssm import SSMCache  # noqa: E402
from test_torch_cache import POOL_TOL, check_pair, run_pair  # noqa: E402
from test_torch_model import _np  # noqa: E402


def test_ssm_cache_matches_reference():
    check_pair(run_pair("mamba2-1.3b", S=64, steps=4))


def test_hybrid_cache_matches_reference():
    """The state within 5e-5 of its largest entry: a conv window entry one
    bf16 step apart (``check_pair``) feeds the next step's state."""
    res = run_pair("jamba-1.5-large-398b", S=32, T=40, pos0=[32, 30], steps=3)
    check_pair(res, cache_tol=5e-5)


def test_ssm_cache_matches_pool_form():
    out, port, _, model, toks, inputs = run_pair("mamba2-1.3b", S=64, steps=4)
    state = M.init_cache(model.cfg, 2, 0, torch.float32, device="cpu")
    ssm = SSMCache(state["ssm"], state["conv"])  # the conv window in bf16, as the cache form
    want = [_np(M.prefill(model, torch.from_numpy(toks), None, ssm))]
    for t, pos in inputs:
        want.append(_np(M.decode_step(model, torch.from_numpy(t), torch.from_numpy(pos), ssm)))
    for i, (got, w) in enumerate(zip([o[0] for o in out], want)):
        np.testing.assert_allclose(got, w, rtol=0, atol=POOL_TOL, err_msg=f"call {i}")
    np.testing.assert_allclose(port[("ssm",)], _np(ssm.ssm), rtol=0, atol=POOL_TOL)


def test_hybrid_cache_matches_pool_form():
    out, _, _, model, toks, inputs = run_pair("jamba-1.5-large-398b", S=32, T=40, steps=3)
    ssm = model.init_ssm_cache(2)
    B, S = toks.shape
    bs, nblk = 4, -(-(S + len(inputs)) // 4)
    row = model.kv_row_shape()
    pool = torch.zeros(B * nblk, bs, model.kv_width(), dtype=model.kv_dtype)
    burst = pool.view(B, nblk * bs, *row)[:, :S]
    want = [_np(M.prefill(model, torch.from_numpy(toks), burst, ssm))]
    tables = torch.arange(B * nblk, dtype=torch.int32).view(B, nblk)
    for t, pos in inputs:
        pos = np.broadcast_to(pos, (B,))
        w = np.stack([np.arange(B), tables.numpy()[np.arange(B), pos // bs], pos % bs])
        paged = M.PagedKV(pool.view(B * nblk, bs, *row), tables,
                          torch.from_numpy((pos + 1).astype(np.int32)), *torch.from_numpy(w).long())
        want.append(_np(M.decode_step(model, torch.from_numpy(t), torch.from_numpy(pos.copy()),
                                      paged, ssm)))
    for i, (got, w) in enumerate(zip([o[0] for o in out], want)):
        np.testing.assert_allclose(got, w, rtol=0, atol=POOL_TOL, err_msg=f"call {i}")
