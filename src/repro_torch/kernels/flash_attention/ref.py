"""Plain PyTorch version of the flash-attention forward.

The contract shared with the CUDA kernel (``csrc/flash_attention.cu``): for
``q [B, S, H, D]``, ``k [B, T, G, D]`` and ``v [B, T, G, Dv]`` (GQA: query
head ``h`` reads KV group ``h // (H // G)``; v may be narrower than q and k,
as MLA's), row ``i`` attends to keys ``j < T`` with ``j <= i``
where causal and ``i - j < window`` where ``window > 0``.  Softmax in float32;
a row with no key gets 0.  There is no padding: keys past ``T`` do not exist,
so they cannot leak in (the fault of the reference's ``ops.py`` recorded in
ROADMAP Queue 3 is not carried over).
"""

from __future__ import annotations

import torch

NEG_INF = -1e9


def attention_mask(S: int, T: int, *, causal: bool, window: int, device=None) -> torch.Tensor:
    """``[S, T]`` bool, True where row ``i`` may attend to key ``j``."""
    i = torch.arange(S, device=device)[:, None]
    j = torch.arange(T, device=device)[None, :]
    ok = torch.ones((S, T), dtype=torch.bool, device=device)
    if causal:
        ok &= j <= i
    if window:
        ok &= (i - j) < window
    return ok


def flash_attention_ref(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: int = 0,
    scale=None,
) -> torch.Tensor:
    """q ``[B, S, H, D]``, k ``[B, T, G, D]``, v ``[B, T, G, Dv]`` -> ``[B, S,
    H, Dv]`` in q's dtype."""
    B, S, H, D = q.shape
    T, G, Dv = k.shape[1], k.shape[2], v.shape[3]
    scale = scale if scale is not None else D**-0.5
    qg = q.reshape(B, S, G, H // G, D).float()
    s = torch.einsum("bsgmd,btgd->bgmst", qg, k.float()) * scale
    ok = attention_mask(S, T, causal=causal, window=window, device=q.device)
    p = torch.softmax(s.masked_fill(~ok, NEG_INF), dim=-1) * ok
    out = torch.einsum("bgmst,btgd->bsgmd", p, v.float())
    return out.reshape(B, S, H, Dv).to(q.dtype)


# ---------------------------------------------------------------------------
# Training: the blockwise forward with its log-sum-exp and the blockwise
# backward, the reference's ``_flash_fwd_scan`` and ``_flash_vjp_bwd``
# (``models/attention.py``), with the masking contract above
# ---------------------------------------------------------------------------

#: the reference's block sizes (``chunked_attention``'s defaults)
Q_BLOCK, KV_BLOCK = 512, 1024


def _block_mask(i0, sq, j0, tk, *, causal: bool, window: int, device):
    i = torch.arange(i0, i0 + sq, device=device)[:, None]
    j = torch.arange(j0, j0 + tk, device=device)[None, :]
    ok = torch.ones((sq, tk), dtype=torch.bool, device=device)
    if causal:
        ok &= j <= i
    if window:
        ok &= (i - j) < window
    return ok


def _live(i0, sq, j0, tk, *, causal: bool, window: int) -> bool:
    """Whether a (q block, kv block) tile holds an unmasked pair; skipping
    the others changes no value (the reference's ``triangular_skip``)."""
    if causal and j0 > i0 + sq - 1:
        return False
    return not (window and i0 - (j0 + tk - 1) >= window)


def flash_attention_fwd_ref(
    q, k, v, *, causal=True, window=0, scale=None, q_block=Q_BLOCK, kv_block=KV_BLOCK
):
    """q ``[B, S, H, D]``, k ``[B, T, G, D]``, v ``[B, T, G, Dv]`` -> ``(out
    [B, S, H, Dv]`` in q's dtype, ``lse [B, H, S]`` float32``)``: the online softmax over KV
    blocks in float32.  ``lse`` is ``m + log(l)`` in the scaled-score domain,
    as the reference's forward returns it; a row with no key gets out 0 and
    lse -inf."""
    B, S, H, D = q.shape
    T, G, Dv = k.shape[1], k.shape[2], v.shape[3]
    M = H // G
    scale = scale if scale is not None else D**-0.5
    qg = q.reshape(B, S, G, M, D)
    out = torch.empty((B, S, G, M, Dv), dtype=q.dtype, device=q.device)
    lse = torch.empty((B, G, M, S), dtype=torch.float32, device=q.device)
    for i0 in range(0, S, q_block):
        qi = qg[:, i0 : i0 + q_block].float()
        sq = qi.shape[1]
        m = torch.full((B, G, M, sq), float("-inf"), device=q.device)
        l = torch.zeros((B, G, M, sq), device=q.device)
        acc = torch.zeros((B, sq, G, M, Dv), device=q.device)
        for j0 in range(0, T, kv_block):
            tk = min(kv_block, T - j0)
            if not _live(i0, sq, j0, tk, causal=causal, window=window):
                continue
            s = torch.einsum("bqgmd,btgd->bgmqt", qi, k[:, j0 : j0 + tk].float()) * scale
            ok = _block_mask(i0, sq, j0, tk, causal=causal, window=window, device=q.device)
            s = s.masked_fill(~ok, float("-inf"))
            m_new = torch.maximum(m, s.amax(-1))
            m_safe = torch.where(torch.isinf(m_new), 0.0, m_new)  # rows with no key yet
            p = torch.exp(s - m_safe[..., None])
            alpha = torch.exp(m - m_safe)
            l = l * alpha + p.sum(-1)
            pv = torch.einsum("bgmqt,btgd->bqgmd", p, v[:, j0 : j0 + tk].float())
            acc = acc * alpha.permute(0, 3, 1, 2)[..., None] + pv
            m = m_new
        inv = torch.where(l > 0, 1.0 / l.clamp_min(1e-20), 0.0)
        out[:, i0 : i0 + sq] = (acc * inv.permute(0, 3, 1, 2)[..., None]).to(q.dtype)
        lse[..., i0 : i0 + sq] = m + torch.log(l)
    return out.reshape(B, S, H, Dv), lse.reshape(B, H, S)


def flash_attention_bwd_ref(
    q,
    k,
    v,
    out,
    lse,
    dout,
    *,
    causal=True,
    window=0,
    scale=None,
    q_block=Q_BLOCK,
    kv_block=KV_BLOCK,
):
    """The backward of :func:`flash_attention_fwd_ref`, blockwise in float32:
    ``D = rowsum(dO * O)``, ``P = exp(S * scale - lse)`` (0 where masked),
    ``dV = P^T dO``, ``dP = dO V^T``, ``dS = P * (dP - D) * scale``,
    ``dQ = dS K``, ``dK = dS^T Q``; dK and dV sum over the query heads of
    their KV group.  Returns ``(dq, dk, dv)`` in the inputs' dtypes."""
    B, S, H, D = q.shape
    T, G, Dv = k.shape[1], k.shape[2], v.shape[3]
    M = H // G
    scale = scale if scale is not None else D**-0.5
    qg = q.reshape(B, S, G, M, D)
    do = dout.reshape(B, S, G, M, Dv).float()
    drow = (do * out.reshape(B, S, G, M, Dv).float()).sum(-1).permute(0, 2, 3, 1)  # [B,G,M,S]
    lse = lse.reshape(B, G, M, S)
    dq = torch.zeros((B, S, G, M, D), device=q.device)
    dk = torch.zeros((B, T, G, D), device=q.device)
    dv = torch.zeros((B, T, G, Dv), device=q.device)
    for j0 in range(0, T, kv_block):
        tk = min(kv_block, T - j0)
        kj, vj = k[:, j0 : j0 + tk].float(), v[:, j0 : j0 + tk].float()
        for i0 in range(0, S, q_block):
            sq = min(q_block, S - i0)
            if not _live(i0, sq, j0, tk, causal=causal, window=window):
                continue
            qi, doi = qg[:, i0 : i0 + sq].float(), do[:, i0 : i0 + sq]
            s = torch.einsum("bqgmd,btgd->bgmqt", qi, kj) * scale
            ok = _block_mask(i0, sq, j0, tk, causal=causal, window=window, device=q.device)
            p = torch.where(ok, torch.exp(s - lse[..., i0 : i0 + sq, None]), 0.0)
            dv[:, j0 : j0 + tk] += torch.einsum("bgmqt,bqgmd->btgd", p, doi)
            dp = torch.einsum("bqgmd,btgd->bgmqt", doi, vj)
            ds = p * (dp - drow[..., i0 : i0 + sq, None]) * scale
            dq[:, i0 : i0 + sq] += torch.einsum("bgmqt,btgd->bqgmd", ds, kj)
            dk[:, j0 : j0 + tk] += torch.einsum("bgmqt,bqgmd->btgd", ds, qi)
    return dq.reshape(B, S, H, D).to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


class FlashAttentionFunction(torch.autograd.Function):
    """Attention with the flash backward: only q, k, v, out and lse are
    saved, and every probability block is recomputed.  ``fwd`` and ``bwd``
    are a forward-with-lse and a backward of the signatures above (the plain
    versions here, or the kernels' wrappers)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, scale, fwd, bwd):
        out, lse = fwd(q, k, v, causal=causal, window=window, scale=scale)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.args = (causal, window, scale, bwd)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        causal, window, scale, bwd = ctx.args
        dq, dk, dv = bwd(
            q, k, v, out, lse, dout.contiguous(), causal=causal, window=window, scale=scale
        )
        return dq, dk, dv, None, None, None, None, None


def flash_attention_train_ref(q, k, v, *, causal=True, window=0, scale=None):
    """Differentiable attention through the plain blockwise versions."""
    return FlashAttentionFunction.apply(
        q, k, v, causal, window, scale, flash_attention_fwd_ref, flash_attention_bwd_ref
    )
