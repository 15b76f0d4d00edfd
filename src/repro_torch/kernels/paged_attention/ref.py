"""Plain PyTorch version of paged decode attention over the banked KV pool.

The contract shared with the CUDA kernel (``csrc/paged_attention.cu``): the
``H`` query heads of request ``b`` fall into ``G`` groups of ``H / G``; group
``g`` attends to the tokens ``t < lengths[b]`` whose block
``block_table[b, t // bs]`` is not -1, reading token ``t`` of K and V at pool
block ``block_table[b, t // bs]``, row ``t % bs``, group ``g``.  Softmax in
float32; a request with no valid token gets 0.  With ``window > 0`` only
the tokens ``t >= lengths[b] - window`` are valid besides (h2o-danube's
sliding window: the reference's ``q - t < window`` at ``q = lengths[b] - 1``).
V may be narrower than K:
MLA's latent call passes the latent rows of 576 as K and their first 512
columns as V.  (The reference's
``paged_attention_ref`` returns the mean of V over pool block 0 there, a
fault recorded in ROADMAP Queue 3 and not carried over.)
``paged_attention_split_ref`` spells out the kernel's split-and-merge
arithmetic for the tests.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

NEG_INF = -1e9


def paged_attention_ref(
    q: torch.Tensor,
    k_pool: torch.Tensor,
    v_pool: torch.Tensor,
    block_table: torch.Tensor,
    lengths: torch.Tensor,
    *,
    scale=None,
    window: int = 0,
    return_lse: bool = False,
):
    """q ``[B, H, D]``; k pool ``[NB, bs, G, D]``, v pool ``[NB, bs, G, Dv]``
    (views allowed); block_table ``[B, mb]`` int32 (-1 = unused); lengths
    ``[B]``; ``window`` 0 (none) or the most recent tokens each request
    attends to.  Returns ``[B, H, Dv]``, and with ``return_lse`` each head's
    log-sum-exp of its scaled scores ``[B, H]`` float32 besides (-inf
    where no token is valid)."""
    B, H, D = q.shape
    NB, bs, G, _ = k_pool.shape
    Dv = v_pool.shape[3]
    mb = block_table.shape[1]
    scale = scale if scale is not None else D**-0.5
    tbl = block_table.long().clamp(min=0)
    k = k_pool[tbl].reshape(B, mb * bs, G, D).float()
    v = v_pool[tbl].reshape(B, mb * bs, G, Dv).float()
    tok = torch.arange(mb * bs, device=q.device)
    valid = (tok[None, :] < lengths[:, None].long()) & (block_table >= 0).repeat_interleave(
        bs, dim=1
    )
    if window:  # from the window's start; a length past the table ends at it, as in the kernel
        valid &= tok[None, :] >= lengths[:, None].long().clamp(max=mb * bs) - window
    qg = q.reshape(B, G, H // G, D).float()
    s = torch.einsum("bgmd,btgd->bgmt", qg, k) * scale
    s = s.masked_fill(~valid[:, None, None, :], NEG_INF)
    p = torch.softmax(s, dim=-1) * valid[:, None, None, :]
    v = v.masked_fill(~valid[:, :, None, None], 0.0)  # rows past the end may hold anything
    out = torch.einsum("bgmt,btgd->bgmd", p, v).reshape(B, H, Dv).to(q.dtype)
    if not return_lse:
        return out
    lse = torch.logsumexp(s.masked_fill(~valid[:, None, None, :], -torch.inf), -1)
    return out, lse.reshape(B, H)


def paged_attention_split_ref(
    q: torch.Tensor,
    k_pool: torch.Tensor,
    v_pool: torch.Tensor,
    block_table: torch.Tensor,
    lengths: torch.Tensor,
    *,
    blocks_per_split: int | None = None,
    splits: int | None = None,
    stage_rows: int | None = None,
    scale=None,
    window: int = 0,
) -> torch.Tensor:
    """The CUDA kernels' split-and-merge arithmetic in plain PyTorch (tests
    only).  Each request's tokens are cut into splits: of ``blocks_per_split``
    pool blocks (the GQA kernel, the float32 latent kernel), or into
    ``splits`` chunks of ceil(length / splits) tokens (the bf16 latent
    kernel's cluster of CTAs).  Each split gives a float32 partial (max,
    sum, acc) per head, and the splits are merged in order against their
    largest max.  ``window`` masks the tokens before ``length - window``, as
    the GQA kernel does: a split wholly before that start gives no partial.
    Scores are float32 products of q and the rows as they are stored,
    scaled after the product (the GQA kernel scales q first: a
    float32 rounding apart).  With ``stage_rows`` it also replays the latent
    kernels' stages: each split's rows in stages of that many, P taken
    against the running max after each stage and rounded to q's dtype (bf16:
    the tensor cores' A operand, as the reference's absorbed form rounds its
    softmax weights) before P V and before its sum.  Equals
    ``paged_attention_ref`` up to float32 rounding, and up to that rounding
    of P in bf16."""
    if window and splits:
        raise ValueError("the latent call's chunks take no window")
    B, H, D = q.shape
    NB, bs, G, _ = k_pool.shape
    Dv = v_pool.shape[3]
    mb = block_table.shape[1]
    m = H // G
    scale = scale if scale is not None else D**-0.5
    length = lengths.long().clamp(0, mb * bs)
    tbl = block_table.long()
    out = torch.zeros(B, G, m, Dv, dtype=torch.float32, device=q.device)
    for b in range(B):
        n = int(length[b])
        span = blocks_per_split * bs if blocks_per_split else -(-n // splits)
        tok = torch.arange(n, device=q.device)
        blk = tbl[b, tok // bs]
        rows_k = k_pool[blk.clamp(min=0), tok % bs].float()  # [n, G, D]
        rows_v = v_pool[blk.clamp(min=0), tok % bs].float()
        valid = blk >= 0
        if window:
            valid &= tok >= n - window
        # rows of -1 blocks may hold anything
        rows_v = rows_v.masked_fill(~valid[:, None, None], 0.0)
        qg = q[b].reshape(G, m, D).float()
        parts = []  # (max, sum, acc) per split, in split order
        for t0 in range(0, n, span or 1):
            t1 = min(t0 + span, n)
            rows = stage_rows or (t1 - t0)
            nst = -(-(t1 - t0) // rows)
            pad = nst * rows - (t1 - t0)
            sc = torch.einsum("gmd,tgd->gmt", qg, rows_k[t0:t1]) * scale
            sc = sc.masked_fill(~valid[None, None, t0:t1], -torch.inf)
            sc = F.pad(sc, (0, pad), value=-torch.inf).reshape(G, m, nst, rows)
            vs = F.pad(rows_v[t0:t1], (0, 0, 0, 0, 0, pad)).reshape(nst, rows, G, Dv)
            run = sc.amax(-1).cummax(-1).values  # running max after each stage
            p = torch.where(run[..., None] > -torch.inf, torch.exp(sc - run[..., None]), 0.0)
            if stage_rows:
                p = p.to(q.dtype).float()
            mx = run[..., -1]
            rescale = torch.where(run > -torch.inf, torch.exp(run - mx[..., None]), 0.0)
            acc = torch.einsum("gmst,stgd,gms->gmd", p, vs, rescale)
            parts.append((mx, (p.sum(-1) * rescale).sum(-1), acc))
        if not parts:
            continue
        mx, ssum, acc = (torch.stack(t, -1) for t in zip(*parts))  # acc [G, m, Dv, splits]
        used = ssum > 0
        big = mx.masked_fill(~used, -torch.inf).amax(-1, keepdim=True)
        w = torch.where(used, torch.exp(mx - big), 0.0)
        total = (ssum * w).sum(-1)
        o = (acc * w[..., None, :]).sum(-1) / torch.where(total > 0, total, 1.0)[..., None]
        out[b] = torch.where((total > 0)[..., None], o, 0.0)
    return out.reshape(B, H, Dv).to(q.dtype)
