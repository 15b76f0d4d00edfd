"""Plain PyTorch version of paged decode attention over the banked KV pool.

The contract shared with the CUDA kernel (``csrc/paged_attention.cu``): the
``H`` query heads of request ``b`` fall into ``G`` groups of ``H / G``; group
``g`` attends to the tokens ``t < lengths[b]`` whose block
``block_table[b, t // bs]`` is not -1, reading token ``t`` of K and V at pool
block ``block_table[b, t // bs]``, row ``t % bs``, group ``g``.  Softmax in
float32; a request with no valid token gets 0.  (The reference's
``paged_attention_ref`` returns the mean of V over pool block 0 there, a
fault recorded in ROADMAP Queue 3 and not carried over.)
``paged_attention_split_ref`` spells out the kernel's split-and-merge
arithmetic for the tests.
"""

from __future__ import annotations

import torch

NEG_INF = -1e9


def paged_attention_ref(
    q: torch.Tensor,
    k_pool: torch.Tensor,
    v_pool: torch.Tensor,
    block_table: torch.Tensor,
    lengths: torch.Tensor,
    *,
    scale=None,
) -> torch.Tensor:
    """q ``[B, H, D]``; pools ``[NB, bs, G, D]`` (views allowed); block_table
    ``[B, mb]`` int32 (-1 = unused); lengths ``[B]``.  Returns ``[B, H, D]``."""
    B, H, D = q.shape
    NB, bs, G, _ = k_pool.shape
    mb = block_table.shape[1]
    scale = scale if scale is not None else D**-0.5
    tbl = block_table.long().clamp(min=0)
    k = k_pool[tbl].reshape(B, mb * bs, G, D).float()
    v = v_pool[tbl].reshape(B, mb * bs, G, D).float()
    tok = torch.arange(mb * bs, device=q.device)
    valid = (tok[None, :] < lengths[:, None].long()) & (block_table >= 0).repeat_interleave(
        bs, dim=1
    )
    qg = q.reshape(B, G, H // G, D).float()
    s = torch.einsum("bgmd,btgd->bgmt", qg, k) * scale
    s = s.masked_fill(~valid[:, None, None, :], NEG_INF)
    p = torch.softmax(s, dim=-1) * valid[:, None, None, :]
    v = v.masked_fill(~valid[:, :, None, None], 0.0)  # rows past the end may hold anything
    out = torch.einsum("bgmt,btgd->bgmd", p, v)
    return out.reshape(B, H, D).to(q.dtype)


def paged_attention_split_ref(
    q: torch.Tensor,
    k_pool: torch.Tensor,
    v_pool: torch.Tensor,
    block_table: torch.Tensor,
    lengths: torch.Tensor,
    *,
    blocks_per_split: int,
    scale=None,
) -> torch.Tensor:
    """The CUDA kernel's split-and-merge arithmetic in plain PyTorch (tests
    only): the KV length cut into splits of ``blocks_per_split`` pool blocks,
    one float32 partial (max, sum, acc) per (request, head, split), the live
    splits (those starting before the length) merged in split order.  Equals
    ``paged_attention_ref`` up to float32 rounding."""
    B, H, D = q.shape
    NB, bs, G, _ = k_pool.shape
    mb = block_table.shape[1]
    scale = scale if scale is not None else D**-0.5
    span = blocks_per_split * bs
    nsplit = -(-mb // blocks_per_split)
    tbl = block_table.long().clamp(min=0)
    k = k_pool[tbl].reshape(B, mb * bs, G, D).float()
    v = v_pool[tbl].reshape(B, mb * bs, G, D).float()
    length = lengths.long().clamp(0, mb * bs)
    valid = torch.arange(mb * bs, device=q.device)[None, :] < length[:, None]
    valid &= (block_table >= 0).repeat_interleave(bs, dim=1)
    v = v.masked_fill(~valid[:, :, None, None], 0.0)  # rows past the end may hold anything
    pad = nsplit * span - mb * bs  # the last split's blocks past the table
    valid = torch.nn.functional.pad(valid, (0, pad))
    k, v = (torch.nn.functional.pad(t, (0, 0, 0, 0, 0, pad)) for t in (k, v))
    qg = q.reshape(B, G, H // G, D).float() * scale
    s = torch.einsum("bgmd,btgd->bgmt", qg, k).masked_fill(~valid[:, None, None, :], -torch.inf)
    s = s.reshape(B, G, H // G, nsplit, span)
    mx = s.amax(-1)  # [B, G, m, nsplit]
    p = torch.where(mx[..., None] > -torch.inf, torch.exp(s - mx[..., None]), 0.0)
    acc = torch.einsum("bgmst,bstgd->bgmsd", p, v.reshape(B, nsplit, span, G, D))
    ssum = p.sum(-1)
    # merge: live splits with a valid token, weighted against their largest max
    live = (torch.arange(nsplit, device=q.device)[None, :] * span < length[:, None])[:, None, None]
    used = live & (ssum > 0)
    big = mx.masked_fill(~used, -torch.inf).amax(-1, keepdim=True)
    w = torch.where(used, torch.exp(mx - big), 0.0)
    total = (ssum * w).sum(-1)
    out = (acc * w[..., None]).sum(-2) / torch.where(total > 0, total, 1.0)[..., None]
    out = torch.where((total > 0)[..., None], out, 0.0)
    return out.reshape(B, H, D).to(q.dtype)
