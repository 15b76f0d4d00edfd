"""Plain PyTorch version of paged decode attention over the banked KV pool.

The contract shared with the CUDA kernel (``csrc/paged_attention.cu``): the
``H`` query heads of request ``b`` fall into ``G`` groups of ``H / G``; group
``g`` attends to the tokens ``t < lengths[b]`` whose block
``block_table[b, t // bs]`` is not -1, reading token ``t`` of K and V at pool
block ``block_table[b, t // bs]``, row ``t % bs``, group ``g``.  Softmax in
float32; a request with no valid token gets 0.  (The reference's
``paged_attention_ref`` returns the mean of V over pool block 0 there, a
fault recorded in ROADMAP Queue 3 and not carried over.)
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
