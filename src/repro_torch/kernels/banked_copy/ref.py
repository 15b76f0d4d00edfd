"""Plain PyTorch version of the banked burst scatter (split dispatch).

The contract shared with the CUDA kernel (``csrc/banked_copy.cu``): block
``j`` of request ``b`` of the burst ``new_kv [B, nblk, bs, W]`` is written to
``pool[block_table[b, j]]`` in place; an entry of -1 skips its block.  Tables
hold each pool row at most once (the allocator's ownership guarantee).
"""

from __future__ import annotations

import torch


def banked_copy_ref(
    pool: torch.Tensor, new_kv: torch.Tensor, block_table: torch.Tensor
) -> torch.Tensor:
    """pool ``[NB, bs, W]`` (updated in place and returned); new_kv
    ``[B, nblk, bs, W]``; block_table ``[B, nblk]`` int32, -1 = skip."""
    B, nblk = block_table.shape
    idx = block_table.reshape(-1).long()
    live = idx >= 0
    pool[idx[live]] = new_kv.reshape(B * nblk, *new_kv.shape[2:])[live]
    return pool
