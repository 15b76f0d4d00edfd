"""Plain PyTorch version of the per-bank QoS arbitration comparator tree.

The contract shared with the CUDA kernel (``csrc/bank_arbiter.cu``), per
batch lane: given per-slot arbitration keys (``core.qos`` packing, smaller
wins, every key in ``[0, KEY_FILLER]``), per-slot target banks in
``[0, num_banks)`` and an eligibility mask, return ``win[NB]``: the flat index
of the *eligible* slot with the minimum key, ties broken by the lowest slot
index, and ``S`` where the bank has no eligible slot.
"""

from __future__ import annotations

import torch

#: key value for ineligible slots, at or above every real arbitration key
#: (``core.simulator._age_cap`` budgets keys strictly below 2**30)
KEY_FILLER = 2**30


def bank_arbiter_ref(
    key: torch.Tensor, bank: torch.Tensor, elig: torch.Tensor, *, num_banks: int
) -> torch.Tensor:
    """key/bank/elig: ``[B, S]`` (int32 / int16 or int32 / bool).
    Returns ``win`` ``[B, num_banks]`` int32.

    Two ``scatter_reduce(..., "amin")`` passes: the minimum key per bank, then
    the lowest slot holding it.  Ineligible slots go to a spill segment
    ``num_banks`` that is dropped."""
    B, S = key.shape
    seg = torch.where(elig, bank.long(), num_banks)
    best = torch.full((B, num_banks + 1), KEY_FILLER, dtype=torch.int32, device=key.device)
    best = best.scatter_reduce(1, seg, torch.where(elig, key.to(torch.int32), KEY_FILLER), "amin")
    is_best = elig & (key == torch.gather(best, 1, seg))
    slots = torch.arange(S, dtype=torch.int32, device=key.device).expand(B, S)
    win = torch.full((B, num_banks + 1), S, dtype=torch.int32, device=key.device)
    win = win.scatter_reduce(
        1, torch.where(is_best, seg, num_banks), torch.where(is_best, slots, S), "amin"
    )
    return win[:, :num_banks].contiguous()


def split_of_slot(S: int, splits: int, device=None) -> torch.Tensor:
    """``[S]`` index of the CTA of a ``splits``-CTA cluster that folds each
    slot of a lane, as the kernel cuts it: contiguous shares of
    ``ceil(S / splits)`` slots rounded up to 16, so the last CTAs of a short
    lane may get none."""
    per = (-(-S // splits) + 15) & ~15
    return torch.div(torch.arange(S, device=device), max(per, 1), rounding_mode="floor")


def bank_arbiter_split_ref(
    key: torch.Tensor, bank: torch.Tensor, elig: torch.Tensor, *, num_banks: int, splits: int
) -> torch.Tensor:
    """The kernel's decomposition in plain PyTorch (tests only): packed
    ``(key << 32) | slot`` int64 values, a minimum per bank in each of
    ``splits`` CTAs over its share of the slots (``split_of_slot``) from a
    filler of ``(KEY_FILLER << 32) | S``, then a merge of the CTAs' minima by
    bank."""
    B, S = key.shape
    filler = (KEY_FILLER << 32) | S
    slots = torch.arange(S, dtype=torch.int64, device=key.device)
    packed = torch.where(elig, (key.long() << 32) | slots, filler)
    seg = split_of_slot(S, splits, key.device) * (num_banks + 1) + torch.where(
        elig, bank.long(), num_banks
    )
    best = torch.full((B, splits * (num_banks + 1)), filler, dtype=torch.int64, device=key.device)
    best = best.scatter_reduce(1, seg, packed, "amin").view(B, splits, num_banks + 1)
    return (best[:, :, :num_banks].amin(dim=1) & 0xFFFFFFFF).int()
