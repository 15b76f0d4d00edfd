"""BankedKVPool: the paper's shared-memory architecture as a serving feature.

A numpy copy of the reference's ``serving/pool.py``, so the port never
imports the reference.  A flat pool of KV blocks is the serving analogue of
the 32 MB SRAM sea:
  masters   -> concurrent requests
  beats     -> KV blocks
  banks     -> pool stripes (contiguous slabs of blocks)
  split+fractal dispatch -> the allocator's placement policy (round-robin the
    request's blocks across banks, hash-offset per round)
  replicated arbitration / ISO-26262 isolation -> strict block ownership: a
    block belongs to exactly one request until freed (``check_isolation``)

``placement='sequential'`` is the comparator allocator (first free).  The
pool only decides placement and ownership; the engine keeps the KV bytes on
the device at the blocks it hands out.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np

from repro_torch.core.address import _hash32


@dataclass
class PoolStats:
    allocs: int = 0
    frees: int = 0
    failed: int = 0


class BankedKVPool:
    def __init__(
        self,
        num_blocks: int,
        block_size: int,
        *,
        num_banks: int = 16,
        placement: str = "fractal",
        seed: int = 0,
        recorder=None,
    ):
        if num_blocks % num_banks:
            raise ValueError(f"num_blocks={num_blocks} is not a multiple of num_banks={num_banks}")
        self.num_blocks = num_blocks
        self.block_size = block_size
        self.num_banks = num_banks
        self.placement = placement
        self.seed = seed
        self.owner = np.full(num_blocks, -1, np.int64)  # -1 = free
        self.by_request: Dict[int, List[int]] = {}
        self.stats = PoolStats()
        self._rr = 0
        # optional KVAccessRecorder (serving co-sim): alloc/free events feed
        # the fabric traffic model's block-churn stream
        self.recorder = recorder

    # banks are contiguous slabs, like the paper's SRAM arrays: a first-free
    # allocator therefore camps in slab 0, which the fractal policy whitens
    @property
    def slab(self) -> int:
        return self.num_blocks // self.num_banks

    def bank_of(self, block: int) -> int:
        return block // self.slab

    def _free_in_bank(self, bank: int) -> Optional[int]:
        lo = bank * self.slab
        cands = np.nonzero(self.owner[lo : lo + self.slab] < 0)[0]
        if len(cands) == 0:
            return None
        return int(lo + cands[0])

    def alloc(self, request_id: int, n_blocks: int) -> Optional[List[int]]:
        """All-or-nothing allocation of ``n_blocks`` for a request."""
        got: List[int] = []
        for i in range(n_blocks):
            blk = None
            if self.placement == "fractal":
                rnd = len(self.by_request.get(request_id, [])) + i
                bank = int((self._rr + i + _hash32(np.uint32(rnd + self.seed))) % self.num_banks)
                blk = self._free_in_bank(bank)
                if blk is None:  # fall back: scan banks round-robin
                    for off in range(1, self.num_banks):
                        blk = self._free_in_bank((bank + off) % self.num_banks)
                        if blk is not None:
                            break
            else:  # sequential first-free
                free = np.nonzero(self.owner < 0)[0]
                blk = int(free[0]) if len(free) else None
            if blk is None:
                for b in got:  # roll back
                    self.owner[b] = -1
                self.stats.failed += 1
                return None
            self.owner[blk] = request_id
            got.append(blk)
        self._rr = (self._rr + 1) % self.num_banks
        self.by_request.setdefault(request_id, []).extend(got)
        self.stats.allocs += n_blocks
        if self.recorder is not None:
            self.recorder.on_alloc(request_id, got)
        return got

    def free(self, request_id: int) -> int:
        blocks = self.by_request.pop(request_id, [])
        for b in blocks:
            if self.owner[b] != request_id:
                raise RuntimeError(f"block {b} of request {request_id} is owned by {self.owner[b]}")
            self.owner[b] = -1
        self.stats.frees += len(blocks)
        if self.recorder is not None and blocks:
            self.recorder.on_free(request_id, blocks)
        return len(blocks)

    def check_isolation(self) -> bool:
        """Every block is owned by at most one request, and ``by_request`` and
        ``owner`` agree exactly (the ISO-26262 ownership invariant)."""
        seen = {}
        for rid, blocks in self.by_request.items():
            for b in blocks:
                if b in seen or self.owner[b] != rid:
                    return False
                seen[b] = rid
        return int((self.owner >= 0).sum()) == len(seen)

    def bank_load(self, request_id: Optional[int] = None) -> np.ndarray:
        """Blocks per bank (optionally for one request), the whitening metric."""
        if request_id is None:
            used = np.nonzero(self.owner >= 0)[0]
        else:
            used = np.array(self.by_request.get(request_id, []), np.int64)
        return np.bincount(
            used // self.slab if len(used) else np.zeros(0, np.int64), minlength=self.num_banks
        )

    def imbalance(self) -> float:
        """max/mean bank load; 1.0 is perfectly whitened."""
        load = self.bank_load()
        mean = load.mean()
        return float(load.max() / mean) if mean > 0 else 1.0
