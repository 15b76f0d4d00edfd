"""Deterministic sharded data pipeline: the reference's ``data/pipeline.py``.

A synthetic corpus (a seeded Zipfian token stream with document structure)
stands in for tokenized pretraining shards; the rest is production-shaped:
  * per-host sharding: host h of H reads example e iff e % H == h
  * a bounded prefetch queue (the paper's split-buffer idea: it decouples the
    producer from the consumer)
  * checkpointable iterator state (exact resume after preemption)
  * banked shard interleave: the shard order is whitened with
    ``core.address.fractal_permute`` so that concurrent hosts never walk the
    same storage "bank" in lockstep, the data-layer analogue of §II-C.
Host numpy throughout, batch for batch equal to the reference's.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Dict, Iterator

import numpy as np

from repro_torch.core.address import fractal_permute


@dataclass
class PipelineState:
    epoch: int = 0
    index: int = 0  # next example index within the epoch


class TokenPipeline:
    """Yields ``{'tokens': [B, S], 'labels': [B, S]}`` int32 batches."""

    def __init__(
        self,
        vocab_size: int,
        *,
        batch: int,
        seq_len: int,
        host_id: int = 0,
        num_hosts: int = 1,
        seed: int = 0,
        num_shards: int = 64,
        examples_per_shard: int = 128,
        prefetch: int = 2,
    ):
        self.vocab = vocab_size
        self.batch = batch
        self.seq = seq_len
        self.host_id = host_id
        self.num_hosts = num_hosts
        self.seed = seed
        self.num_shards = num_shards
        self.examples_per_shard = examples_per_shard
        self.prefetch = prefetch
        self.state = PipelineState()
        self._queue = []

    # ---- deterministic synthetic corpus ----
    def _example(self, epoch: int, index: int) -> np.ndarray:
        # whitened shard walk: which shard this global index reads
        perm = fractal_permute(self.num_shards, seed=self.seed + epoch)
        shard = perm[index // self.examples_per_shard % self.num_shards]
        rng = np.random.default_rng(
            (self.seed, epoch, int(shard), index % self.examples_per_shard)
        )
        # zipf-ish unigram stream with BOS-separated "documents"
        z = rng.zipf(1.3, self.seq + 1)
        toks = np.minimum(z, self.vocab - 1).astype(np.int32)
        doc_starts = rng.random(self.seq + 1) < 0.02
        toks[doc_starts] = 1  # BOS
        return toks

    def _next_batch(self) -> Dict[str, np.ndarray]:
        st = self.state
        rows = []
        idx = st.index
        for _ in range(self.batch):
            gidx = idx * self.num_hosts + self.host_id
            rows.append(self._example(st.epoch, gidx))
            idx += 1
        total = self.num_shards * self.examples_per_shard // self.num_hosts
        if idx >= total:
            self.state = PipelineState(epoch=st.epoch + 1, index=0)
        else:
            self.state = dataclasses.replace(st, index=idx)
        arr = np.stack(rows)
        return {"tokens": arr[:, :-1], "labels": arr[:, 1:]}

    # ---- bounded prefetch queue (each entry remembers the iterator state it
    # was generated FROM, so a checkpoint taken mid-queue resumes exactly at
    # the first undelivered batch) ----
    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        return self

    def __next__(self) -> Dict[str, np.ndarray]:
        while len(self._queue) < self.prefetch:
            snap = (self.state.epoch, self.state.index)
            self._queue.append((snap, self._next_batch()))
        return self._queue.pop(0)[1]

    # ---- checkpointing ----
    def checkpoint(self) -> Dict[str, int]:
        if self._queue:
            epoch, index = self._queue[0][0]
        else:
            epoch, index = self.state.epoch, self.state.index
        return {"epoch": epoch, "index": index}

    def restore(self, ckpt: Dict[str, int]) -> None:
        # replay from the first undelivered batch; drop the volatile queue
        self.state = PipelineState(epoch=int(ckpt["epoch"]), index=int(ckpt["index"]))
        self._queue = []
