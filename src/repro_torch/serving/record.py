"""KV-block access recording for the serving co-sim (engine -> fabric loop).

The :class:`~repro_torch.serving.engine.ServingEngine`'s memory behaviour
(prefill slab writes, batched decode gathers across
:class:`~repro_torch.serving.pool.BankedKVPool` blocks, and block free and
realloc churn under continuous batching) is the workload the paper's shared
memory fabric must isolate.  This module records it as a
:class:`ServingAccessRecord`: a deterministic, replayable event stream at
(engine step, KV block) granularity, which
``repro_torch.scenarios.serving.ServingSource`` compiles into simulator
``Trace`` rows.

The stream is a function of the engine's control flow only (admission order,
pool placement, prompt lengths, ``max_new_tokens``), never of the model's
numbers, so two identical runs record identical streams, and a
``params=None`` traffic-only engine records the same stream as a full model
run on the card at a tiny fraction of the cost (both tested).

Event kinds, each tagged with the engine step it happened on:
  * ``alloc``   the pool granted a request its blocks (placement decided)
  * ``prefill`` a prompt's KV was written into the request's leading blocks
  * ``decode``  one batched decode step: every active slot gathers its blocks
                up to ``pos`` and appends one token's KV at ``pos``
  * ``free``    a finished request returned its blocks (realloc churn)
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Tuple

import numpy as np

__all__ = [
    "AllocEvent",
    "PrefillEvent",
    "DecodeEvent",
    "FreeEvent",
    "ServingAccessRecord",
    "KVAccessRecorder",
    "record_serving_run",
]


@dataclass(frozen=True)
class AllocEvent:
    step: int
    rid: int
    blocks: Tuple[int, ...]


@dataclass(frozen=True)
class PrefillEvent:
    step: int
    slot: int
    rid: int
    n_tokens: int  # prompt length actually written
    blocks: Tuple[int, ...]  # the request's full allocation


@dataclass(frozen=True)
class DecodeEvent:
    step: int
    slot: int
    rid: int
    pos: int  # KV positions [0, pos) read; pos written
    blocks: Tuple[int, ...]  # the request's full allocation


@dataclass(frozen=True)
class FreeEvent:
    step: int
    rid: int
    blocks: Tuple[int, ...]


@dataclass
class ServingAccessRecord:
    """One recorded engine run: pool geometry and the ordered event stream."""

    num_blocks: int
    block_size: int  # tokens per KV block
    num_banks: int
    max_batch: int  # decode slots == decode ports
    allocs: List[AllocEvent] = field(default_factory=list)
    prefills: List[PrefillEvent] = field(default_factory=list)
    decodes: List[DecodeEvent] = field(default_factory=list)
    frees: List[FreeEvent] = field(default_factory=list)
    steps: int = 0  # engine steps covered by the record

    @property
    def num_requests(self) -> int:
        return len({e.rid for e in self.prefills})

    def events_key(self) -> tuple:
        """Hashable fingerprint of the full stream."""
        return (
            self.num_blocks,
            self.block_size,
            self.num_banks,
            self.max_batch,
            self.steps,
            tuple(self.allocs),
            tuple(self.prefills),
            tuple(self.decodes),
            tuple(self.frees),
        )

    def summary(self) -> dict:
        return {
            "steps": self.steps,
            "requests": self.num_requests,
            "allocs": len(self.allocs),
            "prefill_events": len(self.prefills),
            "decode_events": len(self.decodes),
            "frees": len(self.frees),
            "blocks": self.num_blocks,
            "block_size": self.block_size,
        }


class KVAccessRecorder:
    """Hook object the engine and pool call into while running.

    The engine sets ``recorder.step`` at the top of each iteration; the pool's
    alloc/free hooks and the engine's prefill/decode hooks then stamp their
    events with it.  Attach it with ``ServingEngine(..., recorder=...)``,
    which also wires the pool, or pass it to ``BankedKVPool`` directly."""

    def __init__(self) -> None:
        self.step = 0
        self.record: Optional[ServingAccessRecord] = None

    def bind_pool(self, num_blocks: int, block_size: int, num_banks: int, max_batch: int) -> None:
        self.record = ServingAccessRecord(num_blocks, block_size, num_banks, max_batch)

    # ---- pool hooks ----
    def on_alloc(self, rid: int, blocks) -> None:
        self.record.allocs.append(AllocEvent(self.step, rid, tuple(blocks)))

    def on_free(self, rid: int, blocks) -> None:
        self.record.frees.append(FreeEvent(self.step, rid, tuple(blocks)))

    # ---- engine hooks ----
    def on_prefill(self, slot: int, rid: int, n_tokens: int, blocks) -> None:
        self.record.prefills.append(PrefillEvent(self.step, slot, rid, n_tokens, tuple(blocks)))

    def on_decode(self, slot: int, rid: int, pos: int, blocks) -> None:
        self.record.decodes.append(DecodeEvent(self.step, slot, rid, pos, tuple(blocks)))

    def end_step(self) -> None:
        self.step += 1
        self.record.steps = self.step


def record_serving_run(
    *,
    num_requests: int = 32,
    max_batch: int = 8,
    max_len: int = 96,
    block_size: int = 16,
    prompt_lo: int = 16,
    prompt_hi: int = 48,
    max_new_tokens: int = 16,
    seed: int = 0,
    max_steps: Optional[int] = 4000,
) -> ServingAccessRecord:
    """Record a traffic-only :class:`ServingEngine` run.

    Builds the engine with ``params=None`` (the same control flow, no model
    and no device), submits ``num_requests`` prompts of random length, runs
    to drain, and returns the access record.  Deterministic in ``seed``.

    ``max_steps=None`` sizes the step budget from the workload itself (every
    request decodes at most ``max_new_tokens`` steps and each admission wave
    adds at most one prefill step), so a recording of thousands of requests
    cannot be cut short silently; the recording raises if the engine fails
    to drain within the budget."""
    from repro_torch.serving.engine import ServingEngine

    if max_steps is None:
        waves = -(-num_requests // max_batch)
        max_steps = 64 + waves * (max_new_tokens + 2)
    rec = KVAccessRecorder()
    eng = ServingEngine(
        None, None, max_batch=max_batch, max_len=max_len, block_size=block_size, recorder=rec
    )
    rng = np.random.default_rng(seed)
    for _ in range(num_requests):
        n = int(rng.integers(prompt_lo, prompt_hi))
        eng.submit(np.zeros(n, np.int32), max_new_tokens=max_new_tokens)
    eng.run(max_steps=max_steps)
    if len(rec.record.frees) < num_requests:
        raise RuntimeError(
            f"recording drained only {len(rec.record.frees)} of {num_requests} requests within "
            f"{max_steps} steps: raise max_steps (or pass max_steps=None to size it)"
        )
    return rec.record
