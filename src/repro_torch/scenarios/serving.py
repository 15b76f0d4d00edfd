"""LLM-serving co-sim: recorded engine access streams -> fabric traffic.

The bridge between the two halves of the repo.  A
:class:`~repro_torch.serving.record.ServingAccessRecord` (captured from a
:class:`~repro_torch.serving.engine.ServingEngine` run) is compiled into
simulator ``Trace`` rows by :class:`ServingSource`, one traffic source per
engine port:

  * ``decode`` port *i* replays decode slot *i*'s per-step KV gathers (read
    the whole prefix ``[0, pos)`` across the request's pool blocks, then
    append one token's KV at ``pos``).  Decode is the latency-critical class:
    every gather must finish inside the step budget or the batch stalls.
  * ``prefill`` port *j* replays prompt slab writes (round-robin over the
    admission order), paced one beat per cycle per port: long bursty DMAs,
    throughput-class traffic.

Block -> beat placement mirrors ``BankedKVPool.bank_of``: pool banks are
contiguous slabs of the block array, and block ``b`` maps to the linear span
``lo + b * block_beats``, so the allocator's fractal bank-spreading (or a
sequential allocator's camping) reaches the fabric's banks as the pool
decided it.

All serving ports share one KV-pool address span; they declare
``share_group="kv_pool"`` so the scenario DSL's isolation contract treats
them as one logical master (the pool's block-ownership invariant, no two
requests touching the same block, is enforced on the serving side).

``serving_scenario(record)`` assembles the full Scenario: decode slots as
``realtime`` masters, prefill ports as ``besteffort`` (regulated) masters,
ready for ``.compile().simulate_batch(...)`` next to any synthetic preset.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.address import MemoryGeometry
from repro_torch.scenarios.spec import MasterSpec, Scenario
from repro_torch.serving.record import ServingAccessRecord

__all__ = ["ServingSource", "serving_scenario", "KV_SHARE_GROUP"]

#: share_group every serving port declares (they share the KV pool span)
KV_SHARE_GROUP = "kv_pool"


@dataclass(frozen=True)
class ServingSource:
    """Traffic source replaying one serving port's recorded KV accesses.

    ``kind="decode"``: replay decode slot ``index``.  ``kind="prefill"``:
    replay prefill events ``index, index + P, index + 2P, ...`` (admission
    order, round-robin over ``num_prefill_ports``).  The synthetic knobs
    (``txns``/``rate``/``seed``) are ignored: the stream is the record.

    ``cycles_per_step`` is the engine-step -> fabric-cycle exchange rate: an
    event at engine step ``s`` issues at ``s * cycles_per_step`` at the
    earliest (decode) or is paced from there (prefill).  Smaller values
    compress the same stream into fewer cycles, i.e. raise the offered load.
    """

    record: ServingAccessRecord
    kind: str  # "decode" | "prefill"
    index: int  # slot id (decode) / port id (prefill)
    num_prefill_ports: int = 2
    beats_per_token: int = 2  # KV bytes per token / beat width
    cycles_per_step: int = 256  # fabric cycles per engine step
    max_burst: int = 16  # fabric burst cap (SimParams.max_burst)

    def __post_init__(self):
        if self.kind not in ("decode", "prefill"):
            raise ValueError(f"kind must be 'decode'|'prefill'; got {self.kind!r}")
        if self.kind == "decode" and not 0 <= self.index < self.record.max_batch:
            raise ValueError(
                f"decode slot {self.index} out of range for max_batch={self.record.max_batch}"
            )
        if self.kind == "prefill" and not 0 <= self.index < self.num_prefill_ports:
            raise ValueError(
                f"prefill port {self.index} out of range for {self.num_prefill_ports} ports"
            )

    @property
    def block_beats(self) -> int:
        return self.record.block_size * self.beats_per_token

    def span_beats(self) -> int:
        """Beats of address space the pool needs."""
        return self.record.num_blocks * self.block_beats

    def _block_lo(self, lo: int, block: int) -> int:
        # linear block placement keeps BankedKVPool.bank_of (pool banks are
        # contiguous slabs of the block index space)
        return lo + block * self.block_beats

    def _bursts_for_tokens(self, lo: int, blocks, n_tokens: int) -> List[Tuple[int, int]]:
        """(addr, burst) covering tokens [0, n_tokens) of a request laid out
        over its ``blocks``, split at block and max_burst boundaries."""
        out: List[Tuple[int, int]] = []
        bs = self.record.block_size
        for k in range((n_tokens + bs - 1) // bs):
            ntok = min(bs, n_tokens - k * bs)
            base = self._block_lo(lo, blocks[k])
            beats = ntok * self.beats_per_token
            for off in range(0, beats, self.max_burst):
                out.append((base + off, min(self.max_burst, beats - off)))
        return out

    def emit(
        self, lo: int, hi: int, *, txns: int, rate: float, seed: int, params: Dict
    ) -> Tuple[np.ndarray, ...]:
        need = self.span_beats()
        if hi - lo < need:
            raise ValueError(
                f"serving region [{lo}, {hi}) too small: the recorded pool "
                f"({self.record.num_blocks} blocks × {self.block_beats} beats) needs {need} beats"
            )
        iw: List[int] = []
        b: List[int] = []
        a: List[int] = []
        s: List[int] = []
        cps = self.cycles_per_step
        if self.kind == "decode":
            for ev in self.record.decodes:
                if ev.slot != self.index:
                    continue
                t0 = ev.step * cps
                # gather the whole KV prefix [0, pos): the batched decode read
                for addr, burst in self._bursts_for_tokens(lo, ev.blocks, ev.pos):
                    iw.append(0)
                    b.append(burst)
                    a.append(addr)
                    s.append(t0)
                # append this step's token KV at pos
                blk = ev.blocks[ev.pos // self.record.block_size]
                off = (ev.pos % self.record.block_size) * self.beats_per_token
                iw.append(1)
                b.append(self.beats_per_token)
                a.append(self._block_lo(lo, blk) + off)
                s.append(t0)
        else:
            clock = 0  # per-port DMA clock: about one beat per cycle
            for k, ev in enumerate(self.record.prefills):
                if k % self.num_prefill_ports != self.index:
                    continue
                # the whole slab DMA is eligible at once (outstanding credits
                # pace the issue); the port clock only keeps successive events
                # on one port from stacking instantly
                t0 = max(ev.step * cps, clock)
                cum = 0
                for addr, burst in self._bursts_for_tokens(lo, ev.blocks, ev.n_tokens):
                    iw.append(1)
                    b.append(burst)
                    a.append(addr)
                    s.append(t0)
                    cum += burst
                clock = t0 + cum
        return (
            np.asarray(iw, np.int32),
            np.asarray(b, np.int32),
            np.asarray(a, np.int32),
            np.asarray(s, np.int32),
        )


def serving_scenario(
    record: ServingAccessRecord,
    *,
    name: str = "serving_cosim",
    geom: MemoryGeometry = MemoryGeometry(),
    num_prefill_ports: int = 2,
    beats_per_token: int = 2,
    cycles_per_step: int = 256,
    region: Optional[Tuple[int, int]] = None,
    decode_qos: str = "realtime",
    prefill_qos: str = "besteffort",
    decode_deadline: Optional[int] = None,
    include_prefill: bool = True,
) -> Scenario:
    """Assemble the co-sim Scenario from one recorded engine run.

    One ``decode_qos`` master per decode slot and ``num_prefill_ports``
    ``prefill_qos`` DMA masters, all sharing the KV-pool span (declared via
    ``share_group``).  ``include_prefill=False`` builds the decode-alone
    baseline over the same placement: the co-sim's victim-alone point.
    ``decode_deadline`` (cycles past each gather's step start) feeds the
    per-class deadline-miss accounting; ``cycles_per_step`` is the step
    budget, so the natural choice is the budget itself."""
    probe = ServingSource(record, "decode", 0, num_prefill_ports, beats_per_token, cycles_per_step)
    need = probe.span_beats()
    if region is None:
        region = (0, max(need, 256))
    masters = [
        MasterSpec(
            model=ServingSource(
                record, "decode", slot, num_prefill_ports, beats_per_token, cycles_per_step
            ),
            qos=decode_qos,
            region=region,
            share_group=KV_SHARE_GROUP,
            deadline=decode_deadline,
            txns=1,
        )
        for slot in range(record.max_batch)
    ]
    if include_prefill:
        masters += [
            MasterSpec(
                model=ServingSource(
                    record, "prefill", j, num_prefill_ports, beats_per_token, cycles_per_step
                ),
                qos=prefill_qos,
                region=region,
                share_group=KV_SHARE_GROUP,
                txns=1,
            )
            for j in range(num_prefill_ports)
        ]
    return Scenario(
        name=name,
        masters=masters,
        geom=geom,
        description=f"recorded serving run: {record.num_requests} requests, "
        f"{record.steps} steps, {record.max_batch} decode slots, "
        f"{num_prefill_ports} prefill ports",
    )
