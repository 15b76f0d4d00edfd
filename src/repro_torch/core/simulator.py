"""Cycle-level simulator of the many-ported banked shared memory (§II-C/§III).

The PyTorch port of the reference package's simulator.  A :class:`Trace` (or
a packed :class:`~repro_torch.core.traffic.EventSchedule`) goes into
:func:`simulate`, or a batch of them into :func:`simulate_batch`, which run
the cycle stages

  ``accept_dispatch``  acceptance (credits, regulator, router admission) and
                       split-by-4 dispatch into the per-port beat-slot ring
  ``bank_arbitrate``   per-bank QoS arbitration, one grant per bank per cycle
                       (the bank-arbiter kernel)
  ``router_release``   inter-slice ingress-credit release + per-slice counts
  ``return_bus``       read-return bus, one beat per port per cycle
  ``retire``           transaction completion + busy-cycle accounting

once per simulated cycle and return the reference package's metrics, with
its dtypes, as numpy arrays.  ``SCHEDULE_PIPELINE`` swaps the first and last
stages for ``accept_dispatch_sched`` and ``retire_sched``, which advance a
packed event schedule inside the loop (beat-to-bank routing per cycle, live
commands in a fixed-width in-flight table) and, with ``collect="stream"``,
fold completions into fixed-size streaming accumulators (P² percentiles).

The model is the reference's, decision for decision: X master ports with
256-bit buses, two-level split-by-4 dispatch, priority-first / FCFS /
round-robin bank arbitration with anti-starvation aging, an optional
best-effort token-bucket regulator, SRAMs at half the fabric clock, per-port
credits, and a multi-slice ring router with per-hop
latency and per-slice ingress credits.

Every :class:`SimState` field carries a leading batch axis ``B`` (one lane per
simulated point; :func:`simulate` runs ``B = 1``).  Stages are registered by
name (:func:`register_stage`) with the signature
``stage(state, wires, ctx) -> (state, wires)``: ``wires`` carries the values
stages hand each other within a cycle, ``ctx`` the run's constant tensors and
the ``[B]`` dyn-parameter tensors.  Inside a stage nothing reads a tensor back
to the host.  The cycle driver (:func:`_run_cycles`) is a Python loop; with
``early_exit`` it steps ``block_cycles``-cycle blocks and reads one flag back
per block, holding each lane still once it has drained (or skipping its idle
stretches, on the schedule pipeline), and stops once no lane is left to step.

The entry points run on the CUDA device unless the caller names another
(the tests pass ``device="cpu"``).  On CUDA the arbitration stage launches the
hand-written Hopper kernel; ``SimParams(arbiter="ref")`` selects the plain
PyTorch version instead, which is what a run compares the kernel with.  On
CUDA the cycle body replays as two CUDA graphs, one on each side of the
arbiter's call (:class:`_GraphedCycle`); on the CPU it runs op by op.

Comparator topologies (§II-A): ``banking='paper'`` (the proposed structure),
``'linear'`` (monolithic region-per-bank banking) and ``'no_fractal'``
(round-robin clusters without the second-level hash).
"""

from __future__ import annotations

from dataclasses import dataclass, fields
from dataclasses import replace as dataclasses_replace
from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.address import (
    MemoryGeometry,
    flat_bank_id,
    flat_bank_id_dev,
    master_home_slices,
    slice_of_bank,
    slice_of_beat,
    slice_of_beat_dev,
)
from repro_torch.core.percentile import STREAM_PCTS, desired_fracs, p2_update
from repro_torch.core.qos import aging_boost, arbitration_priority_key
from repro_torch.core.state import (
    INF32,
    REG_SCALE,
    SLOT_GRANTED,
    SLOT_IDLE,
    SLOT_WAITING,
    SimState,
    bank_dtype,
    init_state,
    pack_slot_flags,
    unpack_slot_flags,
    widen,
)
from repro_torch.kernels.bank_arbiter.ops import bank_arbiter_winners
from repro_torch.kernels.bank_arbiter.ref import bank_arbiter_ref

#: SimParams fields that enter the cycle loop as per-lane ``[B]`` tensors.
#: Order defines the layout of the ``dyn`` vector.
DYN_FIELDS = (
    "outstanding",
    "split_buffer",
    "cmd_latency",
    "ret_latency",
    "bank_occupancy",
    "bank_latency",
    "qos_aging",
    "reg_rate",
    "reg_burst",
    "hop_latency",
    "slice_ingress",
)

#: distinct QoS priority levels the arbiter keys on (0 = most critical)
PRIO_LEVELS = 8
#: masters at this priority level or numerically higher are regulated
REGULATED_PRIO = 2
#: ``max_burst`` ceiling: per-transaction remaining-beat counters are int8
MAX_BURST_LIMIT = 127
#: ``outstanding``/``split_buffer`` ceiling: credit counters are int16
CREDIT_LIMIT = 2**14

#: streaming-collection QoS class slots: the three QoS classes in their
#: canonical order plus one trailing "unclassified" slot (padding rows,
#: schedules compiled without class info)
STREAM_CLASSES = 4
#: class index of the trailing unclassified slot
UNCLASSIFIED = STREAM_CLASSES - 1

#: per-bank comparator backends: the Hopper kernel (CPU tensors take its plain
#: version) or, explicitly, the plain PyTorch version on any device
ARBITERS = ("kernel", "ref")

DEFAULT_PIPELINE = ("accept_dispatch", "bank_arbitrate", "router_release", "return_bus", "retire")
#: the event-schedule pipeline: packed per-master schedules advanced inside
#: the loop; select it with ``SimParams(stages=SCHEDULE_PIPELINE)``
SCHEDULE_PIPELINE = (
    "accept_dispatch_sched",
    "bank_arbitrate",
    "router_release",
    "return_bus",
    "retire_sched",
)

#: what the cycle driver did since :func:`reset_driver_counts`: cycle bodies
#: stepped (each steps every lane of its batch once and, on CUDA, launches the
#: arbiter kernel once) and host reads of a device flag (one per block)
DRIVER_COUNTS = {"cycles": 0, "host_reads": 0}


def reset_driver_counts() -> None:
    for name in DRIVER_COUNTS:
        DRIVER_COUNTS[name] = 0


@dataclass(frozen=True)
class SimParams:
    geom: MemoryGeometry = MemoryGeometry()
    outstanding: int = 8  # commands per port (Table I: 16 / 1)
    split_buffer: int = 64  # beats in flight past the splitter, per port
    cmd_latency: int = 8  # port -> bank-queue pipeline (fabric cycles)
    ret_latency: int = 9  # bank -> port pipeline
    bank_occupancy: int = 2  # SRAM at 500 MHz vs 1 GHz fabric
    bank_latency: int = 2  # access latency before data heads back
    qos_aging: int = 128  # cycles of waiting per priority-level boost (0 = off)
    reg_rate: int = 0  # regulator refill, 1/256 beats per cycle (0 = off)
    reg_burst: int = 16  # regulator bucket depth, beats
    hop_latency: int = 6  # inter-slice router, cycles per ring hop (both ways)
    slice_ingress: int = 0  # remote beats in flight per slice (0 = uncapped)
    expand_rate: int = 4  # split-by-4: beats entering the fabric per cycle
    max_burst: int = 16
    banking: str = "paper"  # paper | linear | no_fractal
    max_cycles: int = 200_000
    slots_override: Optional[int] = None  # force a common ring size (batching)
    stages: Optional[Tuple[str, ...]] = None  # None = DEFAULT_PIPELINE
    arbiter: str = "kernel"  # per-bank comparator backend: kernel | ref
    collect: str = "exact"  # exact | stream: per-txn timestamps or P² accumulators
    inflight_override: Optional[int] = None  # force a common in-flight table (batching)
    early_exit: bool = True  # stop stepping once every lane has drained
    block_cycles: int = 32  # K: cycles between two drain checks
    time_skip: bool = True  # schedule pipeline + early_exit: jump idle stretches

    @property
    def slots_per_master(self) -> int:
        # enough ring slots for every accepted command's beats
        if self.slots_override is not None:
            return int(self.slots_override)
        return int(
            2 ** np.ceil(np.log2(max(self.outstanding * self.max_burst, self.split_buffer) * 2))
        )

    @property
    def inflight_slots(self) -> int:
        """Schedule-pipeline in-flight table width: a port's two AXI channels
        can each hold ``outstanding`` live commands, so 2x covers them."""
        if self.inflight_override is not None:
            return int(self.inflight_override)
        return int(2 ** np.ceil(np.log2(max(2 * self.outstanding, 2))))

    def static_key(self) -> tuple:
        """Fields that must agree across every point of one batch."""
        return (
            self.geom,
            self.expand_rate,
            self.max_burst,
            self.banking,
            self.max_cycles,
            self.stages,
            self.arbiter,
            self.collect,
            self.early_exit,
            self.block_cycles,
            self.time_skip,
        )

    def dyn_vector(self) -> np.ndarray:
        """The per-lane parameter vector (see ``DYN_FIELDS``)."""
        if not (0 <= self.outstanding < CREDIT_LIMIT and 0 <= self.split_buffer < CREDIT_LIMIT):
            raise ValueError(
                f"outstanding/split_buffer must be in [0, {CREDIT_LIMIT}) "
                f"(int16 credit counters); got {self.outstanding}/{self.split_buffer}"
            )
        if self.reg_burst * REG_SCALE >= 2**30:
            raise ValueError(f"reg_burst too large: {self.reg_burst}")
        return np.array([getattr(self, f) for f in DYN_FIELDS], np.int32)

    def pipeline(self) -> Tuple[str, ...]:
        """The stage names one cycle runs, validated loudly."""
        names = tuple(self.stages) if self.stages else DEFAULT_PIPELINE
        unknown = [n for n in names if n not in STAGE_REGISTRY]
        if unknown:
            raise ValueError(
                f"unknown stage(s) {unknown}; registered stages: {sorted(STAGE_REGISTRY)}"
            )
        if self.collect not in ("exact", "stream"):
            raise ValueError(f"collect must be 'exact' or 'stream'; got {self.collect!r}")
        if self.collect == "stream" and "retire_sched" not in names:
            raise ValueError(
                "collect='stream' needs the schedule pipeline (streaming accumulators live "
                "in the in-flight table the dense stages do not maintain); "
                "set stages=SCHEDULE_PIPELINE"
            )
        if self.arbiter not in ARBITERS:
            raise ValueError(f"unknown arbiter {self.arbiter!r}; pick from {ARBITERS}")
        if self.block_cycles < 1:
            raise ValueError(f"block_cycles must be >= 1; got {self.block_cycles}")
        return names

    def uses_schedule(self) -> bool:
        """True when this point runs the event-schedule pipeline."""
        names = self.pipeline()
        return "accept_sched" in names or "accept_dispatch_sched" in names


def bank_of(addr, prm: SimParams):
    """Global bank id of each beat address under ``prm.banking`` (numpy)."""
    g = prm.geom
    if prm.banking == "paper":
        return flat_bank_id(addr, g)
    if prm.banking == "linear":
        a = np.asarray(addr).astype(np.int64)
        region = g.beats_total // g.num_banks
        return np.clip(a // region, 0, g.num_banks - 1).astype(np.int32)
    if prm.banking == "no_fractal":  # structural split only, no hash
        sl, local = slice_of_beat(addr, g)
        a = np.asarray(local).astype(np.int64)
        c = a % g.num_clusters
        arr = (a // g.num_clusters) % g.arrays_per_cluster
        bank = (a // (g.num_clusters * g.arrays_per_cluster)) % g.banks_per_array
        flat = (c * g.arrays_per_cluster + arr) * g.banks_per_array + bank
        return (np.asarray(sl).astype(np.int64) * g.banks_per_slice + flat).astype(np.int32)
    raise ValueError(prm.banking)


def bank_of_dev(addr: torch.Tensor, prm: SimParams) -> torch.Tensor:
    """Tensor (int32) twin of :func:`bank_of`: the schedule pipeline maps the
    candidate burst's beats to banks inside the cycle loop.  Addresses must
    already lie in ``[0, beats_total)``."""
    g = prm.geom
    if prm.banking == "paper":
        return flat_bank_id_dev(addr, g)
    if prm.banking == "linear":
        return torch.clamp(addr // (g.beats_total // g.num_banks), 0, g.num_banks - 1)
    if prm.banking == "no_fractal":
        sl, local = slice_of_beat_dev(addr, g)
        c = local % g.num_clusters
        arr = (local // g.num_clusters) % g.arrays_per_cluster
        bank = (local // (g.num_clusters * g.arrays_per_cluster)) % g.banks_per_array
        flat = (c * g.arrays_per_cluster + arr) * g.banks_per_array + bank
        return sl * g.banks_per_slice + flat
    raise ValueError(prm.banking)


# ---------------------------------------------------------------------------
# Trace container: per master, padded to a common transaction count
# ---------------------------------------------------------------------------


@dataclass
class Trace:
    """is_write/burst/addr: [X, N] int32 (addr in beat units; burst==0 => pad).

    ``start`` (optional, [X, N] int32) is the earliest cycle at which a
    transaction may be offered at its port; ``None`` means cycle 0.
    ``prio`` (optional, [X] int32) is the per-master QoS level (0 = most
    critical); ``None`` means every master is level 0.
    """

    is_write: np.ndarray
    burst: np.ndarray
    addr: np.ndarray
    start: Optional[np.ndarray] = None
    prio: Optional[np.ndarray] = None

    @property
    def num_masters(self) -> int:
        return self.is_write.shape[0]

    @property
    def num_txns(self) -> int:
        return self.is_write.shape[1]

    def start_or_zeros(self) -> np.ndarray:
        if self.start is None:
            return np.zeros_like(np.asarray(self.is_write, np.int32))
        return np.asarray(self.start, np.int32)

    def prio_or_zeros(self) -> np.ndarray:
        if self.prio is None:
            return np.zeros((self.num_masters,), np.int32)
        return np.asarray(self.prio, np.int32)


def _precompute_beats(trace: Trace, prm: SimParams):
    """Static per-beat routing (numpy): global bank ids, valid mask, hop
    counts and per-transaction ingress needs ([X, N, num_slices] remote beats
    per destination slice).  Hops and needs key off the *bank's* slice, so
    the router's accounting stays consistent under every banking mode."""
    g = prm.geom
    if prm.max_burst > MAX_BURST_LIMIT:
        raise ValueError(
            f"max_burst must be <= {MAX_BURST_LIMIT} (int8 beat counters); got {prm.max_burst}"
        )
    X, N = trace.addr.shape
    off = np.arange(prm.max_burst)[None, None, :]
    beat_addr = trace.addr[..., None] + off
    valid = off < trace.burst[..., None]
    # an out-of-range beat would map to a phantom bank; the transaction would
    # never complete and the run would spin to max_cycles
    oob = valid & ((beat_addr < 0) | (beat_addr >= g.beats_total))
    if oob.any():
        bad = np.argwhere(oob)[0]
        raise ValueError(
            f"trace addresses out of range: master {bad[0]} txn {bad[1]} "
            f"touches beat {int(beat_addr[tuple(bad)])} but the fabric has "
            f"{g.beats_total} beats ({g.num_slices} slice(s))"
        )
    banks = bank_of(beat_addr.reshape(-1), prm).reshape(X, N, prm.max_burst)
    home = master_home_slices(X, g)
    tgt = slice_of_bank(banks, g)
    d = np.abs(tgt - home[:, None, None])
    hops = np.where(valid, np.minimum(d, g.num_slices - d), 0).astype(np.int32)
    remote = valid & (hops > 0)
    ingress = np.stack([(remote & (tgt == s)).sum(axis=-1) for s in range(g.num_slices)], axis=-1)
    return banks.astype(np.int32), valid, hops, ingress.astype(np.int32)


def _as_input(trace, use_sched: bool):
    """A Trace or EventSchedule as the pipeline runs it: a schedule compiled
    from a trace (unclassified, no deadline) for the schedule pipeline, a
    schedule's trace view for the dense one."""
    from repro_torch.core.traffic import EventSchedule, compile_schedule

    if use_sched:
        return trace if isinstance(trace, EventSchedule) else compile_schedule(trace)
    return trace.to_trace() if isinstance(trace, EventSchedule) else trace


def _validate_schedule(sched, prm: SimParams) -> None:
    """The schedule path's domain checks (it skips ``_precompute_beats``): an
    out-of-range beat would route to a phantom bank and spin to max_cycles;
    a burst past ``max_burst`` would never drain its tail beats."""
    g = prm.geom
    b = np.asarray(sched.burst)
    a = np.asarray(sched.addr)
    if b.max(initial=0) > prm.max_burst:
        bad = np.argwhere(b > prm.max_burst)[0]
        raise ValueError(
            f"schedule burst {int(b[tuple(bad)])} at master {bad[0]} event {bad[1]} exceeds "
            f"max_burst={prm.max_burst}: beats past the dispatch window would never issue"
        )
    oob = (b > 0) & ((a < 0) | (a + b > g.beats_total))
    if oob.any():
        bad = np.argwhere(oob)[0]
        raise ValueError(
            f"schedule addresses out of range: master {bad[0]} event {bad[1]} touches beat "
            f"{int(a[tuple(bad)] + b[tuple(bad)]) - 1} but the fabric has {g.beats_total} "
            f"beats ({g.num_slices} slice(s))"
        )


def _host_args(trace, prm: SimParams, use_sched: bool = False) -> tuple:
    """One point's host-side inputs.  Dense: (is_write, burst, banks, hops,
    ingress, start, prio), all int32.  Schedule: (is_write int8, burst int8,
    addr int32, start int32, prio int8, class int8, deadline int32)."""
    if use_sched:
        _validate_schedule(trace, prm)
        return (
            np.asarray(trace.is_write, np.int8),
            np.asarray(trace.burst, np.int8),
            np.asarray(trace.addr, np.int32),
            np.asarray(trace.start, np.int32),
            np.asarray(trace.prio, np.int8),
            np.asarray(trace.cls, np.int8),
            np.asarray(trace.deadline, np.int32),
        )
    banks, _, hops, ing = _precompute_beats(trace, prm)
    return (
        np.asarray(trace.is_write, np.int32),
        np.asarray(trace.burst, np.int32),
        banks,
        hops,
        ing,
        trace.start_or_zeros(),
        trace.prio_or_zeros(),
    )


def _device_args(prm: SimParams, host, dyn: np.ndarray, device, use_sched: bool = False) -> tuple:
    """Batched host arrays (leading axis B) -> narrow device tensors.  Dense:
    write/burst/hops/prio int8, ingress int16, banks the narrowest dtype that
    indexes the fabric's banks, start int32.  Schedule: write/burst/prio/class
    int8, addr/start/deadline int32.  ``dyn`` int32."""
    i8, i32 = torch.int8, torch.int32
    if use_sched:
        dtypes = (i8, i8, i32, i32, i8, i8, i32, i32)
    else:
        dtypes = (i8, i8, bank_dtype(prm.geom.num_banks), i8, torch.int16, i32, i8, i32)
    return tuple(
        torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(device=device, dtype=t)
        for a, t in zip((*host, dyn), dtypes)
    )


def _age_cap(prm: SimParams, num_masters: int) -> int:
    """Saturation point of the FCFS age term: the next power of two above
    ``max_cycles``, clamped so the packed (level, age, round-robin) key stays
    strictly below the ineligible filler (2**30)."""
    cap = 1 << int(np.ceil(np.log2(max(prm.max_cycles + 1, 256))))
    budget = (2**30 - 1) // (PRIO_LEVELS * max(num_masters, 1)) - 1
    return int(min(cap - 1, budget))


# ---------------------------------------------------------------------------
# Cycle stages: the registry.
#
# Uniform signature: ``stage(state, wires, ctx) -> (state, wires)``.  Every
# stage reads the current cycle from ``state.now`` ([B]); only ``retire``
# advances it.  Columns of ``now`` and of the dyn tensors broadcast over the
# per-lane axes.
# ---------------------------------------------------------------------------

Stage = Callable[[SimState, dict, dict], Tuple[SimState, dict]]

STAGE_REGISTRY: Dict[str, Stage] = {}


def register_stage(name: str):
    """Decorator: add a cycle stage to the registry under ``name``."""

    def deco(fn: Stage) -> Stage:
        STAGE_REGISTRY[name] = fn
        return fn

    return deco


def _take(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``table[b, x, idx[b, x], ...]`` for a ``[B, X, N, ...]`` table."""
    index = idx.long().reshape(*idx.shape, 1, *([1] * (table.dim() - 3)))
    index = index.expand(*idx.shape, 1, *table.shape[3:])
    return torch.gather(table, 2, index).squeeze(2)


def _admit(st: SimState, c, burst, is_w, ready, need):
    """The acceptance gates of both pipelines, one candidate burst per port
    (``burst``, ``is_w``, ``ready`` [B, X]; ``need`` [B, X, NSL], its remote
    beats per destination slice): outstanding credits, split-buffer credits,
    W-data-bus pacing, the best-effort token-bucket regulator and the
    inter-slice router's admission gate.  A burst larger than the bucket or
    the ingress cap is admitted alone and drives the counter into debt
    (delayed, never deadlocked); ports are admitted in index order within the
    cycle, each counting the needs of the lower-indexed candidates.  Returns
    ``can`` [B, X] and the updated port and router fields."""
    d = c["d"]
    now = st.now[:, None]  # [B, 1]
    dirn = is_w.long()[..., None]  # 0 = read, 1 = write
    reg_gate = c["regulated"] & (d["reg_rate"] > 0)[:, None]
    reg_cap = (d["reg_burst"] * REG_SCALE)[:, None]
    reg_tokens = torch.minimum(st.reg_tokens + d["reg_rate"][:, None], reg_cap)
    reg_need = torch.minimum(burst, d["reg_burst"][:, None]) * REG_SCALE
    pre_can = (
        (st.next_txn < c["N"])
        & (burst > 0)
        & ready
        & (torch.gather(st.outstanding, 2, dirn)[..., 0] < d["outstanding"][:, None])
        & (torch.gather(st.credits, 2, dirn)[..., 0] >= burst)
        & ((is_w == 0) | (st.fwd_free <= now))
        & (~reg_gate | (reg_tokens >= reg_need))
    )
    need_cand = torch.where(pre_can[..., None], need, 0)
    prior = torch.cumsum(need_cand, dim=1, dtype=torch.int32) - need_cand  # exclusive
    cap = d["slice_ingress"][:, None, None]
    need_clamped = torch.minimum(need, cap)
    # the per-slice term only applies where the burst needs that slice
    ing_ok = torch.all(
        (cap == 0) | (need_clamped == 0) | (st.ing_used[:, None, :] + prior + need_clamped <= cap),
        dim=2,
    )
    can = pre_can & ing_ok
    can_i = can.to(torch.int32)
    outstanding = widen(st.outstanding).scatter_add(2, dirn, can_i[..., None])
    credits = widen(st.credits).scatter_add(2, dirn, -torch.where(can, burst, 0)[..., None])
    return can, dict(
        next_txn=st.next_txn + can_i,
        outstanding=outstanding.to(st.outstanding.dtype),
        credits=credits.to(st.credits.dtype),
        fwd_free=torch.where(can & (is_w > 0), now + burst, st.fwd_free),
        reg_tokens=reg_tokens - torch.where(can & reg_gate, burst * REG_SCALE, 0),
        ing_used=st.ing_used + torch.where(can[..., None], need, 0).sum(1, dtype=torch.int32),
    )


@register_stage("accept")
def _stage_accept(st: SimState, wires, c):
    """Command acceptance, one per port per cycle (the gates of ``_admit``),
    from the dense pipeline's per-transaction tables."""
    now = st.now[:, None]  # [B, 1]
    nt_c = torch.clamp(st.next_txn, max=c["N"] - 1)
    burst = widen(_take(c["tx_burst"], nt_c))
    is_w = widen(_take(c["tx_write"], nt_c))
    ready = _take(c["tx_start"], nt_c) <= now
    can, upd = _admit(st, c, burst, is_w, ready, widen(_take(c["tx_ing"], nt_c)))
    accept = torch.where(
        can[..., None] & (c["txn_ids"] == nt_c[..., None]), now[..., None], st.accept_cycle
    )
    st = st.replace(accept_cycle=accept, **upd)
    return st, dict(wires, accept=dict(can=can, burst=burst, is_w=is_w, nt_c=nt_c))


@register_stage("dispatch")
def _stage_dispatch(st: SimState, wires, c):
    """Split/dispatch: fan the accepted burst's beats into the port's slot
    ring.  Reads expand ``expand_rate`` beats/cycle at the splitter; write
    data is paced by the 1-beat/cycle port bus; a remote beat's arrival is
    delayed ``hop_latency`` per ring hop.  Slot ``p`` of port ``x`` holds beat
    ``(p - beats_issued[x]) mod P`` of the burst, so the ring write is dense
    over ``[B, X, P]``."""
    prm, d = c["prm"], c["d"]
    acc = wires["accept"]
    now = st.now[:, None, None]
    can, burst, is_w, nt_c = acc["can"], acc["burst"], acc["is_w"], acc["nt_c"]
    off = (c["pos"] - st.beats_issued[..., None]) % c["P"]  # [B, X, P]
    wr = can[..., None] & (off < burst[..., None])
    offc = torch.clamp(off, max=prm.max_burst - 1).long()
    bank_new = torch.gather(_take(c["tx_banks"], nt_c), 2, offc)
    hops_new = torch.gather(_take(c["tx_hops"], nt_c), 2, offc)
    pace = torch.where(is_w[..., None] > 0, off, off // prm.expand_rate)
    arrive = (
        now
        + d["cmd_latency"][:, None, None]
        + pace
        + d["hop_latency"][:, None, None] * widen(hops_new)
    )
    phase, write = unpack_slot_flags(st.sl_flags)
    st = st.replace(
        sl_flags=pack_slot_flags(
            torch.where(wr, SLOT_WAITING, phase), torch.where(wr, is_w[..., None], write)
        ),
        sl_bank=torch.where(wr, bank_new, st.sl_bank),
        sl_arrive=torch.where(wr, arrive, st.sl_arrive),
        sl_ready=torch.where(wr, INF32, st.sl_ready),
        sl_txn=torch.where(wr, nt_c[..., None].to(st.sl_txn.dtype), st.sl_txn),
        sl_hops=torch.where(wr, hops_new, st.sl_hops),
        beats_issued=st.beats_issued + torch.where(can, burst, 0),
    )
    return st, wires


@register_stage("accept_dispatch")
def _stage_accept_dispatch(st: SimState, wires, c):
    """Fused acceptance + dispatch: the composition of the two stages."""
    st, wires = _stage_accept(st, wires, c)
    return _stage_dispatch(st, wires, c)


@register_stage("bank_arbitrate")
def _stage_bank_arbitrate(st: SimState, wires, c):
    """Per-bank arbitration, one grant per bank per cycle: priority level
    first (aging promotes a waiting beat one level per ``qos_aging`` cycles),
    FCFS within a level, round-robin among masters as the tie-break.  A
    granted read's data heads home after the bank's access latency plus the
    router's return-path hops.

    The comparator tree is one ``bank_arbiter_winners`` call over the flat
    ``[B, S]`` slot view; the bookkeeping derives from its ``[B, NB]`` winner
    view."""
    X, P, S, NB = c["X"], c["P"], c["S"], c["NB"]
    prm, d = c["prm"], c["d"]
    B = st.now.shape[0]
    now = st.now[:, None, None]
    phase, write = unpack_slot_flags(st.sl_flags)
    bank = st.sl_bank.reshape(B, S).long()
    waiting = (phase == SLOT_WAITING) & (st.sl_arrive <= now)
    elig = waiting & (torch.gather(st.bank_free, 1, bank).reshape(B, X, P) <= now)
    age = torch.clamp(now - st.sl_arrive, 0, c["AGE_CAP"])
    boost = aging_boost(age, d["qos_aging"][:, None, None])
    level = torch.clamp(c["slot_prio"] - boost, 0, PRIO_LEVELS - 1)
    rr = (c["master_col"] - torch.gather(st.bank_rr, 1, bank).reshape(B, X, P)) % X
    key = arbitration_priority_key(level, age, rr, age_cap=c["AGE_CAP"], num_masters=X)
    win = c["arbitrate"](
        key.reshape(B, S), st.sl_bank.reshape(B, S), elig.reshape(B, S), num_banks=NB
    )
    has_win = win < S
    winc32 = torch.clamp(win, max=S - 1)
    winc = winc32.long()
    wmaster = winc32 // P
    # a slot is granted iff it IS its bank's winner (winners are eligible by
    # construction; a bank with no eligible slot reports the sentinel S)
    granted = c["flat_ids"] == torch.gather(win, 1, bank).reshape(B, X, P)
    wwrite = torch.gather(write.reshape(B, S), 1, winc)
    occ = d["bank_occupancy"][:, None]
    busy_until = torch.maximum(st.bank_free, st.now[:, None]) + occ
    bank_free = torch.where(has_win, busy_until, st.bank_free)
    bank_rr = torch.where(has_win, st.bank_rr + (wmaster - st.bank_rr) % X + 1, st.bank_rr)
    ready = (
        now
        + occ[..., None]
        + d["bank_latency"][:, None, None]
        + d["hop_latency"][:, None, None] * widen(st.sl_hops)
    )
    # freed split-buffer credits per port from the winner view: a one-hot
    # owner matrix [B, X, NB] summed along banks
    owner = has_win[:, None, :] & (wmaster[:, None, :] == c["ar"][:, None])
    freed_r = (owner & (wwrite[:, None, :] == 0)).sum(2, dtype=torch.int32)
    freed_w = (owner & (wwrite[:, None, :] == 1)).sum(2, dtype=torch.int32)
    credits = widen(st.credits) + torch.stack([freed_r, freed_w], dim=2)
    arb = dict(
        has_win=has_win,
        wmaster=wmaster,
        wwrite=wwrite,
        whops=widen(torch.gather(st.sl_hops.reshape(B, S), 1, winc)),
        wtxn=widen(torch.gather(st.sl_txn.reshape(B, S), 1, winc)),
    )
    st = st.replace(
        bank_free=bank_free,
        bank_rr=bank_rr,
        sl_flags=pack_slot_flags(torch.where(granted, SLOT_GRANTED, phase), write),
        sl_ready=torch.where(granted, ready, st.sl_ready),
        credits=credits.to(st.credits.dtype),
    )
    return st, dict(wires, arb=arb)


@register_stage("router_release")
def _stage_router_release(st: SimState, wires, c):
    """Inter-slice router bookkeeping at bank grant: a remote beat leaving the
    ingress queue returns its slice's credit, and per-slice service counters
    feed the occupancy metrics.  Banks are slice-major, so per-slice sums are
    row sums of ``[B, NSL, banks_per_slice]``."""
    B, NSL = st.now.shape[0], c["NSL"]
    has_win, whops = wires["arb"]["has_win"], wires["arb"]["whops"]
    released = (has_win & (whops > 0)).reshape(B, NSL, -1).sum(2, dtype=torch.int32)
    served = has_win.reshape(B, NSL, -1).sum(2, dtype=torch.int32)
    st = st.replace(
        ing_used=st.ing_used - released,
        slice_beats=st.slice_beats + served,
        remote_beats=st.remote_beats + released.sum(1, dtype=torch.int32),
    )
    return st, wires


@register_stage("return_bus")
def _stage_return_bus(st: SimState, wires, c):
    """Read-return bus: one beat per port per cycle, oldest-ready first, the
    lowest slot on a tie (beats may return out of order across banks).
    Write slots free right after grant (no return path)."""
    P = c["P"]
    now = st.now[:, None, None]
    phase, write = unpack_slot_flags(st.sl_flags)
    retq = (phase == SLOT_GRANTED) & (st.sl_ready <= now) & (write == 0)
    rkey = torch.clamp(st.sl_ready, 0, 2**20)
    rbest = torch.where(retq, rkey, 2**30).amin(2, keepdim=True)
    ris = retq & (rkey == rbest)
    rwin = torch.where(ris, c["pos"], P).amin(2, keepdim=True)  # [B, X, 1]
    returned = ris & (c["pos"] == rwin)
    phase = torch.where(returned, SLOT_IDLE, phase)
    ret_any = returned.any(2)
    phase = torch.where((phase == SLOT_GRANTED) & (write == 1), SLOT_IDLE, phase)
    ret_txn = widen(torch.gather(st.sl_txn, 2, torch.clamp(rwin, max=P - 1).long()))[..., 0]
    st = st.replace(
        sl_flags=pack_slot_flags(phase, write),
        beats_done=st.beats_done + ret_any.to(torch.int32),
    )
    return st, dict(wires, ret=dict(ret_any=ret_any, ret_txn=ret_txn))


def _latch_drained(st: SimState, c) -> SimState:
    """Latch ``drained_at`` the first cycle a lane goes quiescent: every
    reachable transaction accepted, no outstanding commands, every beat slot
    idle, all ingress credits returned and no undelivered beat (in the dense
    counters or the in-flight table).  Called on the post-retire state, so the
    latched value counts the cycles after which nothing but ``now`` and the
    capped regulator refill can change."""
    phase, _ = unpack_slot_flags(st.sl_flags)
    drained = (
        (st.next_txn >= c["n_events"]).all(1)
        & (st.outstanding == 0).flatten(1).all(1)
        & (phase == SLOT_IDLE).flatten(1).all(1)
        & (st.ing_used == 0).all(1)
        & (st.remaining <= 0).flatten(1).all(1)
        & (st.ift_remaining == 0).flatten(1).all(1)
    )
    return st.replace(drained_at=torch.where((st.drained_at < 0) & drained, st.now, st.drained_at))


def _port_event_counts(tx_burst: torch.Tensor, N: int) -> torch.Tensor:
    """Per-port count of reachable transactions: acceptance needs burst > 0,
    so the first zero burst (trailing padding) ends the port's stream."""
    idx = torch.arange(N, dtype=torch.int32, device=tx_burst.device)
    return torch.where(tx_burst == 0, idx, N).amin(-1)


@register_stage("retire")
def _stage_retire(st: SimState, wires, c):
    """Transaction completion + busy-cycle accounting: writes complete at the
    grant of their last beat, reads at their last return-bus beat; a port is
    busy while it has an accepted-but-incomplete transaction on that channel.
    Advances the cycle counter.

    The beat decrements are scatter-adds: every bank without a winner sends
    a zero to slot ``S - 1``'s transaction, and several write beats of one
    transaction can be granted in the same cycle, so they must accumulate."""
    d = c["d"]
    B, X, N = st.remaining.shape
    arb, ret = wires["arb"], wires["ret"]
    rem_before = widen(st.remaining)
    wdec = (arb["has_win"] & (arb["wwrite"] == 1)).to(torch.int32)
    flat = rem_before.reshape(B, X * N)
    flat = flat.scatter_add(1, (arb["wmaster"] * N + arb["wtxn"]).long(), -wdec)
    rdec = ret["ret_any"].to(torch.int32)
    flat = flat.scatter_add(1, (c["ar"] * N + ret["ret_txn"]).long(), -rdec)
    remaining = flat.reshape(B, X, N)
    just_done = (remaining == 0) & (rem_before > 0)
    done_at = (st.now + d["ret_latency"])[:, None, None]
    done_r = (just_done & (c["tx_write"] == 0)).sum(2, dtype=torch.int32)
    done_w = (just_done & (c["tx_write"] == 1)).sum(2, dtype=torch.int32)
    outstanding = widen(st.outstanding) - torch.stack([done_r, done_w], dim=2)
    in_r = (outstanding[..., 0] > 0).to(torch.int32)
    in_w = (outstanding[..., 1] > 0).to(torch.int32)
    st = st.replace(
        now=st.now + 1,
        outstanding=outstanding.to(st.outstanding.dtype),
        remaining=remaining.to(st.remaining.dtype),
        complete_cycle=torch.where(just_done, done_at, st.complete_cycle),
        busy_r=st.busy_r + in_r,
        busy_w=st.busy_w + in_w,
        busy_any=st.busy_any + torch.maximum(in_r, in_w),
    )
    return _latch_drained(st, c), wires


@register_stage("accept_sched")
def _stage_accept_sched(st: SimState, wires, c):
    """Schedule-pipeline acceptance: the gates of ``_admit``, but the
    candidate burst's beat -> (bank, hops, ingress need) routing is computed
    in the loop from its address (``bank_of_dev``), and the accepted command
    takes the first free slot of its port's in-flight table."""
    NSL = c["NSL"]
    now = st.now[:, None]  # [B, 1]
    nt_c = torch.clamp(st.next_txn, max=c["N"] - 1)
    burst = widen(_take(c["tx_burst"], nt_c))
    is_w = widen(_take(c["tx_write"], nt_c))
    start = _take(c["tx_start"], nt_c)
    # in-loop routing of the candidate bursts only ([B, X, max_burst])
    off = c["beat_off"]
    bvalid = off < burst[..., None]
    beat = torch.where(bvalid, _take(c["tx_addr"], nt_c)[..., None] + off, 0)
    banks_txn = bank_of_dev(beat, c["prm"])
    tgt = banks_txn // c["banks_per_slice"]
    dist = (tgt - c["home"][:, None]).abs()
    hops_txn = torch.where(bvalid, torch.minimum(dist, NSL - dist), 0)
    remote = bvalid & (hops_txn > 0)
    slices = torch.arange(NSL, dtype=torch.int32, device=tgt.device)
    need = (remote[..., None] & (tgt[..., None] == slices)).sum(2, dtype=torch.int32)
    can, upd = _admit(st, c, burst, is_w, start <= now, need)
    # in-flight table allocation: the credit gate caps live commands at
    # 2 x outstanding - 1 < F, so a free slot (remaining == 0) always exists;
    # the first free one is taken
    F = st.ift_remaining.shape[2]
    slots = torch.arange(F, dtype=torch.int32, device=now.device)
    first = torch.where(st.ift_remaining == 0, slots, F).amin(2)
    idx = torch.where(first < F, first, 0)[..., None].long()  # [B, X, 1]

    def put(tbl, val):
        keep = widen(torch.gather(tbl, 2, idx))[..., 0]
        return tbl.scatter(2, idx, torch.where(can, val, keep)[..., None].to(tbl.dtype))

    upd.update(
        ift_write=put(st.ift_write, is_w),
        ift_burst=put(st.ift_burst, burst),
        ift_remaining=put(st.ift_remaining, burst),
        ift_accept=put(st.ift_accept, now.expand_as(burst)),
        ift_start=put(st.ift_start, start),
        ift_txn=put(st.ift_txn, nt_c),
    )
    if c["exact"]:
        upd["accept_cycle"] = st.accept_cycle.scatter_reduce(
            2, nt_c[..., None].long(), torch.where(can, now, -1)[..., None], "amax"
        )
    st = st.replace(**upd)
    accept = dict(
        can=can,
        burst=burst,
        is_w=is_w,
        nt_c=nt_c,
        banks_txn=banks_txn,
        hops_txn=hops_txn,
        ift_idx=idx[..., 0],
    )
    return st, dict(wires, accept=accept)


@register_stage("dispatch_sched")
def _stage_dispatch_sched(st: SimState, wires, c):
    """Schedule-pipeline dispatch: the ring math of ``dispatch``, with the
    burst's per-beat banks and hops from the accept wires (computed in the
    loop) and each slot recording its command's in-flight-table index."""
    prm, d = c["prm"], c["d"]
    acc = wires["accept"]
    now = st.now[:, None, None]
    can, burst, is_w = acc["can"], acc["burst"], acc["is_w"]
    off = (c["pos"] - st.beats_issued[..., None]) % c["P"]  # [B, X, P]
    wr = can[..., None] & (off < burst[..., None])
    offc = torch.clamp(off, max=prm.max_burst - 1).long()
    bank_new = torch.gather(acc["banks_txn"], 2, offc)
    hops_new = torch.gather(acc["hops_txn"], 2, offc)
    pace = torch.where(is_w[..., None] > 0, off, off // prm.expand_rate)
    arrive = (
        now + d["cmd_latency"][:, None, None] + pace + d["hop_latency"][:, None, None] * hops_new
    )
    phase, write = unpack_slot_flags(st.sl_flags)
    st = st.replace(
        sl_flags=pack_slot_flags(
            torch.where(wr, SLOT_WAITING, phase), torch.where(wr, is_w[..., None], write)
        ),
        sl_bank=torch.where(wr, bank_new.to(st.sl_bank.dtype), st.sl_bank),
        sl_arrive=torch.where(wr, arrive, st.sl_arrive),
        sl_ready=torch.where(wr, INF32, st.sl_ready),
        sl_txn=torch.where(wr, acc["ift_idx"][..., None].to(st.sl_txn.dtype), st.sl_txn),
        sl_hops=torch.where(wr, hops_new.to(torch.int8), st.sl_hops),
        beats_issued=st.beats_issued + torch.where(can, burst, 0),
    )
    return st, wires


@register_stage("accept_dispatch_sched")
def _stage_accept_dispatch_sched(st: SimState, wires, c):
    """Fused schedule-pipeline acceptance + dispatch."""
    st, wires = _stage_accept_sched(st, wires, c)
    return _stage_dispatch_sched(st, wires, c)


@register_stage("retire_sched")
def _stage_retire_sched(st: SimState, wires, c):
    """Schedule-pipeline retire: the completion logic of ``retire`` on the
    ``[B, X, F]`` in-flight table.  ``collect="exact"`` scatters timestamps
    back to the ``[B, X, N]`` arrays; ``collect="stream"`` folds each
    completion into the fixed-size accumulators: per-port windows for
    throughput, P² marker groups per (view, class, direction) for latency
    percentiles, per-class deadline counters.

    Several banks can grant write beats of one command in one cycle, so the
    beat decrements accumulate (scatter-adds, as in ``retire``)."""
    d = c["d"]
    B, X, F = st.ift_remaining.shape
    arb, ret = wires["arb"], wires["ret"]
    rem_before = widen(st.ift_remaining)
    wdec = (arb["has_win"] & (arb["wwrite"] == 1)).to(torch.int32)
    flat = rem_before.reshape(B, X * F)
    flat = flat.scatter_add(1, (arb["wmaster"] * F + arb["wtxn"]).long(), -wdec)
    rdec = ret["ret_any"].to(torch.int32)
    flat = flat.scatter_add(1, (c["ar"] * F + ret["ret_txn"]).long(), -rdec)
    remaining = flat.reshape(B, X, F)
    just_done = (remaining == 0) & (rem_before > 0)
    iw = widen(st.ift_write)
    jr = just_done & (iw == 0)
    jw = just_done & (iw == 1)
    outstanding = widen(st.outstanding) - torch.stack(
        [jr.sum(2, dtype=torch.int32), jw.sum(2, dtype=torch.int32)], dim=2
    )
    in_r = (outstanding[..., 0] > 0).to(torch.int32)
    in_w = (outstanding[..., 1] > 0).to(torch.int32)
    complete_t = (st.now + d["ret_latency"])[:, None, None]  # [B, 1, 1]
    upd = dict(
        now=st.now + 1,
        outstanding=outstanding.to(st.outstanding.dtype),
        ift_remaining=remaining.to(st.ift_remaining.dtype),
        busy_r=st.busy_r + in_r,
        busy_w=st.busy_w + in_w,
        busy_any=st.busy_any + torch.maximum(in_r, in_w),
    )
    if c["exact"]:
        upd["complete_cycle"] = st.complete_cycle.scatter_reduce(
            2, st.ift_txn.long(), torch.where(just_done, complete_t, -1), "amax"
        )
        return _latch_drained(st.replace(**upd), c), wires

    # --- streaming accumulators (collect="stream") ---
    acc = st.ift_accept
    bts = widen(st.ift_burst)
    lat = (complete_t - acc).to(torch.float32)
    e2e = (complete_t - st.ift_start).to(torch.float32)

    def per_dir(fn):
        return torch.stack([fn(jr), fn(jw)], dim=2)  # [B, X, 2]

    upd.update(
        pt_first=torch.minimum(st.pt_first, per_dir(lambda s: torch.where(s, acc, INF32).amin(2))),
        pt_last=torch.where(per_dir(lambda s: s.any(2)), complete_t, st.pt_last),
        pt_beats=st.pt_beats + per_dir(lambda s: torch.where(s, bts, 0).sum(2, dtype=torch.int32)),
        pt_count=st.pt_count + per_dir(lambda s: s.sum(2, dtype=torch.int32)),
        pt_lat_sum=st.pt_lat_sum + per_dir(lambda s: torch.where(s, lat, 0.0).sum(2)),
        pt_lat_max=torch.maximum(
            st.pt_lat_max, per_dir(lambda s: torch.where(s, lat, 0.0).amax(2))
        ),
    )
    NC = c["NC"]
    cls = widen(c["tx_class"])[..., None].expand(B, X, F)
    gcd = (cls * 2 + iw).reshape(B, -1)  # class x direction
    jd_f = just_done.reshape(B, -1)
    cls_done = st.cls_done.reshape(B, -1).scatter_add(1, gcd.long(), jd_f.to(torch.int32))
    upd["cls_done"] = cls_done.reshape(B, NC, 2)
    has_dl = c["tx_deadline"][..., None] >= 0
    late = (complete_t - st.ift_start) > c["tx_deadline"][..., None]
    dd = (just_done & has_dl).reshape(B, -1)
    cls_f = cls.reshape(B, -1).long()
    upd["dl_done"] = st.dl_done.scatter_add(1, cls_f, dd.to(torch.int32))
    upd["dl_miss"] = st.dl_miss.scatter_add(1, cls_f, (dd & late.reshape(B, -1)).to(torch.int32))
    # P² groups: view-major (0 = accept -> complete, 1 = earliest issue -> complete)
    vals = torch.cat([lat.reshape(B, -1), e2e.reshape(B, -1)], 1)
    gid = torch.cat([gcd, gcd + 2 * NC], 1)
    mask = torch.cat([jd_f, jd_f], 1)
    h, n, pc = p2_update(st.p2_height, st.p2_npos, st.p2_count, vals, gid, mask)
    p2_max = st.p2_max.scatter_reduce(1, gid.long(), torch.where(mask, vals, 0.0), "amax")
    upd.update(p2_height=h, p2_npos=n, p2_count=pc, p2_max=p2_max)
    return _latch_drained(st.replace(**upd), c), wires


# ---------------------------------------------------------------------------
# Set-up, the cycle driver, metrics
# ---------------------------------------------------------------------------


def _base_ctx(tx_write, tx_burst, tx_prio, dyn, prm: SimParams) -> dict:
    """The stage context both pipelines share, for ``B`` lanes; every input
    carries the leading batch axis and lies on the run's device."""
    B, X, N = tx_write.shape
    P = prm.slots_per_master
    dev = tx_write.device
    prio = torch.clamp(widen(tx_prio), 0, PRIO_LEVELS - 1)  # [B, X]
    ar = torch.arange(X, dtype=torch.int32, device=dev)
    pos = torch.arange(P, dtype=torch.int32, device=dev)
    return dict(
        X=X,
        N=N,
        P=P,
        S=X * P,
        NB=prm.geom.num_banks,
        NSL=prm.geom.num_slices,
        AGE_CAP=_age_cap(prm, X),
        prm=prm,
        arbitrate=bank_arbiter_winners if prm.arbiter == "kernel" else bank_arbiter_ref,
        d={name: dyn[:, i].contiguous() for i, name in enumerate(DYN_FIELDS)},
        ar=ar,
        pos=pos,
        master_col=ar[:, None],
        flat_ids=ar[:, None] * P + pos,  # [X, P]
        slot_prio=prio[..., None],  # [B, X, 1]
        regulated=prio >= REGULATED_PRIO,
        n_events=_port_event_counts(tx_burst, N),
        tx_write=tx_write,
        tx_burst=tx_burst,
    )


def _dense_setup(tx_write, tx_burst, tx_banks, tx_hops, tx_ing, tx_start, tx_prio, dyn, prm):
    """Cycle-0 state + stage context of the dense pipeline (see ``_device_args``)."""
    ctx = _base_ctx(tx_write, tx_burst, tx_prio, dyn, prm)
    ctx.update(
        txn_ids=torch.arange(ctx["N"], dtype=torch.int32, device=tx_write.device),
        tx_banks=tx_banks,
        tx_hops=tx_hops,
        tx_ing=tx_ing,
        tx_start=tx_start,
    )
    state = init_state(
        X=ctx["X"],
        N=ctx["N"],
        P=ctx["P"],
        NB=ctx["NB"],
        NSL=ctx["NSL"],
        tx_burst=tx_burst,
        d=ctx["d"],
    )
    return state, ctx


def _sched_setup(tx_write, tx_burst, tx_addr, tx_start, tx_prio, tx_class, tx_deadline, dyn, prm):
    """Cycle-0 state + stage context of the schedule pipeline."""
    ctx = _base_ctx(tx_write, tx_burst, tx_prio, dyn, prm)
    dev = tx_write.device
    exact = prm.collect == "exact"
    desired_fracs(STREAM_PCTS, dev)  # made here, before any CUDA graph capture
    ctx.update(
        beat_off=torch.arange(prm.max_burst, dtype=torch.int32, device=dev),
        home=torch.from_numpy(master_home_slices(ctx["X"], prm.geom)).to(dev),
        banks_per_slice=prm.geom.banks_per_slice,
        exact=exact,
        NC=STREAM_CLASSES,
        tx_addr=tx_addr,
        tx_start=tx_start,
        tx_class=tx_class,
        tx_deadline=tx_deadline,
    )
    state = init_state(
        X=ctx["X"],
        N=ctx["N"],
        P=ctx["P"],
        NB=ctx["NB"],
        NSL=ctx["NSL"],
        tx_burst=tx_burst,
        d=ctx["d"],
        F=prm.inflight_slots,
        NC=0 if exact else STREAM_CLASSES,
        NQ=len(STREAM_PCTS),
        exact=exact,
    )
    return state, ctx


def _pipeline_cycle(prm: SimParams, ctx):
    """One full pipeline pass ``cycle(state) -> state``."""
    stage_fns = [STAGE_REGISTRY[name] for name in prm.pipeline()]

    def cycle(st: SimState) -> SimState:
        wires: dict = {}
        for fn in stage_fns:
            st, wires = fn(st, wires, ctx)
        return st

    return cycle


def _snapshot(st: SimState) -> SimState:
    return SimState(**{f.name: getattr(st, f.name).clone() for f in fields(SimState)})


def _assign(dst: SimState, src: SimState) -> None:
    """Copy ``src``'s fields into ``dst``'s tensors (in place)."""
    for f in fields(SimState):
        a, b = getattr(dst, f.name), getattr(src, f.name)
        if a is not b:
            a.copy_(b)


class _GraphedCycle:
    """The cycle body on CUDA: two CUDA graphs around the arbiter's launch.

    A cycle issues 300 (dense) to 1150 (streaming) small ops, so replaying
    them one by one from Python bounds the loop by the host.  Here the stages
    up to the arbitration keys are captured once as one graph and the rest of
    the cycle as a second; between the two replays the arbiter is called as
    the stage calls it, so its kernel still launches (and is counted) once
    per cycle.  The graphs read and write one fixed set of state tensors,
    ``self.state``; :meth:`__call__` copies another state into them first.
    The replays run the captured kernels on the same inputs, so results equal
    the op-by-op cycle's bit for bit."""

    def __init__(self, prm: SimParams, ctx: dict, state: SimState):
        self.arbitrate = ctx["arbitrate"]
        cycle = _pipeline_cycle(prm, ctx)
        # one op-by-op cycle on a copy first (lazy initialisation outside the
        # capture), with the plain arbiter: no kernel launch to count
        ctx["arbitrate"] = bank_arbiter_ref
        cycle(_snapshot(state))
        self.state = _snapshot(state)
        self.pre, self.post = torch.cuda.CUDAGraph(), torch.cuda.CUDAGraph()
        stream = torch.cuda.Stream(device=state.now.device)
        stream.wait_stream(torch.cuda.current_stream(state.now.device))
        torch.cuda.synchronize(state.now.device)
        ctx["arbitrate"] = self._split
        try:
            with torch.cuda.stream(stream):
                self.pre.capture_begin()
                _assign(self.state, cycle(self.state))
                self.post.capture_end()
        finally:
            ctx["arbitrate"] = self.arbitrate
        torch.cuda.current_stream(state.now.device).wait_stream(stream)

    def _split(self, key, bank, elig, *, num_banks):
        """Ends the first capture at the arbiter's call and starts the second,
        which reads the winners from ``self.win``."""
        self.args = (key, bank, elig, num_banks)
        self.pre.capture_end()
        self.win = torch.empty((key.shape[0], num_banks), dtype=torch.int32, device=key.device)
        self.post.capture_begin(pool=self.pre.pool())
        return self.win

    def __call__(self, st: SimState) -> SimState:
        if st is not self.state:
            _assign(self.state, st)
        key, bank, elig, num_banks = self.args
        self.pre.replay()
        self.win.copy_(self.arbitrate(key, bank, elig, num_banks=num_banks))
        self.post.replay()
        return self.state


def _time_skip(st: SimState, c, K: int) -> SimState:
    """Block-boundary idle-cycle skip (schedule pipeline), per lane: where a
    lane has nothing in flight and every reachable pending event's issue time
    lies strictly in the future, jump its ``now`` to the earliest of them.

    On such a lane each skipped cycle body would change only ``now`` (+1) and
    the regulator buckets (one capped refill per cycle), so both advance
    analytically; no acceptance can fire and no slot, bank or return work
    exists.  The target is clamped to ``max_cycles - K`` so the following
    block cannot overrun the horizon."""
    d = c["d"]
    MC = c["prm"].max_cycles
    phase, _ = unpack_slot_flags(st.sl_flags)
    idle = (
        (st.outstanding == 0).flatten(1).all(1)
        & (phase == SLOT_IDLE).flatten(1).all(1)
        & (st.ing_used == 0).all(1)
        & (st.ift_remaining == 0).flatten(1).all(1)
    )
    pending = st.next_txn < c["n_events"]  # [B, X]
    nt_c = torch.clamp(st.next_txn, max=c["N"] - 1)
    ns = torch.where(pending, _take(c["tx_start"], nt_c), INF32).amin(1)
    target = torch.clamp(ns, max=MC - K)
    delta = torch.where(idle & pending.any(1) & (target > st.now), target - st.now, 0)
    # analytic refill, overflow-safe: past ``need`` cycles the bucket is full
    # anyway, so clamp the multiplier before it can wrap int32
    rate = d["reg_rate"][:, None]
    cap = (d["reg_burst"] * REG_SCALE)[:, None]
    need = torch.where(rate > 0, (cap - st.reg_tokens + rate - 1) // torch.clamp(rate, min=1), 0)
    d_eff = torch.minimum(delta[:, None], torch.clamp(need, min=0))
    refill = torch.minimum(st.reg_tokens + d_eff * rate, cap)
    return st.replace(
        now=st.now + delta,
        skipped=st.skipped + delta,
        reg_tokens=torch.where(delta[:, None] > 0, refill, st.reg_tokens),
    )


def _hold(active: torch.Tensor, new: SimState, old: SimState) -> SimState:
    """Per lane: ``new`` where ``active`` ([B]), else ``old``."""
    out = {}
    for f in fields(SimState):
        a, b = getattr(new, f.name), getattr(old, f.name)
        out[f.name] = torch.where(active.reshape(-1, *([1] * (a.dim() - 1))), a, b)
    return SimState(**out)


def _run_cycles(state: SimState, cycle, ctx, prm: SimParams, *, skip: bool) -> SimState:
    """Step the cycle body for ``max_cycles`` simulated cycles.

    ``early_exit=False`` steps exactly ``max_cycles`` cycles.  With
    ``early_exit=True`` the loop steps K-cycle blocks (``block_cycles``) for
    every lane and keeps a block's result only on the lanes that were
    *active* when it began: not drained, fewer than ``max_cycles // K`` blocks
    done, and a whole block left before the horizon; the other lanes are held
    as they were.  Before its block an active lane may take the time skip
    (``skip``), which moves each lane's ``now`` by its own amount.  Reading
    the active flags is the loop's one host read per block; the loop ends when
    no lane is active.  Then a gated tail of at most K cycles steps each lane
    not yet drained up to the horizon, and a drained lane's clock is
    fast-forwarded to ``max_cycles``.  After its drain a lane's stages would
    change only ``now`` and the capped, metric-free regulator refill, so the
    metrics equal the fixed horizon's.  Every cycle body is counted in
    ``DRIVER_COUNTS``."""
    MC = prm.max_cycles
    if not prm.early_exit:
        for _ in range(MC):
            state = cycle(state)
        DRIVER_COUNTS["cycles"] += MC
        return state
    K = max(1, min(prm.block_cycles, MC))
    nblocks = MC // K
    blocks = torch.zeros_like(state.now)
    while True:
        active = (state.drained_at < 0) & (blocks < nblocks) & (state.now + K <= MC)
        flags = active.cpu()
        DRIVER_COUNTS["host_reads"] += 1
        if not bool(flags.any()):
            break
        held = None if bool(flags.all()) else _snapshot(state)
        st = _time_skip(state, ctx, K) if skip else state
        for _ in range(K):
            st = cycle(st)
        DRIVER_COUNTS["cycles"] += K
        state = st if held is None else _hold(active, st, held)
        blocks = blocks + active.to(blocks.dtype)
    # the sub-block remainder: each lane not drained steps up to the horizon
    todo = torch.where((state.drained_at < 0) & (state.now < MC), MC - state.now, 0)
    tail = min(K, int(todo.amax())) if todo.numel() else 0
    DRIVER_COUNTS["host_reads"] += 1
    for _ in range(tail):
        active = (state.drained_at < 0) & (state.now < MC)
        held = _snapshot(state)
        state = _hold(active, cycle(state), held)
    DRIVER_COUNTS["cycles"] += tail
    return state.replace(now=torch.where(state.drained_at >= 0, MC, state.now))


def _metrics(st: SimState, burst, is_w) -> Dict[str, torch.Tensor]:
    """The reference's metric surface, per lane ([B, ...])."""
    burst = widen(burst)
    is_w = widen(is_w)
    real = burst > 0
    done = st.complete_cycle >= 0
    lat = (st.complete_cycle - st.accept_cycle).to(torch.float32)
    r = real & done & (is_w == 0)
    w = real & done & (is_w == 1)
    n_r = r.sum(2, dtype=torch.int32)
    n_w = w.sum(2, dtype=torch.int32)

    # wall-span view: beats over last completion - first acceptance; the
    # busy view: beats over cycles with an incomplete transaction on the channel
    def tput(sel):
        first = torch.where(sel, st.accept_cycle, INF32).amin(2)
        last = torch.where(sel, st.complete_cycle, -1).amax(2)
        beats = torch.where(sel, burst, 0).sum(2, dtype=torch.int32)
        span = torch.clamp(last - first, min=1).to(torch.float32)
        return torch.where(sel.sum(2) > 0, beats / span, 0.0)

    def tput_busy(sel, busy):
        beats = torch.where(sel, burst, 0).sum(2, dtype=torch.int32)
        cyc = torch.clamp(busy, min=1).to(torch.float32)
        return torch.where(sel.sum(2) > 0, beats / cyc, 0.0)

    granted_beats = st.slice_beats.sum(1, dtype=torch.int32)
    return {
        "throughput": tput(real & done),
        "read_throughput": tput(r),
        "write_throughput": tput(w),
        "throughput_busy": tput_busy(real & done, st.busy_any),
        "read_throughput_busy": tput_busy(r, st.busy_r),
        "write_throughput_busy": tput_busy(w, st.busy_w),
        "busy_cycles": st.busy_any,
        "read_lat_avg": torch.where(
            n_r > 0, torch.where(r, lat, 0.0).sum(2) / torch.clamp(n_r, min=1), 0.0
        ),
        "read_lat_max": torch.where(r, lat, 0.0).amax(2),
        "write_lat_avg": torch.where(
            n_w > 0, torch.where(w, lat, 0.0).sum(2) / torch.clamp(n_w, min=1), 0.0
        ),
        "write_lat_max": torch.where(w, lat, 0.0).amax(2),
        "all_done": torch.where(real, done, True).flatten(1).all(1),
        "txns_done_port": torch.stack([n_r, n_w], dim=2),
        "beats_done": st.beats_done,
        "cycles": st.now,
        "drained_cycle": st.drained_at,
        "effective_cycles": torch.where(st.drained_at >= 0, st.drained_at, st.now),
        "skipped_cycles": st.skipped,
        "complete_cycle": st.complete_cycle,
        "accept_cycle": st.accept_cycle,
        "slice_beats": st.slice_beats,
        "remote_beats": st.remote_beats,
        "remote_beat_fraction": torch.where(
            granted_beats > 0,
            st.remote_beats / torch.clamp(granted_beats, min=1).to(torch.float32),
            0.0,
        ),
    }


def _stream_metrics(st: SimState, burst) -> Dict[str, torch.Tensor]:
    """Metrics of a ``collect="stream"`` run, per lane: the port-level surface
    of :func:`_metrics` without the per-transaction timestamp arrays, plus the
    raw P²/class/deadline accumulator state (summarized on the host by
    ``scenarios.sweep``, merged across lanes by ``p2_merge_quantile``)."""
    n_real = (widen(burst) > 0).flatten(1).sum(1, dtype=torch.int32)
    first = torch.cat([st.pt_first, st.pt_first.amin(2, keepdim=True)], 2)
    last = torch.cat([st.pt_last, st.pt_last.amax(2, keepdim=True)], 2)
    beats = torch.cat([st.pt_beats, st.pt_beats.sum(2, keepdim=True, dtype=torch.int32)], 2)
    count = torch.cat([st.pt_count, st.pt_count.sum(2, keepdim=True, dtype=torch.int32)], 2)
    span = torch.clamp(last - first, min=1).to(torch.float32)
    tput = torch.where(count > 0, beats / span, 0.0)  # [B, X, (r, w, any)]
    busy = torch.stack([st.busy_r, st.busy_w, st.busy_any], dim=2)
    tput_busy = torch.where(count > 0, beats / torch.clamp(busy, min=1).to(torch.float32), 0.0)
    cnt = st.pt_count.to(torch.float32)
    granted_beats = st.slice_beats.sum(1, dtype=torch.int32)

    def lat_avg(i):
        mean = st.pt_lat_sum[..., i] / torch.clamp(cnt[..., i], min=1.0)
        return torch.where(cnt[..., i] > 0, mean, 0.0)

    return {
        "throughput": tput[..., 2],
        "read_throughput": tput[..., 0],
        "write_throughput": tput[..., 1],
        "throughput_busy": tput_busy[..., 2],
        "read_throughput_busy": tput_busy[..., 0],
        "write_throughput_busy": tput_busy[..., 1],
        "busy_cycles": st.busy_any,
        "read_lat_avg": lat_avg(0),
        "read_lat_max": st.pt_lat_max[..., 0],
        "write_lat_avg": lat_avg(1),
        "write_lat_max": st.pt_lat_max[..., 1],
        "all_done": st.pt_count.flatten(1).sum(1, dtype=torch.int32) == n_real,
        "beats_done": st.beats_done,
        "cycles": st.now,
        "drained_cycle": st.drained_at,
        "effective_cycles": torch.where(st.drained_at >= 0, st.drained_at, st.now),
        "skipped_cycles": st.skipped,
        "slice_beats": st.slice_beats,
        "remote_beats": st.remote_beats,
        "remote_beat_fraction": torch.where(
            granted_beats > 0,
            st.remote_beats / torch.clamp(granted_beats, min=1).to(torch.float32),
            0.0,
        ),
        # streaming accumulator state (fixed-size; see core/percentile.py)
        "p2_height": st.p2_height,
        "p2_npos": st.p2_npos,
        "p2_count": st.p2_count,
        "p2_max": st.p2_max,
        "cls_done": st.cls_done,
        "dl_done": st.dl_done,
        "dl_miss": st.dl_miss,
        "txns_done_port": st.pt_count,
    }


def _resolve_device(device=None) -> torch.device:
    """``None`` means the CUDA device; there is no silent CPU fallback."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "the simulator runs on the CUDA device by default and this machine has none; "
                "pass device='cpu' to run the plain PyTorch path on the host"
            )
        return torch.device("cuda")
    return torch.device(device)


def _run(args: tuple, prm: SimParams, use_sched: bool) -> Dict[str, torch.Tensor]:
    """Set up, drive and measure one batch of device inputs (``_device_args``
    order, leading axis B) under the static envelope ``prm``."""
    setup = _sched_setup if use_sched else _dense_setup
    state, ctx = setup(*args, prm)
    if state.now.is_cuda:
        cycle = _GraphedCycle(prm, ctx, state)
    else:
        cycle = _pipeline_cycle(prm, ctx)
    state = _run_cycles(state, cycle, ctx, prm, skip=use_sched and prm.time_skip)
    if use_sched and prm.collect == "stream":
        return _stream_metrics(state, ctx["tx_burst"])
    return _metrics(state, ctx["tx_burst"], ctx["tx_write"])


def _numpy(out: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    return {k: v.cpu().numpy() for k, v in out.items()}


def _prepare(trace, prm: SimParams, device) -> tuple:
    use_sched = prm.uses_schedule()
    host = [a[None] for a in _host_args(_as_input(trace, use_sched), prm, use_sched)]
    return _device_args(prm, host, prm.dyn_vector()[None], device, use_sched), use_sched


def simulate(trace, prm: SimParams = SimParams(), device=None) -> Dict[str, np.ndarray]:
    """Run the simulator on ``device`` (default: CUDA); returns per-port and
    per-transaction statistics as numpy arrays in the reference's dtypes.

    Takes a dense :class:`Trace` or a packed ``EventSchedule``; ``prm.stages``
    picks the pipeline and the input is converted to match."""
    dev = _resolve_device(device)
    args, use_sched = _prepare(trace, prm, dev)
    return {k: v[0] for k, v in _numpy(_run(args, prm, use_sched)).items()}


def compile_simulate(trace, prm: SimParams, device=None):
    """Prepare :func:`simulate` for this (trace, prm) on ``device``: returns
    a zero-argument runner that holds the prepared device inputs and gives
    the same metrics dict, so a timed call leaves out the host's preparation."""
    dev = _resolve_device(device)
    args, use_sched = _prepare(trace, prm, dev)

    def run() -> Dict[str, np.ndarray]:
        return {k: v[0] for k, v in _numpy(_run(args, prm, use_sched)).items()}

    return run


def batch_envelope(prms: Sequence[SimParams]) -> SimParams:
    """The static envelope a batch shares: every point must agree on the
    program-shaping fields; the beat-slot ring (and, on the schedule
    pipeline, the in-flight table) is sized for the largest point."""
    if not prms:
        raise ValueError("empty parameter batch")
    key = prms[0].static_key()
    for p in prms[1:]:
        if p.static_key() != key:
            raise ValueError(
                "batched points must share geom/expand_rate/max_burst/banking/max_cycles/"
                "stages/arbiter/collect/early_exit/block_cycles/time_skip; "
                f"got {p.static_key()} vs {key}"
            )
    return dataclasses_replace(
        prms[0],
        slots_override=max(p.slots_per_master for p in prms),
        inflight_override=max(p.inflight_slots for p in prms),
    )


def _pad_batch(arrs: list, pad: int) -> list:
    """Repeat each stacked array's last row ``pad`` times: inert padding
    lanes whose outputs are sliced off before the caller sees them."""
    if pad == 0:
        return arrs
    return [np.concatenate([a, np.repeat(a[-1:], pad, axis=0)]) for a in arrs]


def _group() -> Optional[Tuple[int, int]]:
    """``(world size, rank)`` of the default process group, or None."""
    if not (torch.distributed.is_available() and torch.distributed.is_initialized()):
        return None
    return torch.distributed.get_world_size(), torch.distributed.get_rank()


def batch_sharding(batch_size: int, device=None):
    """``distributed.sharding.NamedSharding`` that splits the batch axis
    across the ranks of the default process group (a 1-D mesh ``("batch",)``
    of ``device``'s type, default CUDA), or ``None`` when sharding cannot
    help (no group, one rank, or a batch the world does not divide): the
    reference's ``batch_sharding``, ranks in place of devices."""
    from torch.distributed.device_mesh import DeviceMesh

    from repro_torch.distributed.sharding import NamedSharding

    group = _group()
    if group is None or group[0] <= 1 or batch_size % group[0] != 0:
        return None
    mesh = DeviceMesh(
        _resolve_device(device).type, torch.arange(group[0]), mesh_dim_names=("batch",)
    )
    return NamedSharding(mesh, ("batch",))


def _run_lanes(env, lanes: list, C: int, shared, dev, use_sched) -> Dict[str, np.ndarray]:
    """Run the lanes (host arrays with a leading lane axis; ``shared``: the
    shared trace's host arrays, the lanes then hold only the dyn vectors)
    ``C`` at a time on ``dev``; the last chunk is padded by repeating the
    last lane, and the result sliced back."""
    n = len(lanes[0])
    n_chunks = -(-n // C)
    lanes = _pad_batch(lanes, n_chunks * C - n)
    if shared is not None:
        trace_dev = _device_args(env, shared, lanes[0][:1], dev, use_sched)[:-1]
        trace_dev = tuple(a.expand(C, *a.shape[1:]) for a in trace_dev)
    outs = []
    for k in range(n_chunks):
        part = [a[k * C : (k + 1) * C] for a in lanes]
        if shared is not None:
            args = (*trace_dev, torch.from_numpy(part[0]).to(dev))
        else:
            args = _device_args(env, part[:-1], part[-1], dev, use_sched)
        outs.append(_numpy(_run(args, env, use_sched)))
    return {k: np.concatenate([o[k] for o in outs])[:n] for k in outs[0]}


def _gather_lanes(out: Dict[str, np.ndarray], world: int) -> Dict[str, np.ndarray]:
    """Every rank's lanes (equal counts), concatenated in rank order on every
    rank: one ``all_gather`` a metric (bool sent as uint8), on the card
    under NCCL, on the host under gloo."""
    dist = torch.distributed
    on = torch.device("cuda", torch.cuda.current_device()) if dist.get_backend() == "nccl" else None
    gathered = {}
    for k in sorted(out):
        v = out[k]
        t = torch.from_numpy(np.ascontiguousarray(v.view(np.uint8) if v.dtype == bool else v))
        t = t.to(on) if on is not None else t
        parts = [torch.empty_like(t) for _ in range(world)]
        dist.all_gather(parts, t)
        full = torch.cat(parts).cpu().numpy()
        gathered[k] = full.view(bool) if v.dtype == bool else full
    return gathered


def simulate_batch(
    traces,
    prms: Sequence[SimParams],
    *,
    shard: bool = True,
    chunk: Optional[int] = None,
    device=None,
) -> Dict[str, np.ndarray]:
    """Run B (trace, params) points as lanes of one batch on ``device``
    (default: CUDA): one cycle loop steps every lane, and each cycle launches
    the arbiter kernel once for all of them.

    The traces must share one [X, N] shape (``core.traffic.stack_traces``)
    and the params one static envelope (:func:`batch_envelope`).  Returns
    the metrics of :func:`simulate` with a leading batch axis; row ``i``
    equals ``simulate(traces[i], replace(prms[i], slots_override=...,
    inflight_override=...))`` at the envelope's sizes, bit for bit.

    * Shared trace: one trace with B > 1 points enters once, as ``[1, ...]``
      tensors expanded to the batch (no B copies).
    * ``chunk=C`` runs the batch C lanes at a time, one after the other, so
      peak memory is one chunk's; the last chunk is padded by repeating the
      last point, and the result is sliced back to B.
    * ``shard`` (default): with ``torch.distributed``'s default process
      group initialised, every rank calls with the same points and runs its
      share of the lanes on its own device (``device``: on the card the
      rank's current CUDA device): the batch is padded up to a multiple of
      the world size by repeating the last point, rank ``r`` runs the
      ``r``-th block of lanes (chunked runs ``ceil(C / world)`` lanes at a
      time, so each chunk of C is shared by the ranks), and the lanes come
      back to every rank in order, sliced to B (the reference's sharded
      batch, ranks in place of devices).  With no group one device changes
      nothing, as in the reference; with several visible CUDA devices and
      no group it raises rather than use one card silently."""
    if not prms:
        raise ValueError("empty parameter batch")
    dev = _resolve_device(device)
    B = len(prms)
    shared = len(traces) == 1 and B > 1
    if not shared and len(traces) != B:
        raise ValueError(
            f"{len(traces)} traces vs {B} param points "
            "(pass one trace to share it across all points)"
        )
    group = _group() if shard else None
    if shard and group is None and dev.type == "cuda" and torch.cuda.device_count() > 1:
        raise NotImplementedError(
            "simulate_batch(shard=True) with several visible CUDA devices and no process group: "
            "the multi-device layer splits the lanes across the ranks of torch.distributed's "
            "default group (one rank a card); initialise it, or pass shard=False"
        )
    env = batch_envelope(prms)
    use_sched = env.uses_schedule()
    traces = [_as_input(t, use_sched) for t in traces]
    shape = traces[0].is_write.shape
    for t in traces[1:]:
        if t.is_write.shape != shape:
            raise ValueError(
                f"all traces in a batch must share [X, N]; got {t.is_write.shape} vs {shape}"
            )
    dyn = np.stack([p.dyn_vector() for p in prms])
    if shared:
        host = [a[None] for a in _host_args(traces[0], env, use_sched)]
    else:
        per = [_host_args(t, p, use_sched) for t, p in zip(traces, prms)]
        host = [np.stack([h[i] for h in per]) for i in range(len(per[0]))]
    lanes = [dyn] if shared else host + [dyn]
    C = chunk if chunk is not None and 0 < chunk < B else B
    common = dict(shared=host if shared else None, dev=dev, use_sched=use_sched)
    if group is None:
        return _run_lanes(env, lanes, C, **common)
    world, rank = group
    n = -(-B // world)
    lanes = _pad_batch(lanes, n * world - B)
    mine = [a[rank * n : (rank + 1) * n] for a in lanes]
    out = _run_lanes(env, mine, min(n, -(-C // world)), **common)
    return {k: v[:B] for k, v in _gather_lanes(out, world).items()}


# ---------------------------------------------------------------------------
# Footprint accounting
# ---------------------------------------------------------------------------


def carry_nbytes(prm: SimParams, num_masters: int, num_txns: int) -> int:
    """Bytes of ONE lane's loop carry (:class:`SimState`): what a batch or a
    chunk multiplies.  Shapes only, built on the meta device."""
    p = dataclasses_replace(
        prm, slots_override=prm.slots_per_master, inflight_override=prm.inflight_slots
    )
    use_sched = p.uses_schedule()
    exact = p.collect == "exact"
    meta = torch.device("meta")
    d = {f: torch.zeros(1, dtype=torch.int32, device=meta) for f in DYN_FIELDS}
    st = init_state(
        X=num_masters,
        N=num_txns,
        P=p.slots_per_master,
        NB=p.geom.num_banks,
        NSL=p.geom.num_slices,
        tx_burst=torch.zeros((1, num_masters, num_txns), dtype=torch.int8, device=meta),
        d=d,
        F=p.inflight_slots if use_sched else 0,
        NC=0 if exact else STREAM_CLASSES,
        NQ=len(STREAM_PCTS),
        exact=exact,
    )
    return sum(getattr(st, f.name).numel() * getattr(st, f.name).element_size() for f in fields(st))


def input_nbytes(trace, prm: SimParams) -> int:
    """Bytes of ONE point's prepared simulator inputs.  The dense path's
    precomputed [X, N, max_burst] beat tables dominate it; the schedule path
    carries only the packed event arrays."""
    use_sched = prm.uses_schedule()
    host = _host_args(_as_input(trace, use_sched), prm, use_sched)
    return int(sum(np.asarray(a).nbytes for a in host) + prm.dyn_vector().nbytes)
