"""Cycle-level simulator of the many-ported banked shared memory (§II-C/§III).

The PyTorch port of the reference package's dense pipeline.  A
:class:`Trace` goes into :func:`simulate`, which runs the cycle stages

  ``accept_dispatch``  acceptance (credits, regulator, router admission) and
                       split-by-4 dispatch into the per-port beat-slot ring
  ``bank_arbitrate``   per-bank QoS arbitration, one grant per bank per cycle
                       (the bank-arbiter kernel)
  ``router_release``   inter-slice ingress-credit release + per-slice counts
  ``return_bus``       read-return bus, one beat per port per cycle
  ``retire``           transaction completion + busy-cycle accounting

once per simulated cycle and returns the reference package's metrics, with
its dtypes, as numpy arrays.  The model is the reference's, decision for
decision: X master ports with 256-bit buses, two-level split-by-4 dispatch,
priority-first / FCFS / round-robin bank arbitration with anti-starvation
aging, an optional best-effort token-bucket regulator, SRAMs at half the
fabric clock, per-port credits, and a multi-slice ring router with per-hop
latency and per-slice ingress credits.

Every :class:`SimState` field carries a leading batch axis ``B`` (one lane per
simulated point; :func:`simulate` runs ``B = 1``).  Stages are registered by
name (:func:`register_stage`) with the signature
``stage(state, wires, ctx) -> (state, wires)``: ``wires`` carries the values
stages hand each other within a cycle, ``ctx`` the run's constant tensors and
the ``[B]`` dyn-parameter tensors.  Inside a stage nothing reads a tensor back
to the host.  The cycle driver (:func:`_run_cycles`) is a Python loop; with
``early_exit`` it reads one flag back per ``block_cycles`` cycles and stops once
every lane has drained.

The entry point runs on the CUDA device unless the caller names another
(the tests pass ``device="cpu"``).  On CUDA the arbitration stage launches the
hand-written Hopper kernel; ``SimParams(arbiter="ref")`` selects the plain
PyTorch version instead, which is what a run compares the kernel with.

Comparator topologies (§II-A): ``banking='paper'`` (the proposed structure),
``'linear'`` (monolithic region-per-bank banking) and ``'no_fractal'``
(round-robin clusters without the second-level hash).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.address import (
    MemoryGeometry,
    flat_bank_id,
    master_home_slices,
    slice_of_bank,
    slice_of_beat,
)
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

#: per-bank comparator backends: the Hopper kernel (CPU tensors take its plain
#: version) or, explicitly, the plain PyTorch version on any device
ARBITERS = ("kernel", "ref")

DEFAULT_PIPELINE = ("accept_dispatch", "bank_arbitrate", "router_release", "return_bus", "retire")
#: the reference's event-schedule pipeline; its stages are not ported yet
SCHEDULE_PIPELINE = (
    "accept_dispatch_sched",
    "bank_arbitrate",
    "router_release",
    "return_bus",
    "retire_sched",
)
_SCHEDULE_STAGES = ("accept_sched", "dispatch_sched", "accept_dispatch_sched", "retire_sched")


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
    collect: str = "exact"  # exact | stream (stream is not ported yet)
    inflight_override: Optional[int] = None  # schedule pipeline only
    early_exit: bool = True  # stop stepping once every lane has drained
    block_cycles: int = 32  # K: cycles between two drain checks
    time_skip: bool = True  # schedule pipeline only

    @property
    def slots_per_master(self) -> int:
        # enough ring slots for every accepted command's beats
        if self.slots_override is not None:
            return int(self.slots_override)
        return int(
            2 ** np.ceil(np.log2(max(self.outstanding * self.max_burst, self.split_buffer) * 2))
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
        sched = [n for n in names if n in _SCHEDULE_STAGES]
        if sched:
            raise NotImplementedError(
                f"the event-schedule pipeline (stages {sched}) is not ported yet: "
                "ROADMAP.md Queue 1 item 7"
            )
        if self.collect == "stream":
            raise NotImplementedError(
                "collect='stream' (streaming percentiles) is not ported yet: "
                "ROADMAP.md Queue 1 item 8"
            )
        if self.collect != "exact":
            raise ValueError(f"collect must be 'exact' or 'stream'; got {self.collect!r}")
        unknown = [n for n in names if n not in STAGE_REGISTRY]
        if unknown:
            raise ValueError(
                f"unknown stage(s) {unknown}; registered stages: {sorted(STAGE_REGISTRY)}"
            )
        if self.arbiter not in ARBITERS:
            raise ValueError(f"unknown arbiter {self.arbiter!r}; pick from {ARBITERS}")
        if self.block_cycles < 1:
            raise ValueError(f"block_cycles must be >= 1; got {self.block_cycles}")
        return names


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


def _host_args(trace: Trace, prm: SimParams) -> tuple:
    """One point's host-side inputs: (is_write, burst, banks, hops, ingress,
    start, prio), all int32 numpy arrays."""
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


def _device_args(prm: SimParams, host: tuple, dyn: np.ndarray, device) -> tuple:
    """Batched host arrays (leading axis B) -> narrow device tensors:
    write/burst/hops/prio int8, ingress int16, banks the narrowest dtype that
    indexes the fabric's banks, start and dyn int32."""
    i8, banks = torch.int8, bank_dtype(prm.geom.num_banks)
    dtypes = (i8, i8, banks, i8, torch.int16, torch.int32, i8, torch.int32)
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


@register_stage("accept")
def _stage_accept(st: SimState, wires, c):
    """Command acceptance, one per port per cycle: outstanding credits,
    split-buffer credits, W-data-bus pacing, the best-effort token-bucket
    regulator and the inter-slice router's admission gate.  A burst larger
    than the bucket or the ingress cap is admitted alone and drives the
    counter into debt (delayed, never deadlocked); ports are admitted in
    index order within the cycle, each counting the needs of the
    lower-indexed candidates."""
    N = c["N"]
    d = c["d"]
    now = st.now[:, None]  # [B, 1]
    nt = st.next_txn
    has_txn = nt < N
    nt_c = torch.clamp(nt, max=N - 1)
    burst = widen(_take(c["tx_burst"], nt_c))
    is_w = widen(_take(c["tx_write"], nt_c))
    ready = _take(c["tx_start"], nt_c) <= now
    dirn = is_w.long()[..., None]  # 0 = read, 1 = write
    reg_gate = c["regulated"] & (d["reg_rate"] > 0)[:, None]
    reg_cap = (d["reg_burst"] * REG_SCALE)[:, None]
    reg_tokens = torch.minimum(st.reg_tokens + d["reg_rate"][:, None], reg_cap)
    reg_need = torch.minimum(burst, d["reg_burst"][:, None]) * REG_SCALE
    need = widen(_take(c["tx_ing"], nt_c))  # [B, X, NSL]
    pre_can = (
        has_txn
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
    reg_tokens = reg_tokens - torch.where(can & reg_gate, burst * REG_SCALE, 0)
    ing_used = st.ing_used + torch.where(can[..., None], need, 0).sum(1, dtype=torch.int32)
    accept = torch.where(
        can[..., None] & (c["txn_ids"] == nt_c[..., None]), now[..., None], st.accept_cycle
    )
    outstanding = widen(st.outstanding).scatter_add(2, dirn, can_i[..., None])
    credits = widen(st.credits).scatter_add(2, dirn, -torch.where(can, burst, 0)[..., None])
    st = st.replace(
        next_txn=nt + can_i,
        outstanding=outstanding.to(st.outstanding.dtype),
        credits=credits.to(st.credits.dtype),
        fwd_free=torch.where(can & (is_w > 0), now + burst, st.fwd_free),
        reg_tokens=reg_tokens,
        ing_used=ing_used,
        accept_cycle=accept,
    )
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
    arbiter = bank_arbiter_winners if prm.arbiter == "kernel" else bank_arbiter_ref
    win = arbiter(key.reshape(B, S), st.sl_bank.reshape(B, S), elig.reshape(B, S), num_banks=NB)
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
    idle, all ingress credits returned and no undelivered beat.  Called on
    the post-retire state, so the latched value counts the cycles after which
    nothing but ``now`` and the capped regulator refill can change."""
    phase, _ = unpack_slot_flags(st.sl_flags)
    drained = (
        (st.next_txn >= c["n_events"]).all(1)
        & (st.outstanding == 0).flatten(1).all(1)
        & (phase == SLOT_IDLE).flatten(1).all(1)
        & (st.ing_used == 0).all(1)
        & (st.remaining <= 0).flatten(1).all(1)
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


# ---------------------------------------------------------------------------
# Set-up, the cycle driver, metrics
# ---------------------------------------------------------------------------


def _dense_setup(tx_write, tx_burst, tx_banks, tx_hops, tx_ing, tx_start, tx_prio, dyn, prm):
    """Cycle-0 state + stage context for ``B`` lanes; every input carries the
    leading batch axis and lies on the run's device (see ``_device_args``)."""
    B, X, N = tx_write.shape
    P = prm.slots_per_master
    dev = tx_write.device
    d = {name: dyn[:, i].contiguous() for i, name in enumerate(DYN_FIELDS)}
    prio = torch.clamp(widen(tx_prio), 0, PRIO_LEVELS - 1)  # [B, X]
    ar = torch.arange(X, dtype=torch.int32, device=dev)
    pos = torch.arange(P, dtype=torch.int32, device=dev)
    ctx = dict(
        X=X,
        N=N,
        P=P,
        S=X * P,
        NB=prm.geom.num_banks,
        NSL=prm.geom.num_slices,
        AGE_CAP=_age_cap(prm, X),
        prm=prm,
        d=d,
        ar=ar,
        pos=pos,
        txn_ids=torch.arange(N, dtype=torch.int32, device=dev),
        master_col=ar[:, None],
        flat_ids=ar[:, None] * P + pos,  # [X, P]
        slot_prio=prio[..., None],  # [B, X, 1]
        regulated=prio >= REGULATED_PRIO,
        n_events=_port_event_counts(tx_burst, N),
        tx_write=tx_write,
        tx_burst=tx_burst,
        tx_banks=tx_banks,
        tx_hops=tx_hops,
        tx_ing=tx_ing,
        tx_start=tx_start,
    )
    state = init_state(X=X, N=N, P=P, NB=ctx["NB"], NSL=ctx["NSL"], tx_burst=tx_burst, d=d)
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


def _run_cycles(state: SimState, cycle, prm: SimParams) -> SimState:
    """Step the cycle body for ``max_cycles`` simulated cycles.

    ``early_exit=False`` steps exactly ``max_cycles`` cycles.  With
    ``early_exit=True`` the loop reads ``drained_at >= 0`` back to the host
    once per ``block_cycles`` cycles (the only host sync in the loop) and
    stops once every lane has drained; a drained lane's clock is then
    fast-forwarded to ``max_cycles``.  After its drain a lane's stages change
    only ``now`` and the capped, metric-free regulator refill, so the metrics
    equal the fixed horizon's."""
    MC = prm.max_cycles
    if not prm.early_exit:
        for _ in range(MC):
            state = cycle(state)
        return state
    K = max(1, min(prm.block_cycles, MC))
    stepped = 0
    while stepped < MC:
        for _ in range(min(K, MC - stepped)):
            state = cycle(state)
        stepped += min(K, MC - stepped)
        if bool((state.drained_at >= 0).all()):
            break
    return state.replace(now=torch.where(state.drained_at >= 0, MC, state.now))


def stepped_cycles(drained_cycle, prm: SimParams) -> int:
    """Cycles :func:`_run_cycles` steps for a run whose lanes drained at
    ``drained_cycle`` (the metric; -1 where a lane never drained)."""
    MC = prm.max_cycles
    drained = np.asarray(drained_cycle).reshape(-1)
    if not prm.early_exit or MC == 0 or (drained < 0).any():
        return MC
    K = max(1, min(prm.block_cycles, MC))
    return int(min(MC, -(-int(drained.max()) // K) * K))


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


def _resolve_device(device=None) -> torch.device:
    """``None`` means the CUDA device; there is no silent CPU fallback."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "simulate() runs on the CUDA device by default and this machine has none; "
                "pass device='cpu' to run the plain PyTorch path on the host"
            )
        return torch.device("cuda")
    return torch.device(device)


def simulate(trace: Trace, prm: SimParams = SimParams(), device=None) -> Dict[str, np.ndarray]:
    """Run the simulator on ``device`` (default: CUDA); returns per-port and
    per-transaction statistics as numpy arrays in the reference's dtypes."""
    dev = _resolve_device(device)
    prm.pipeline()
    host = [a[None] for a in _host_args(trace, prm)]
    args = _device_args(prm, host, prm.dyn_vector()[None], dev)
    state, ctx = _dense_setup(*args, prm)
    state = _run_cycles(state, _pipeline_cycle(prm, ctx), prm)
    out = _metrics(state, ctx["tx_burst"], ctx["tx_write"])
    return {k: v[0].cpu().numpy() for k, v in out.items()}
