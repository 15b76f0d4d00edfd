"""Declarative scenario spec → simulator ``Trace`` compiler (the port's copy).

A :class:`Scenario` is a list of :class:`MasterSpec`s — traffic source, QoS
class, memory-region placement, injection rate — plus a shared geometry.
``Scenario.compile()`` resolves region placement (explicit beat ranges or an
automatic equal partition of the address space), invokes each master's
:class:`TrafficSource`, and pads the rows into one beat-aligned ``Trace``
whose ``start`` column carries the injection timing.  The resulting
:class:`CompiledScenario` runs itself: ``.simulate(params)`` for one point,
``.simulate_batch(params_seq)`` for a parameter grid as lanes of one batch,
on the CUDA device unless the caller passes ``device="cpu"``.

Every workload reaches the simulator through the same interface::

    TrafficSource.emit(lo, hi, ...) → Scenario.compile() → .simulate(params)

A ``TrafficSource`` is anything with an ``emit`` method returning one
master's ``(is_write, burst, addr, start)`` rows: the synthetic ADAS
generators (wrapped by :class:`SyntheticSource`; a plain string model name in
``MasterSpec.model`` still works and resolves to one), and recorded
LLM-serving streams (``scenarios.serving.ServingSource``).  Sources
that replay a recorded stream may ignore the synthetic knobs (``txns``,
``rate``, ``seed``) — their stream is already fully determined.

``compile_scenario(sc)`` remains as a thin deprecated alias for
``sc.compile()``.

The QoS classes mirror the paper's §II-C contract:

* ``safety``    — ASIL-rated consumers (braking-path Radar/camera): must see
                  bounded latency regardless of other masters.
* ``realtime``  — frame-deadline consumers (viewing cameras, AI accelerator).
* ``besteffort``— CPU housekeeping and diagnostics.
"""
from __future__ import annotations

import warnings
from dataclasses import dataclass, field
from typing import (TYPE_CHECKING, Dict, List, Optional, Protocol, Sequence,
                    Tuple, Union, runtime_checkable)

import numpy as np

from repro_torch.core.address import MemoryGeometry, master_home_slices
from repro_torch.core.simulator import PRIO_LEVELS, SimParams, Trace
from repro_torch.core.traffic import pad_rows
from repro_torch.scenarios.generators import GENERATORS

if TYPE_CHECKING:
    from repro_torch.core.traffic import EventSchedule
    from repro_torch.scenarios.sweep import SweepResult

QOS_CLASSES = ("safety", "realtime", "besteffort")


@runtime_checkable
class TrafficSource(Protocol):
    """One master port's traffic emitter — the unified workload interface.

    ``emit`` returns the port's transaction stream as four parallel 1-D int32
    arrays ``(is_write, burst, addr, start)`` with every burst inside
    ``[lo, hi)``.  ``txns``/``rate``/``seed``/``params`` are the synthetic
    knobs from the owning :class:`MasterSpec`; replay-style sources (recorded
    serving streams) may ignore them.
    """

    def emit(self, lo: int, hi: int, *, txns: int, rate: float, seed: int,
             params: Dict) -> Tuple[np.ndarray, ...]:
        ...


@dataclass(frozen=True)
class SyntheticSource:
    """Adapter presenting a named synthetic generator as a TrafficSource."""
    model: str

    def emit(self, lo: int, hi: int, *, txns: int, rate: float, seed: int,
             params: Dict) -> Tuple[np.ndarray, ...]:
        return GENERATORS[self.model](lo, hi, txns=txns, rate=rate,
                                      seed=seed, params=params)

#: arbitration priority level per QoS class (0 = most critical; masters at
#: level >= REGULATED_PRIO are subject to the token-bucket regulator)
QOS_PRIORITY = {"safety": 0, "realtime": 1, "besteffort": 2}

#: smallest region (beats) the traffic models can lay out sensibly: double
#: buffers, weight/output sub-regions, and ring buffers all need headroom
MIN_REGION_BEATS = 256


@dataclass
class MasterSpec:
    """One master port's workload."""
    model: Union[str, TrafficSource]  # GENERATORS key or a source
    qos: str = "besteffort"  # one of QOS_CLASSES
    rate: float = 1.0  # injection cap, beats/cycle
    txns: int = 256  # transactions to generate
    region: Optional[Tuple[int, int]] = None  # [lo, hi) beats; None = auto
    seed: int = 0
    params: Dict = field(default_factory=dict)
    priority: Optional[int] = None  # arbiter level; None = from qos
    deadline: Optional[int] = None  # per-txn completion bound
                                              # (cycles past its start time)
    slice_affinity: Optional[int] = None  # auto-place the region inside
                                              # this slice's span (requires
                                              # geom.slice_policy="region"
                                              # on a multi-slice fabric)
    share_group: Optional[str] = None  # masters naming the same group
                                              # may declare overlapping
                                              # regions (e.g. serving ports
                                              # sharing one KV pool); the
                                              # isolation report treats the
                                              # group as one logical master

    def source(self) -> TrafficSource:
        """The TrafficSource this spec resolves to (strings → synthetic)."""
        if isinstance(self.model, str):
            return SyntheticSource(self.model)
        return self.model

    def effective_priority(self) -> int:
        """Arbitration level this master presents to the simulator."""
        if self.priority is not None:
            return int(self.priority)
        return QOS_PRIORITY[self.qos]

    def validate(self) -> None:
        if isinstance(self.model, str):
            if self.model not in GENERATORS:
                raise ValueError(f"unknown traffic model {self.model!r}; "
                                 f"have {sorted(GENERATORS)} (or pass a "
                                 "TrafficSource instance)")
        elif not isinstance(self.model, TrafficSource):
            raise ValueError(
                f"model must be a GENERATORS key or a TrafficSource (needs "
                f"an emit method); got {type(self.model).__name__}")
        if self.qos not in QOS_CLASSES:
            raise ValueError(f"unknown QoS class {self.qos!r}; "
                             f"have {QOS_CLASSES}")
        if not 0.0 < self.rate <= 1.0:
            raise ValueError(f"rate must be in (0, 1]; got {self.rate}")
        if self.txns <= 0:
            raise ValueError("txns must be positive")
        if self.priority is not None and \
                not 0 <= self.priority < PRIO_LEVELS:
            raise ValueError(f"priority must be in [0, {PRIO_LEVELS}); "
                             f"got {self.priority}")
        if self.deadline is not None and self.deadline <= 0:
            raise ValueError(f"deadline must be positive; got {self.deadline}")
        if self.region is not None:
            lo, hi = self.region
            if lo < 0 or hi - lo < MIN_REGION_BEATS:
                raise ValueError(
                    f"region {self.region} must be >= {MIN_REGION_BEATS} "
                    "beats wide and non-negative")


@dataclass
class Scenario:
    """A full machine workload: one MasterSpec per port."""
    name: str
    masters: Sequence[MasterSpec]
    geom: MemoryGeometry = MemoryGeometry()
    description: str = ""

    def validate(self) -> None:
        if not self.masters:
            raise ValueError(f"scenario {self.name!r} has no masters")
        claimed = []
        for i, m in enumerate(self.masters):
            m.validate()
            if m.slice_affinity is not None:
                if not 0 <= m.slice_affinity < self.geom.num_slices:
                    raise ValueError(
                        f"master {i} slice_affinity {m.slice_affinity} out "
                        f"of range for a {self.geom.num_slices}-slice fabric")
                if self.geom.num_slices > 1 and \
                        self.geom.slice_policy != "region":
                    raise ValueError(
                        f"master {i} sets slice_affinity but "
                        f"slice_policy={self.geom.slice_policy!r} interleaves "
                        "addresses across slices — slice-affine placement "
                        "needs slice_policy='region'")
            if m.region is None:
                continue
            _check_region_bounds(i, m.region, self.geom)
            for j, other in claimed:
                shared = (m.share_group is not None
                          and self.masters[j].share_group == m.share_group)
                if shared:
                    continue  # same share group: overlap is the point
                if m.region[0] < other[1] and other[0] < m.region[1]:
                    raise ValueError(
                        f"masters {j} and {i} claim overlapping regions "
                        f"{other} and {m.region} — the DSL's isolation "
                        "contract requires disjoint placement (masters may "
                        "opt into sharing via a common share_group)")
            claimed.append((i, m.region))

    def compile(self) -> "CompiledScenario":
        """Lower this scenario to a padded, beat-aligned ``Trace``."""
        self.validate()
        regions = resolve_regions(self)
        rows_iw, rows_b, rows_a, rows_s = [], [], [], []
        for i, (m, (lo, hi)) in enumerate(zip(self.masters, regions)):
            iw, b, a, s = m.source().emit(lo, hi, txns=m.txns, rate=m.rate,
                                          seed=m.seed + 7919 * i,
                                          params=m.params)
            rows_iw.append(iw)
            rows_b.append(b)
            rows_a.append(a)
            rows_s.append(s)
        n = max(len(r) for r in rows_iw)
        prios = [m.effective_priority() for m in self.masters]
        trace = Trace(pad_rows(rows_iw, n), pad_rows(rows_b, n),
                      pad_rows(rows_a, n), pad_rows(rows_s, n),
                      np.asarray(prios, np.int32))
        return CompiledScenario(self, trace, regions,
                                [m.qos for m in self.masters], prios,
                                [m.deadline for m in self.masters],
                                [m.share_group for m in self.masters])


@dataclass
class CompiledScenario:
    """A scenario lowered to the simulator's input format.

    A compiled scenario runs itself: :meth:`simulate` evaluates one parameter
    point, :meth:`simulate_batch` a whole parameter grid as lanes of one
    batch: the workload→result path every benchmark goes through.  Both run
    on ``device`` (default: CUDA).
    """
    scenario: Scenario
    trace: Trace
    regions: List[Tuple[int, int]]  # resolved [lo, hi) per master
    qos: List[str]  # per-master class
    priorities: Optional[List[int]] = None  # per-master arbiter level
    deadlines: Optional[List[Optional[int]]] = None  # per-master, cycles
    share_groups: Optional[List[Optional[str]]] = None  # per-master group

    @property
    def classes(self) -> List[str]:
        return self.qos

    def masters_of_class(self, cls: str) -> np.ndarray:
        return np.array([i for i, c in enumerate(self.qos) if c == cls],
                        np.int32)

    def schedule(self) -> "EventSchedule":
        """This scenario as a packed :class:`~repro_torch.core.traffic.EventSchedule`
        — the same transactions as :attr:`trace` plus the per-master QoS class
        index and deadline the streaming collector needs.  Feed it to any
        ``SimParams`` whose ``stages`` is the schedule pipeline."""
        from repro_torch.core.traffic import compile_schedule
        deadlines = self.deadlines or [None] * self.trace.num_masters
        return compile_schedule(
            self.trace,
            classes=[QOS_CLASSES.index(c) for c in self.qos],
            deadlines=deadlines)

    def simulate(self, params: SimParams = SimParams(), device=None) -> "SweepResult":
        """Run this scenario at one parameter point and summarize it."""
        return self.simulate_batch([params], device=device)[0]

    def simulate_batch(
        self,
        params: Sequence[SimParams],
        *,
        batched: bool = True,
        chunk: Optional[int] = None,
        device=None,
    ) -> List["SweepResult"]:
        """Run one trace × many parameter points (lanes of one batch when
        ``batched``; ``chunk=C`` runs C lanes at a time: see
        ``core.simulator.simulate_batch``); see ``scenarios.sweep.run_sweep``
        for scenario grids."""
        from repro_torch.scenarios.sweep import simulate_compiled

        return simulate_compiled(self, params, batched=batched, chunk=chunk, device=device)

    def summarize(self, params: SimParams, metrics) -> "SweepResult":
        """Per-class/isolation/slice summary of one point's raw metrics."""
        from repro_torch.scenarios.sweep import summarize_compiled

        return summarize_compiled(self, params, metrics)


def _check_region_bounds(i: int, region: Tuple[int, int],
                         geom: MemoryGeometry) -> None:
    """Loud, actionable error when a declared region falls outside the
    fabric's address space — never wrap or overlap silently."""
    lo, hi = region
    if lo < 0 or hi > geom.beats_total or lo >= hi:
        raise ValueError(
            f"master {i} region {region} exceeds memory or is inverted: the "
            f"fabric has {geom.beats_total} beats "
            f"({geom.beats_total * geom.beat_bytes} bytes across "
            f"{geom.num_slices} slice(s)); declared regions must satisfy "
            "0 <= lo < hi <= beats_total")


def _partition_gap(count: int, bounds: Tuple[int, int],
                   claims: List[Tuple[int, int]], what: str
                   ) -> List[Tuple[int, int]]:
    """Equally partition the largest free gap inside ``bounds`` (given the
    already-claimed regions) into ``count`` slots of >= MIN_REGION_BEATS."""
    b_lo, b_hi = bounds
    gaps, cur = [], b_lo
    for lo, hi in sorted(claims):
        if hi <= b_lo or lo >= b_hi:
            continue
        lo, hi = max(lo, b_lo), min(hi, b_hi)
        if lo > cur:
            gaps.append((cur, lo))
        cur = max(cur, hi)
    if cur < b_hi:
        gaps.append((cur, b_hi))
    if not gaps:
        raise ValueError(f"no address space left for {what}")
    g_lo, g_hi = max(gaps, key=lambda g: g[1] - g[0])
    slot = (g_hi - g_lo) // count
    if slot < MIN_REGION_BEATS:
        raise ValueError(
            f"largest free gap ({g_hi - g_lo} beats) cannot fit "
            f"{count} {what} of >= {MIN_REGION_BEATS} "
            "beats each")
    return [(g_lo + i * slot, g_lo + (i + 1) * slot) for i in range(count)]


def resolve_regions(scenario: Scenario) -> List[Tuple[int, int]]:
    """Explicit regions pass through; unplaced masters equally partition the
    *largest free gap* left by the explicit claims (so pinning a master high
    in memory doesn't starve auto placement), and every auto slot must meet
    the same ``MIN_REGION_BEATS`` floor explicit regions are held to.

    On a multi-slice fabric, a master with ``slice_affinity=s`` is auto-placed
    inside slice ``s``'s contiguous span (``slice_policy="region"``), so its
    working set stays slice-local (or deliberately remote — the
    ``slice_scaling`` preset uses both).  Under region-affine slicing an
    auto-placed master *without* an affinity defaults to its home slice
    (slice-local placement is the architecture's intent), so affine and
    unconstrained masters coexist: each slice's span is partitioned among the
    masters routed to it.  Hash-interleaved slicing has no contiguous spans,
    so there placement falls back to the global largest-gap rule.
    """
    geom = scenario.geom
    masters = scenario.masters
    for i, m in enumerate(masters):
        if m.region is not None:
            _check_region_bounds(i, m.region, geom)
    claims: List[Tuple[int, int]] = [
        (int(m.region[0]), int(m.region[1]))
        for m in masters if m.region is not None]
    out: List[Optional[Tuple[int, int]]] = [
        (int(m.region[0]), int(m.region[1])) if m.region is not None
        else None for m in masters]
    affine_spans = geom.num_slices > 1 and geom.slice_policy == "region"
    home = master_home_slices(len(masters), geom) if affine_spans else None
    affine: Dict[int, List[int]] = {}
    free: List[int] = []
    for i, m in enumerate(masters):
        if m.region is not None:
            continue
        aff = m.slice_affinity
        if aff is None and affine_spans:
            aff = int(home[i])  # default: stay slice-local
        if aff is not None and affine_spans:
            affine.setdefault(int(aff), []).append(i)
        else:
            free.append(i)
    for s in sorted(affine):
        slots = _partition_gap(len(affine[s]), geom.slice_span(s), claims,
                               f"slice-{s} auto-placed masters")
        for i, slot in zip(affine[s], slots):
            out[i] = slot
        claims += slots
    if free:
        slots = _partition_gap(len(free), (0, geom.beats_total), claims,
                               "auto-placed masters")
        for i, slot in zip(free, slots):
            out[i] = slot
    return out


def compile_scenario(scenario: Scenario) -> CompiledScenario:
    """Deprecated alias for :meth:`Scenario.compile`."""
    warnings.warn("compile_scenario(sc) is deprecated; use sc.compile()",
                  DeprecationWarning, stacklevel=2)
    return scenario.compile()
