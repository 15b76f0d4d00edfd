"""Property oracles over scenario simulation results: the fuzzer's judges.

The port's copy of the reference's ``scenarios/properties.py``.  The paper's
headline claims are universally quantified ("deterministic access latency
... under stringent real-time QoS constraints", ~100 % throughput "with full
injection rate" from many masters), so checking them only on the hand-written
presets leaves most of the space dark.  This module states the claims as
properties of any run that ``repro_torch.scenarios.fuzz`` can evaluate over
randomly generated scenarios:

  * **no_starvation**: every master with offered traffic makes progress: a
    run that hit its horizon while some early-offered master retired nothing
    (and others ran) is a starvation witness.
  * **conservation**: nothing is lost or invented: once the fabric drains
    (``drained_cycle >= 0``) every offered transaction has retired, per
    master and per class; and no master ever retires more than it offered.
  * **deadline_misses**: safety/realtime masters that declare (generously
    sampled) deadlines must meet them when the QoS machinery is on.
  * **isolation**: the safety class's p99 latency under full interference
    stays within a bound of its alone-run latency (aggressors silenced, same
    knobs) when priority arbitration and the best-effort regulator are on.
  * **metric_sanity**: the metric surface is internally consistent:
    per-channel throughput never exceeds 1 beat/cycle, ``drained_cycle`` /
    ``effective_cycles`` / ``skipped_cycles`` agree, percentiles sit below
    the exact maximum, counters never exceed their populations.

Each oracle is a pure function ``(PropertyContext) -> [Violation]``; bounds
live in :class:`OracleBounds` so the fuzzer (and its shrinker, which re-runs
the oracle after every candidate reduction) can tighten or relax them
without touching the checks.  Streaming runs (``collect="stream"``) report
P²-approximate percentiles, so the latency bounds here are loose on purpose:
they are claims about isolation, not about two-cycle differences.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

import numpy as np

from repro_torch.core.simulator import SimParams
from repro_torch.scenarios.spec import CompiledScenario
from repro_torch.scenarios.sweep import SweepResult

#: latency-percentile keys the isolation / sanity oracles inspect
_PCTL_KEYS = ("read_lat_p99", "write_lat_p99")


@dataclass
class Violation:
    """One oracle failure on one case — the unit the shrinker preserves."""
    oracle: str
    message: str
    details: Dict[str, object] = field(default_factory=dict)

    def to_json(self) -> Dict[str, object]:
        return {"oracle": self.oracle, "message": self.message,
                "details": {k: _json_safe(v) for k, v in self.details.items()}}


def _json_safe(v):
    if isinstance(v, (np.integer,)):
        return int(v)
    if isinstance(v, (np.floating,)):
        return float(v)
    if isinstance(v, np.ndarray):
        return v.tolist()
    if isinstance(v, (list, tuple)):
        return [_json_safe(x) for x in v]
    return v


@dataclass(frozen=True)
class OracleBounds:
    """Tunable thresholds shared by every oracle evaluation of one fuzz run."""
    #: max allowed deadline-miss *rate* per class (safety is strict; realtime
    #: tolerates a sliver — its deadlines are frame budgets, not ASIL bounds)
    safety_miss_rate_max: float = 0.0
    realtime_miss_rate_max: float = 0.02
    #: full-load safety p99 must satisfy  p99 <= alone_p99 * factor + slack
    isolation_factor: float = 3.0
    isolation_slack_cycles: float = 384.0
    #: slack on the 1-beat/cycle per-channel throughput ceiling
    throughput_eps: float = 1e-3
    #: starvation is only claimed for masters whose first offered event
    #: starts within this fraction of the horizon (later traffic may simply
    #: not have had time to be served before max_cycles)
    starvation_start_fraction: float = 0.25


@dataclass
class PropertyContext:
    """Everything one oracle evaluation sees about one simulated point.

    ``compiled`` may be an envelope-padded wrapper (padding rows are inert,
    burst 0, and every check below masks on offered traffic).  ``alone`` is
    the same scenario re-run with every non-safety master silenced at the
    same parameter point — present only when the isolation oracle applies.
    """
    compiled: CompiledScenario
    params: SimParams
    result: SweepResult
    alone: Optional[SweepResult] = None
    bounds: OracleBounds = field(default_factory=OracleBounds)

    # -- shared derived views ------------------------------------------------
    def offered(self) -> np.ndarray:
        """Real (non-padding) transactions offered per master row."""
        return (np.asarray(self.compiled.trace.burst) > 0).sum(axis=1)

    def done_per_master(self) -> Optional[np.ndarray]:
        tdp = self.result.metrics.get("txns_done_port")
        if tdp is None:
            return None
        return np.asarray(tdp).sum(axis=1)

    def first_start(self) -> np.ndarray:
        """Earliest offered-event issue cycle per master (horizon if none)."""
        start = self.compiled.trace.start_or_zeros()
        real = np.asarray(self.compiled.trace.burst) > 0
        s = np.where(real, start, np.iinfo(np.int32).max)
        return s.min(axis=1)

    def drained(self) -> bool:
        return int(np.asarray(self.result.metrics["drained_cycle"])) >= 0

    def qos_on(self) -> bool:
        """Anti-starvation aging active (the priority arbiter always runs)."""
        return self.params.qos_aging > 0

    def regulated(self) -> bool:
        return self.params.reg_rate > 0


OracleFn = Callable[[PropertyContext], List[Violation]]


def oracle_no_starvation(ctx: PropertyContext) -> List[Violation]:
    """Liveness: a master that offered traffic early must retire *something*.

    Only claimed when the run hit its horizon (a drained run completed
    everything by definition — conservation covers that) and the fabric as a
    whole made progress, so a globally stalled configuration reads as a
    conservation failure, not N starvation reports.
    """
    done = ctx.done_per_master()
    if done is None:
        return []
    offered = ctx.offered()
    if ctx.drained():
        return []
    horizon = ctx.params.max_cycles
    early = ctx.first_start() <= ctx.bounds.starvation_start_fraction * horizon
    starved = (offered > 0) & early & (done == 0)
    if starved.any() and done.sum() > 0:
        rows = np.flatnonzero(starved)
        return [Violation(
            "no_starvation",
            f"masters {rows.tolist()} offered traffic within the first "
            f"{ctx.bounds.starvation_start_fraction:.0%} of the horizon but "
            f"retired 0 transactions by cycle {horizon} while the fabric "
            f"retired {int(done.sum())}",
            {"starved_masters": rows, "offered": offered[rows],
             "qos": [ctx.compiled.qos[r] for r in rows
                     if r < len(ctx.compiled.qos)]})]
    return []


def oracle_conservation(ctx: PropertyContext) -> List[Violation]:
    """Accepted == retired at drain; never retire more than was offered."""
    out: List[Violation] = []
    done = ctx.done_per_master()
    offered = ctx.offered()
    if done is not None:
        over = done > offered
        if over.any():
            rows = np.flatnonzero(over)
            out.append(Violation(
                "conservation",
                f"masters {rows.tolist()} retired more transactions than "
                "they offered (double retire)",
                {"masters": rows, "done": done[rows],
                 "offered": offered[rows]}))
    if not ctx.drained():
        return out
    if not bool(np.asarray(ctx.result.metrics["all_done"])):
        out.append(Violation(
            "conservation",
            f"run drained at cycle "
            f"{int(np.asarray(ctx.result.metrics['drained_cycle']))} but "
            "all_done is False — the fabric went quiescent with offered "
            "transactions unserved", {}))
    if done is not None:
        lost = done < offered
        if lost.any():
            rows = np.flatnonzero(lost)
            out.append(Violation(
                "conservation",
                f"run drained but masters {rows.tolist()} retired fewer "
                "transactions than offered",
                {"masters": rows, "done": done[rows],
                 "offered": offered[rows]}))
    for cls, stats in ctx.result.per_class.items():
        if stats["txns_done"] != stats["txns_total"]:
            out.append(Violation(
                "conservation",
                f"run drained but class {cls!r} completed "
                f"{stats['txns_done']}/{stats['txns_total']} transactions",
                {"class": cls, "txns_done": stats["txns_done"],
                 "txns_total": stats["txns_total"]}))
    return out


def oracle_deadline_misses(ctx: PropertyContext) -> List[Violation]:
    """Bounded deadline misses for safety/realtime classes with QoS on.

    Evaluated on drained runs only: on a horizon-capped run unfinished
    transactions count as misses, which conflates capacity with QoS.  The
    fuzzer samples deadlines generously (``FuzzConfig.deadline_floor``), so a
    miss here is a scheduling result, not an impossible budget — except for
    deliberately planted tight-deadline specs, which exist to be caught.
    """
    if not ctx.drained() or not ctx.qos_on():
        return []
    out: List[Violation] = []
    limits = {"safety": ctx.bounds.safety_miss_rate_max,
              "realtime": ctx.bounds.realtime_miss_rate_max}
    for cls, limit in limits.items():
        stats = ctx.result.per_class.get(cls)
        if not stats or stats["deadline_txns"] == 0:
            continue
        rate = stats["deadline_miss_rate"]
        if np.isnan(rate) or rate <= limit:
            continue
        out.append(Violation(
            "deadline_misses",
            f"class {cls!r} missed {stats['deadline_misses']}/"
            f"{stats['deadline_txns']} deadlines (rate {rate:.3f} > "
            f"allowed {limit:.3f}) with QoS on",
            {"class": cls, "misses": stats["deadline_misses"],
             "considered": stats["deadline_txns"], "rate": rate,
             "limit": limit}))
    return out


def oracle_isolation(ctx: PropertyContext) -> List[Violation]:
    """Safety-class p99 under interference vs its alone-run latency.

    Requires ``ctx.alone`` (same scenario, aggressors silenced, same knobs).
    The bound is multiplicative + additive because streaming percentiles are
    P²-approximate and tiny alone-latencies would otherwise make the factor
    alone meaninglessly tight.
    """
    if ctx.alone is None or not (ctx.qos_on() and ctx.regulated()):
        return []
    full = ctx.result.per_class.get("safety")
    base = ctx.alone.per_class.get("safety")
    if not full or not base:
        return []
    out: List[Violation] = []
    for key in _PCTL_KEYS:
        fv, bv = full.get(key), base.get(key)
        if fv is None or bv is None or np.isnan(fv) or np.isnan(bv):
            continue
        bound = bv * ctx.bounds.isolation_factor \
            + ctx.bounds.isolation_slack_cycles
        if fv > bound:
            out.append(Violation(
                "isolation",
                f"safety {key} is {fv:.0f} cycles under interference vs "
                f"{bv:.0f} alone — exceeds the isolation bound "
                f"{bv:.0f} * {ctx.bounds.isolation_factor} + "
                f"{ctx.bounds.isolation_slack_cycles:.0f} = {bound:.0f}",
                {"metric": key, "full": fv, "alone": bv, "bound": bound}))
    return out


def oracle_metric_sanity(ctx: PropertyContext) -> List[Violation]:
    """The metric surface must be internally consistent on every run."""
    m = ctx.result.metrics
    out: List[Violation] = []

    def bad(msg, **details):
        out.append(Violation("metric_sanity", msg, details))

    cycles = int(np.asarray(m["cycles"]))
    drained = int(np.asarray(m["drained_cycle"]))
    effective = int(np.asarray(m["effective_cycles"]))
    skipped = int(np.asarray(m["skipped_cycles"]))
    if not (drained == -1 or 0 <= drained <= cycles):
        bad(f"drained_cycle {drained} outside [-1, cycles={cycles}]",
            drained_cycle=drained, cycles=cycles)
    want_eff = drained if drained >= 0 else cycles
    if effective != want_eff:
        bad(f"effective_cycles {effective} != "
            f"{'drained_cycle' if drained >= 0 else 'cycles'} {want_eff}",
            effective_cycles=effective, drained_cycle=drained, cycles=cycles)
    if not 0 <= skipped <= cycles:
        bad(f"skipped_cycles {skipped} outside [0, cycles={cycles}]",
            skipped_cycles=skipped, cycles=cycles)
    # per-port, per-direction throughput can never beat the 1-beat/cycle
    # AXI channel width — "throughput <= injection", the physical ceiling
    eps = ctx.bounds.throughput_eps
    for key in ("read_throughput", "write_throughput",
                "read_throughput_busy", "write_throughput_busy"):
        v = np.asarray(m[key])
        if (v > 1.0 + eps).any():
            bad(f"{key} exceeds 1 beat/cycle on ports "
                f"{np.flatnonzero(v > 1.0 + eps).tolist()}",
                key=key, values=v[v > 1.0 + eps])
    for cls, stats in ctx.result.per_class.items():
        if stats["txns_done"] > stats["txns_total"]:
            bad(f"class {cls!r} txns_done {stats['txns_done']} > txns_total "
                f"{stats['txns_total']}", cls=cls)
        if stats["deadline_misses"] > stats["deadline_txns"]:
            bad(f"class {cls!r} deadline_misses {stats['deadline_misses']} > "
                f"deadline_txns {stats['deadline_txns']}", cls=cls)
        for prefix in ("read", "write"):
            p99 = stats.get(f"{prefix}_lat_p99")
            mx = stats.get(f"{prefix}_lat_max")
            if p99 is None or mx is None or np.isnan(p99) or np.isnan(mx):
                continue
            # P² marker heights are clamped inside the observed range, so
            # even the approximate p99 can never exceed the exact maximum
            if p99 > mx + 1e-6:
                bad(f"class {cls!r} {prefix}_lat_p99 {p99:.1f} > "
                    f"{prefix}_lat_max {mx:.1f}", cls=cls, p99=p99, max=mx)
            if p99 < 0 or mx < 0:
                bad(f"class {cls!r} negative latency percentile", cls=cls,
                    p99=p99, max=mx)
    return out


#: evaluation order — cheap structural checks first, cross-run checks last
ORACLES: Dict[str, OracleFn] = {
    "metric_sanity": oracle_metric_sanity,
    "conservation": oracle_conservation,
    "no_starvation": oracle_no_starvation,
    "deadline_misses": oracle_deadline_misses,
    "isolation": oracle_isolation,
}


def check_properties(ctx: PropertyContext) -> List[Violation]:
    """Run every oracle over one simulated point; [] means the case passed."""
    out: List[Violation] = []
    for fn in ORACLES.values():
        out.extend(fn(ctx))
    return out
