"""Batched scenario × SimParams sweeps — one batch, many points (the port's copy).

``run_sweep`` evaluates a grid of :class:`SweepPoint`s (a scenario plus a
simulator parameter point) as the lanes of ONE batch: every trace is padded
to the grid's [X, N] envelope, dynamic parameters travel as a per-lane
vector, and one cycle loop on the device produces every point's metrics.
``batched=False`` runs the identical padded inputs through sequential
:func:`~repro_torch.core.simulator.simulate` calls — the two paths are
bit-for-bit equal (tested), so the batched path is a pure speed feature.
Every entry point runs on ``device`` (default: CUDA; ``device="cpu"`` runs
the plain PyTorch path on the host).
``CompiledScenario.simulate``/``simulate_batch`` (one scenario, N parameter
points) are the single-workload face of the same machinery.

Canonical metric-key schema
---------------------------
Per-class stats use ONE naming convention, shared verbatim with the raw
simulator metrics dict::

    {dir}_{metric}

  * ``dir``      — ``read`` | ``write`` (AXI R/W channels are independent;
                   their completions have different semantics and are never
                   mixed in one statistic)
  * ``metric``   — ``throughput`` (beats/cycle over the port's wall span),
                   ``throughput_busy`` (beats/cycle over busy cycles only),
                   ``lat_p50``/``lat_p95``/``lat_p99``/``lat_max``
                   (acceptance→completion), and the ``e2e_lat_*`` family
                   (earliest-issue→completion)

plus the direction-free bookkeeping keys (``masters``, ``txns_done``,
``txns_total``, ``deadline_txns``, ``deadline_misses``,
``deadline_miss_rate``).  The pre-schema spellings (``read_tput``,
``write_tput``) remain readable through :class:`MetricAliasDict` but emit a
``DeprecationWarning``; no in-repo benchmark or test reads them.

Per-point reporting (``CompiledScenario.summarize``) gives the paper's QoS
view: latency percentiles per QoS class and isolation violations (region
overlap + cross-class shared sub-banks) via ``core.qos``; masters that opt
into a common ``share_group`` (serving ports over one KV pool) are treated
as one logical master by both isolation checks.
"""
from __future__ import annotations

import time
import warnings
from dataclasses import dataclass, field, replace
from typing import Dict, List, Optional, Sequence

import numpy as np

from repro_torch.core.address import master_home_slices, slice_of_beat
from repro_torch.core.percentile import p2_quantiles
from repro_torch.core.qos import regions_isolated, touched_subbanks
from repro_torch.core.simulator import (
    STREAM_CLASSES,
    UNCLASSIFIED,
    SimParams,
    batch_envelope,
    simulate,
    simulate_batch,
)
from repro_torch.core.traffic import compile_schedule, pad_trace
from repro_torch.scenarios.spec import QOS_CLASSES, CompiledScenario, Scenario

PERCENTILES = (50, 95, 99)

#: deprecated per-class metric keys → their canonical names
DEPRECATED_METRIC_KEYS = {
    "read_tput": "read_throughput",
    "write_tput": "write_throughput",
}


class MetricAliasDict(dict):
    """Per-class stats dict: deprecated keys still resolve (to their
    canonical entry) but emit a ``DeprecationWarning``."""

    def __missing__(self, key):
        canon = DEPRECATED_METRIC_KEYS.get(key)
        if canon is None or canon not in self:
            raise KeyError(key)
        warnings.warn(f"metric key {key!r} is deprecated; read {canon!r}",
                      DeprecationWarning, stacklevel=2)
        return dict.__getitem__(self, canon)

    def get(self, key, default=None):
        try:
            return self[key]
        except KeyError:
            return default

    def __contains__(self, key):
        if dict.__contains__(self, key):
            return True
        canon = DEPRECATED_METRIC_KEYS.get(key)
        return canon is not None and dict.__contains__(self, canon)


@dataclass
class SweepPoint:
    scenario: Scenario
    params: SimParams = field(default_factory=SimParams)


@dataclass
class SweepResult:
    name: str
    params: SimParams
    metrics: Dict[str, np.ndarray]  # raw simulator outputs for this point
    per_class: Dict[str, Dict[str, float]]
    isolation: Dict[str, object]
    slices: Dict[str, object] = field(default_factory=dict)
    #: sweep-level simulation rate (shared by every point of one call):
    #: wall_s, sim_cycles_per_sec (NOMINAL max_cycles / wall second, summed
    #: over the batch), nominal vs effective
    #: cycles + drained_fraction (early-exit accounting), batched
    sim_rate: Dict[str, object] = field(default_factory=dict)

    def summary(self) -> Dict[str, object]:
        return {
            "scenario": self.name,
            "outstanding": self.params.outstanding,
            "banking": self.params.banking,
            "all_done": bool(self.metrics["all_done"]),
            "per_class": self.per_class,
            "isolation": self.isolation,
            "slices": self.slices,
            "sim_rate": self.sim_rate,
        }


def _class_stats(compiled: CompiledScenario,
                 metrics: Dict[str, np.ndarray]) -> Dict[str, Dict[str, float]]:
    """Latency percentiles + throughput per QoS class, from per-txn cycles.

    Read and write completions have different semantics (a write completes at
    the grant of its last beat, a read at its last return-bus beat), so their
    percentiles are reported separately; per-direction throughput averages
    only over masters that actually issued that direction, so a write-only
    camera cannot drag a class's read throughput toward zero.  Masters that
    declare a ``deadline`` get per-class miss accounting: a transaction
    misses when it never completes or completes more than ``deadline``
    cycles after its earliest-issue (``start``) time."""
    trace = compiled.trace
    acc = np.asarray(metrics["accept_cycle"])
    com = np.asarray(metrics["complete_cycle"])
    iw = np.asarray(trace.is_write)
    start = trace.start_or_zeros()
    real = np.asarray(trace.burst) > 0
    done = (com >= 0) & (acc >= 0) & real
    lat = (com - acc).astype(np.float64)
    # end-to-end service latency: earliest-issue (``start``) to completion.
    # Acceptance-based latency hides time a gated port spends *waiting to be
    # accepted* (outstanding credits, regulator, router ingress); the e2e
    # view charges it — the penalty deadline accounting and the slice_scaling
    # benchmark's remote-placement numbers are about.
    lat_e2e = (com - start).astype(np.float64)
    X = trace.num_masters
    deadlines = compiled.deadlines or [None] * X
    dl = np.array([-1 if d is None else int(d) for d in deadlines])
    tput = {d: np.asarray(metrics[f"{d}_throughput"])
            for d in ("read", "write")}
    tput_busy = {d: np.asarray(metrics[f"{d}_throughput_busy"])
                 for d in ("read", "write")}

    def pctl_block(stats, prefix, sel, values=lat):
        vals = values[sel]
        for p in PERCENTILES:
            stats[f"{prefix}_lat_p{p}"] = (
                float(np.percentile(vals, p)) if vals.size else float("nan"))
        stats[f"{prefix}_lat_max"] = (
            float(vals.max()) if vals.size else float("nan"))

    out: Dict[str, Dict[str, float]] = {}
    for cls in sorted(set(compiled.qos)):
        rows = compiled.masters_of_class(cls)
        sel = np.zeros_like(done)
        sel[rows] = done[rows]
        stats: Dict[str, float] = MetricAliasDict({
            "masters": int(len(rows)),
            "txns_done": int(sel.sum()),
            "txns_total": int(real[rows].sum()),
        })
        issued = {"read": (real[rows] & (iw[rows] == 0)).any(axis=1),
                  "write": (real[rows] & (iw[rows] == 1)).any(axis=1)}
        for d in ("read", "write"):
            has = issued[d]
            stats[f"{d}_throughput"] = (
                float(tput[d][rows][has].mean()) if has.any()
                else float("nan"))
            stats[f"{d}_throughput_busy"] = (
                float(tput_busy[d][rows][has].mean()) if has.any()
                else float("nan"))
        pctl_block(stats, "read", sel & (iw == 0))
        pctl_block(stats, "write", sel & (iw == 1))
        pctl_block(stats, "read_e2e", sel & (iw == 0), lat_e2e)
        pctl_block(stats, "write_e2e", sel & (iw == 1), lat_e2e)
        rows_dl = rows[dl[rows] >= 0]
        considered = real[rows_dl]
        missed = considered & (~done[rows_dl]
                               | (com[rows_dl] - start[rows_dl]
                                  > dl[rows_dl][:, None]))
        stats["deadline_txns"] = int(considered.sum())
        stats["deadline_misses"] = int(missed.sum())
        stats["deadline_miss_rate"] = (
            float(missed.sum() / considered.sum())
            if considered.sum() else float("nan"))
        out[cls] = stats
    return out


def _stream_class_stats(compiled: CompiledScenario,
                        metrics: Dict[str, np.ndarray]
                        ) -> Dict[str, Dict[str, float]]:
    """Per-class stats from the streaming accumulators (``collect="stream"``).

    Emits the SAME key schema as :func:`_class_stats` — throughput comes from
    the identical per-port counters, latency percentiles from the P² marker
    state (within the documented ``percentile.P2_RANK_TOL_PCT`` rank band of
    the exact numbers), ``lat_max`` and the class/deadline counts exactly.
    ``txns_total``/``deadline_txns`` are static properties of the workload and
    are recomputed host-side from the trace."""
    trace = compiled.trace
    iw = np.asarray(trace.is_write)
    real = np.asarray(trace.burst) > 0
    X = trace.num_masters
    deadlines = compiled.deadlines or [None] * X
    dl = np.array([-1 if d is None else int(d) for d in deadlines])
    tput = {d: np.asarray(metrics[f"{d}_throughput"])
            for d in ("read", "write")}
    tput_busy = {d: np.asarray(metrics[f"{d}_throughput_busy"])
                 for d in ("read", "write")}
    cls_done = np.asarray(metrics["cls_done"])  # [NC, (r, w)]
    dl_done = np.asarray(metrics["dl_done"])  # [NC]
    dl_miss = np.asarray(metrics["dl_miss"])  # [NC]
    p2q = p2_quantiles(metrics["p2_height"], metrics["p2_npos"],
                       metrics["p2_count"])  # [G, NQ]
    p2_count = np.asarray(metrics["p2_count"])
    p2_max = np.asarray(metrics["p2_max"])

    def pctl_block(stats, prefix, g):
        for i, p in enumerate(PERCENTILES):
            stats[f"{prefix}_lat_p{p}"] = (
                float(p2q[g, i]) if p2_count[g] > 0 else float("nan"))
        stats[f"{prefix}_lat_max"] = (
            float(p2_max[g]) if p2_count[g] > 0 else float("nan"))

    out: Dict[str, Dict[str, float]] = {}
    for cls in sorted(set(compiled.qos)):
        rows = compiled.masters_of_class(cls)
        cid = QOS_CLASSES.index(cls)
        stats: Dict[str, float] = MetricAliasDict({
            "masters": int(len(rows)),
            "txns_done": int(cls_done[cid].sum()),
            "txns_total": int(real[rows].sum()),
        })
        issued = {"read": (real[rows] & (iw[rows] == 0)).any(axis=1),
                  "write": (real[rows] & (iw[rows] == 1)).any(axis=1)}
        for d in ("read", "write"):
            has = issued[d]
            stats[f"{d}_throughput"] = (
                float(tput[d][rows][has].mean()) if has.any()
                else float("nan"))
            stats[f"{d}_throughput_busy"] = (
                float(tput_busy[d][rows][has].mean()) if has.any()
                else float("nan"))
        # streaming group ids: view * (2 NC) + class * 2 + dir
        for d, dname in ((0, "read"), (1, "write")):
            pctl_block(stats, dname, cid * 2 + d)
            pctl_block(stats, f"{dname}_e2e",
                       2 * STREAM_CLASSES + cid * 2 + d)
        considered = int(real[rows[dl[rows] >= 0]].sum())
        # misses = completed-late + never-completed
        missed = int(dl_miss[cid]) + considered - int(dl_done[cid])
        stats["deadline_txns"] = considered
        stats["deadline_misses"] = missed
        stats["deadline_miss_rate"] = (
            float(missed / considered) if considered else float("nan"))
        out[cls] = stats
    return out


def _share_labels(compiled: CompiledScenario, num_masters: int) -> List[int]:
    """Isolation-group label per trace row: masters naming the same
    ``share_group`` collapse to one label; everyone else (and inert padding
    rows past the compiled master list) is its own group."""
    groups = compiled.share_groups or []
    gid: Dict[object, int] = {}
    labels = []
    for m in range(num_masters):
        g = groups[m] if m < len(groups) else None
        key = ("g", g) if g is not None else ("m", m)
        labels.append(gid.setdefault(key, len(gid)))
    return labels


def _isolation_report(compiled: CompiledScenario) -> Dict[str, object]:
    """Static isolation checks: do declared regions overlap, and do masters
    of *different* QoS classes share (bank, sub-bank) granules?  Share-group
    members count as one logical master for both checks."""
    trace = compiled.trace
    labels = _share_labels(compiled, trace.num_masters)
    ok = regions_isolated(trace, compiled.scenario.geom, groups=labels)
    owners: Dict[int, int] = {}
    cross = 0
    for m in range(trace.num_masters):
        for g in touched_subbanks(trace.addr[m], trace.burst[m],
                                  compiled.scenario.geom):
            prev = owners.setdefault(int(g), m)
            if prev != m and labels[prev] != labels[m] \
                    and compiled.qos[prev] != compiled.qos[m]:
                cross += 1
    return {"regions_isolated": bool(ok),
            "cross_class_shared_subbanks": int(cross)}


def _slice_report(compiled: CompiledScenario,
                  metrics: Dict[str, np.ndarray]) -> Dict[str, object]:
    """Multi-slice fabric view of one point: how much offered traffic crosses
    the inter-slice router (a *static* property of placement: beats whose
    target slice differs from the issuing master's home slice) and how evenly
    the slices' banks were occupied (from the simulator's per-slice service
    counters).  At ``num_slices=1`` everything is trivially local."""
    geom = compiled.scenario.geom
    trace = compiled.trace
    home = master_home_slices(trace.num_masters, geom)
    crossing, total = 0, 0
    per_master = []
    for m in range(trace.num_masters):
        beats = [np.arange(a, a + b)
                 for a, b in zip(trace.addr[m], trace.burst[m]) if b > 0]
        if not beats:
            per_master.append(0.0)
            continue
        sl = slice_of_beat(np.concatenate(beats), geom)[0]
        n, x = len(sl), int((sl != home[m]).sum())
        crossing += x
        total += n
        per_master.append(x / n)
    sb = np.asarray(metrics.get("slice_beats", np.zeros(geom.num_slices)),
                    np.float64)
    occ = (sb / sb.sum()).tolist() if sb.sum() > 0 else sb.tolist()
    return {
        "num_slices": int(geom.num_slices),
        "crossing_fraction": (crossing / total) if total else 0.0,
        "crossing_fraction_per_master": per_master,
        "slice_beats": sb.astype(np.int64).tolist(),
        "slice_occupancy": occ,
    }


def summarize_compiled(compiled: CompiledScenario, params: SimParams,
                       metrics: Dict[str, np.ndarray]) -> SweepResult:
    """Implementation behind :meth:`CompiledScenario.summarize`.

    Streaming runs (``collect="stream"``) carry no per-transaction timestamp
    arrays, so their per-class stats come from the fixed-size accumulators;
    exact runs are summarized from the raw ``accept_cycle``/``complete_cycle``
    columns as before.  Both emit the same key schema."""
    stats_fn = (_class_stats if "accept_cycle" in metrics
                else _stream_class_stats)
    return SweepResult(compiled.scenario.name, params, metrics,
                       stats_fn(compiled, metrics),
                       _isolation_report(compiled),
                       _slice_report(compiled, metrics))


def summarize_point(compiled: CompiledScenario, params: SimParams,
                    metrics: Dict[str, np.ndarray]) -> SweepResult:
    """Deprecated alias for :meth:`CompiledScenario.summarize`."""
    warnings.warn("summarize_point(c, p, m) is deprecated; use "
                  "c.summarize(p, m)", DeprecationWarning, stacklevel=2)
    return summarize_compiled(compiled, params, metrics)


def simulate_compiled(
    compiled: CompiledScenario,
    prms: Sequence[SimParams],
    *,
    batched: bool = True,
    chunk: Optional[int] = None,
    device=None,
) -> List[SweepResult]:
    """One compiled scenario × many parameter points (the implementation
    behind ``CompiledScenario.simulate``/``simulate_batch``).

    The trace enters the batch ONCE (shared across the whole parameter
    grid); points whose ``stages`` select the schedule pipeline run from the
    scenario's packed :meth:`CompiledScenario.schedule` (which also carries
    the QoS classes/deadlines the streaming collector groups by).
    ``chunk=C`` bounds peak live memory to one C-point chunk."""
    if not prms:
        return []
    env = batch_envelope(list(prms))
    pinned = [replace(p, slots_override=env.slots_per_master,
                      inflight_override=env.inflight_slots) for p in prms]
    inp = compiled.schedule() if env.uses_schedule() else compiled.trace
    t0 = time.perf_counter()
    if batched and len(pinned) > 1:
        stacked = simulate_batch([inp], pinned, chunk=chunk, device=device)
        per_point = [{k: np.asarray(v)[i] for k, v in stacked.items()}
                     for i in range(len(pinned))]
    else:
        per_point = [simulate(inp, p, device=device) for p in pinned]
    rate = _sim_rate(pinned, time.perf_counter() - t0, batched,
                     per_point)
    out = [summarize_compiled(compiled, p, met)
           for p, met in zip(pinned, per_point)]
    for r in out:
        r.sim_rate = rate
    return out


def run_sweep(
    points: Sequence[SweepPoint],
    *,
    batched: bool = True,
    envelope: Optional[Sequence[SweepPoint]] = None,
    chunk: Optional[int] = None,
    device=None,
) -> List[SweepResult]:
    """Evaluate every point; lanes of one batch when ``batched``.

    ``envelope`` (default: ``points``) is the grid whose trace shapes and
    parameter extremes define the common padding/ring-size envelope.  Pass the
    full grid here to evaluate a *subset* of it under identical padding —
    e.g. to spot-check a batched sweep against sequential runs bit-for-bit.
    ``chunk=C`` runs the batch C points at a time.  ``device`` defaults to
    the CUDA device.
    """
    if not points:
        return []
    compiled = [p.scenario.compile() for p in points]
    env_pts = list(points) if envelope is None else list(envelope)
    env_compiled = (compiled if envelope is None
                    else [p.scenario.compile() for p in env_pts])
    X = max(c.trace.num_masters for c in env_compiled + compiled)
    N = max(c.trace.num_txns for c in env_compiled + compiled)
    padded = [pad_trace(c.trace, X, N) for c in compiled]
    env = batch_envelope([p.params for p in env_pts]
                         + [p.params for p in points])
    # pin every point to the envelope ring/in-flight-table size so
    # batched == sequential
    prms = [replace(p.params, slots_override=env.slots_per_master,
                    inflight_override=env.inflight_slots)
            for p in points]
    inputs = (padded if not env.uses_schedule()
              else [_padded_schedule(c, t) for c, t in zip(compiled, padded)])
    t0 = time.perf_counter()
    if batched:
        stacked = simulate_batch(inputs, prms, chunk=chunk, device=device)
        per_point = [
            {k: np.asarray(v)[i] for k, v in stacked.items()}
            for i in range(len(points))]
    else:
        per_point = [simulate(t, p, device=device) for t, p in zip(inputs, prms)]
    rate = _sim_rate(prms, time.perf_counter() - t0, batched,
                     per_point)
    out = []
    for comp, prm, met, pad in zip(compiled, prms, per_point, padded):
        # class stats index by the ORIGINAL master rows; padding rows are
        # inert (burst 0) and the padded trace preserves row order
        comp_for_stats = CompiledScenario(comp.scenario, pad, comp.regions,
                                          comp.qos, comp.priorities,
                                          comp.deadlines, comp.share_groups)
        res = summarize_compiled(comp_for_stats, prm, met)
        res.sim_rate = rate
        out.append(res)
    return out


def _padded_schedule(compiled: CompiledScenario, padded_trace):
    """Schedule for one sweep point's envelope-padded trace: the compiled
    masters keep their QoS class/deadline; inert padding rows are
    unclassified."""
    X = padded_trace.num_masters
    cls = [QOS_CLASSES.index(c) for c in compiled.qos]
    dls = list(compiled.deadlines or [None] * len(compiled.qos))
    return compile_schedule(padded_trace,
                            classes=cls + [UNCLASSIFIED] * (X - len(cls)),
                            deadlines=dls + [None] * (X - len(dls)))


def _sim_rate(prms: Sequence[SimParams], wall_s: float, batched: bool,
              per_point: Optional[Sequence[Dict[str, np.ndarray]]] = None
              ) -> Dict[str, object]:
    """Sweep-level simulated-cycles/sec (includes the first call's kernel
    build on a cold process).

    ``sim_cycles_per_sec`` stays the *nominal* rate (``max_cycles`` summed
    over the grid) so the denominator is comparable across runs; with the
    early-exit driver the cycle loop stops at the drain point, so the summary
    also reports the *effective* cycles actually simulated and the fraction
    of points that drained before their horizon."""
    cycles = sum(p.max_cycles for p in prms)
    out = {"wall_s": round(wall_s, 3),
           "sim_cycles_per_sec": round(cycles / max(wall_s, 1e-9), 1),
           "batched": batched}
    if per_point is not None:
        eff = sum(int(m["effective_cycles"]) for m in per_point)
        drained = sum(int(m["drained_cycle"]) >= 0 for m in per_point)
        out["nominal_cycles"] = int(cycles)
        out["effective_cycles"] = eff
        out["effective_cycles_per_sec"] = round(eff / max(wall_s, 1e-9), 1)
        out["drained_fraction"] = round(drained / max(len(prms), 1), 4)
    return out
