"""Scenario fuzzer: seeded random spec generation, oracle checks, shrinking.

The port's copy of the reference's ``scenarios/fuzz.py``.  The presets in
``scenarios/library.py`` cover a few hand-picked master mixes; this module
samples :class:`~repro_torch.scenarios.spec.Scenario` specs from an unbounded
randomized space (random master mixes over every synthetic traffic model,
random QoS class and deadline assignments, randomized disjoint region layouts
and slice affinities, sensor-dropout and degraded modes, saturating
multi-tenant best-effort aggressors, a palette of
:class:`~repro_torch.core.address.MemoryGeometry` shapes, and random dyn-knob
points), evaluates them in batches through ``SCHEDULE_PIPELINE`` with
``collect="stream"``, and judges every run with the property oracles of
``repro_torch.scenarios.properties``.

Determinism contract: every sampled artifact derives from
``np.random.default_rng([seed, case_index])``, so case ``i`` of seed ``s`` is
the same spec on every machine and run, whatever the evaluation order or time
limit, and the same spec the reference package samples.

When an oracle fires, :func:`shrink_case` delta-debugs the spec (drop
masters, halve transaction counts and burst/window parameters, collapse the
geometry, neutralize dyn knobs), re-checking the same oracle after every
candidate reduction, and emits a minimal spec.  :func:`case_to_json` /
:func:`case_from_json` round-trip any case through plain JSON, the format of
the reproducers in ``tests/data/fuzz_corpus/``.

Every evaluation pads its traces to at least a fixed ``(masters, txns)``
envelope and pins the ring and in-flight sizes to ``FUZZ_SLOTS`` /
``FUZZ_INFLIGHT``; padding rows are inert, so a case's verdict does not
depend on the batch it ran in.  Cases that share a geometry (and the other
static fields) run as lanes of one ``simulate_batch`` call, and isolation
alone-runs are the same trace with the aggressors' bursts zeroed, as extra
lanes.  Every entry point runs on ``device`` (default: CUDA; ``device="cpu"``
runs the plain PyTorch path on the host).
"""

from __future__ import annotations

import json
import time
from dataclasses import asdict, dataclass, field, replace
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.address import MemoryGeometry
from repro_torch.core.simulator import (DYN_FIELDS, SCHEDULE_PIPELINE,
                                        SimParams, Trace, batch_envelope,
                                        simulate_batch)
from repro_torch.core.traffic import pad_trace
from repro_torch.scenarios.properties import (OracleBounds, PropertyContext,
                                              Violation, check_properties)
from repro_torch.scenarios.spec import (MIN_REGION_BEATS, CompiledScenario,
                                        MasterSpec, Scenario)
from repro_torch.scenarios.sweep import (SweepResult, _padded_schedule,
                                         summarize_compiled)

#: named geometry palette the generator samples from: small fabrics keep the
#: per-point cost low, and a geometry is a static batch field, so the palette
#: bounds the number of batches per evaluation
GEOMETRIES: Dict[str, MemoryGeometry] = {
    "small16": MemoryGeometry(num_clusters=2, arrays_per_cluster=2,
                              banks_per_array=4, total_bytes=1 * 2**20),
    "slice2_region": MemoryGeometry(num_clusters=2, arrays_per_cluster=2,
                                    banks_per_array=4, total_bytes=1 * 2**20,
                                    num_slices=2, slice_policy="region"),
    "slice2_hash": MemoryGeometry(num_clusters=2, arrays_per_cluster=2,
                                  banks_per_array=4, total_bytes=1 * 2**20,
                                  num_slices=2, slice_policy="hash"),
    "paper": MemoryGeometry(),
}

#: ring / in-flight-table sizes pinned across the whole run: the maxima the
#: knob space below can require (outstanding 16 × max_burst 16, ×2), so every
#: sampled point of one geometry fits one batch
FUZZ_SLOTS = 512
FUZZ_INFLIGHT = 32

#: deadline planted violations carry — below the fabric's physical latency
#: floor (cmd + bank + ret latency), so every transaction must miss it
PLANTED_DEADLINE = 2

#: dyn-knob palette (per-lane values: a knob choice never splits a batch)
_KNOB_SPACE = {
    "outstanding": (2, 4, 8, 16),
    "cmd_latency": (2, 8),
    "ret_latency": (2, 9),
    "bank_occupancy": (1, 2, 4, 8, 12),
    "bank_latency": (1, 2),
    "qos_aging": (0, 64, 128, 256),
    # floor 32 (1/8 beat/cycle): a trickling regulated aggressor stays busy
    # its whole budget, so slower rates pin chunks at the full horizon and
    # defeat the early-exit/time-skip machinery the fuzz budget relies on
    "reg_rate": (0, 32, 64, 128),
    "reg_burst": (8, 16, 32),
    "hop_latency": (0, 2, 6),
    "slice_ingress": (0, 8, 32),
}

#: shrinker targets: knob -> neutral value (tried one at a time, kept only
#: while the violation survives)
_NEUTRAL_KNOBS = (("qos_aging", 0), ("reg_rate", 0), ("reg_burst", 16),
                  ("hop_latency", 0), ("slice_ingress", 0),
                  ("cmd_latency", 1), ("ret_latency", 1),
                  ("bank_occupancy", 1), ("bank_latency", 1),
                  ("outstanding", 8))


@dataclass(frozen=True)
class FuzzConfig:
    """One fuzz run's sampling space, budget, and oracle bounds."""
    seed: int = 0
    budget: int = 100                 # specs to generate and evaluate
    min_masters: int = 2
    max_masters: int = 8
    txns_lo: int = 6
    txns_hi: int = 32
    max_cycles: int = 10_000
    chunk: int = 64                   # simulate_batch chunk (peak-memory cap)
    geometries: Tuple[str, ...] = tuple(GEOMETRIES)
    plant_rate: float = 0.0           # P(spec carries a planted violation) —
                                      # 0 in CI; tests/corpus seeding use it
    deadline_floor: int = 4000        # sampled deadlines land in
                                      # [floor, 2*floor): generous by design
    shrink_limit: int = 6             # violating cases shrunk per run
    shrink_rounds: int = 8            # shrinker fixpoint cap
    bounds: OracleBounds = field(default_factory=OracleBounds)

    def to_json(self) -> Dict[str, object]:
        d = asdict(self)
        d["geometries"] = list(self.geometries)
        return d


@dataclass
class FuzzCase:
    """One sampled (scenario, parameter-point) spec."""
    index: int
    geometry: str                     # GEOMETRIES key (or "custom" on load)
    scenario: Scenario
    params: SimParams
    planted: bool = False

    @property
    def name(self) -> str:
        return self.scenario.name


@dataclass
class CaseResult:
    """One evaluated case: summaries plus any oracle violations."""
    case: FuzzCase
    result: SweepResult
    alone: Optional[SweepResult]
    violations: List[Violation]


@dataclass
class FuzzOutcome:
    """What a budgeted fuzz run produced."""
    config: FuzzConfig
    evaluated: int
    violating: List[CaseResult]
    reproducers: List[Dict[str, object]]
    truncated: bool                   # time limit hit before the budget
    wall_s: float

    def summary(self) -> Dict[str, object]:
        return {
            "seed": self.config.seed,
            "budget": self.config.budget,
            "evaluated": self.evaluated,
            "truncated": self.truncated,
            "wall_s": round(self.wall_s, 2),
            "cases_per_sec": round(self.evaluated / max(self.wall_s, 1e-9),
                                   2),
            "violations": len(self.violating),
            "violated_oracles": sorted({v.oracle for c in self.violating
                                        for v in c.violations}),
            "reproducers": self.reproducers,
        }


# ---------------------------------------------------------------------------
# spec sampling
# ---------------------------------------------------------------------------

_SENSORS = ("camera", "radar", "lidar")
_ALL_MODELS = ("camera", "radar", "lidar", "npu", "cpu", "uniform")
_AGGRESSOR_MODELS = ("npu", "lidar", "cpu", "uniform")


def _sample_model_params(rng: np.random.Generator, model: str) -> Dict:
    """Shape knobs per traffic model (bursts, windows, read mixes)."""
    if model == "camera":
        return {"line_beats": int(rng.choice((64, 96, 120))),
                "frame_lines": int(rng.choice((8, 12, 16))),
                "readback": bool(rng.random() < 0.3)}
    if model == "radar":
        return {"chirp_beats": int(rng.choice((64, 96, 128))),
                "readback": bool(rng.random() < 0.7)}
    if model == "lidar":
        return {"burst": int(rng.choice((2, 4, 8))),
                "read_fraction": float(rng.uniform(0.1, 0.5))}
    if model == "npu":
        return {"tile": int(rng.choice((4, 8))),
                "tile_width_beats": int(rng.choice((16, 32)))}
    if model == "cpu":
        return {"read_fraction": float(rng.uniform(0.3, 0.9))}
    return {"burst": int(rng.choice((1, 2, 4, 8, 16))),
            "read_fraction": float(rng.uniform(0.2, 0.8))}


def _sample_regions(rng: np.random.Generator, n: int,
                    beats_total: int) -> List[Tuple[int, int]]:
    """``n`` random-width disjoint regions (each >= MIN_REGION_BEATS),
    separated by random gaps — a randomized explicit memory layout."""
    units = beats_total // MIN_REGION_BEATS
    max_w = max(units // (2 * n), 1)
    widths = 1 + rng.integers(0, max_w, n)
    slack = units - int(widths.sum())
    gaps = rng.integers(0, max(slack // (n + 1), 0) + 1, n)
    regions, pos = [], 0
    for w, g in zip(widths, gaps):
        pos += int(g)
        regions.append((pos * MIN_REGION_BEATS,
                        (pos + int(w)) * MIN_REGION_BEATS))
        pos += int(w)
    order = rng.permutation(n)
    return [regions[i] for i in order]


def sample_case(cfg: FuzzConfig, index: int) -> FuzzCase:
    """Deterministically sample spec ``index`` of ``cfg.seed``'s space."""
    rng = np.random.default_rng([cfg.seed, index])
    geometry = str(cfg.geometries[int(rng.integers(len(cfg.geometries)))])
    geom = GEOMETRIES[geometry]
    n = int(rng.integers(cfg.min_masters, cfg.max_masters + 1))
    affine = geom.num_slices > 1 and geom.slice_policy == "region"

    masters: List[MasterSpec] = []
    for m in range(n):
        qos = str(rng.choice(("safety", "realtime", "besteffort"),
                             p=(0.25, 0.35, 0.40)))
        if qos == "besteffort" and rng.random() < 0.5:
            # bursty multi-tenant aggressor: full injection rate
            model, rate = str(rng.choice(_AGGRESSOR_MODELS)), 1.0
        else:
            model = str(rng.choice(_ALL_MODELS))
            rate = float(np.round(rng.uniform(0.2, 1.0), 2))
        txns = int(rng.integers(cfg.txns_lo, cfg.txns_hi + 1))
        if model in _SENSORS:
            # sensor health: nominal / degraded (slow, half stream) /
            # dropout (sensor dies after a handful of transactions)
            mode = rng.choice(("nominal", "degraded", "dropout"),
                              p=(0.75, 0.15, 0.10))
            if mode == "degraded":
                rate = max(float(np.round(rate * 0.25, 2)), 0.1)
                txns = max(txns // 2, cfg.txns_lo)
            elif mode == "dropout":
                txns = int(rng.integers(1, 5))
        deadline = None
        if qos in ("safety", "realtime") and rng.random() < 0.5:
            deadline = int(rng.integers(cfg.deadline_floor,
                                        2 * cfg.deadline_floor))
        affinity = (int(rng.integers(geom.num_slices))
                    if affine and rng.random() < 0.5 else None)
        masters.append(MasterSpec(
            model, qos=qos, rate=rate, txns=txns, seed=int(rng.integers(2**16)),
            params=_sample_model_params(rng, model), deadline=deadline,
            slice_affinity=affinity))

    if rng.random() < 0.4:            # randomized explicit region layout
        for spec, region in zip(masters, _sample_regions(rng, n,
                                                         geom.beats_total)):
            spec.region = region
            spec.slice_affinity = None

    planted = bool(rng.random() < cfg.plant_rate)
    knobs = {k: int(rng.choice(v)) for k, v in _KNOB_SPACE.items()}
    if geom.num_slices == 1:
        knobs["hop_latency"] = 0
        knobs["slice_ingress"] = 0
    if planted:
        # plant a guaranteed deadline violation: a safety master whose
        # deadline sits below the fabric's physical latency floor
        victim = masters[int(rng.integers(n))]
        victim.qos = "safety"
        victim.deadline = PLANTED_DEADLINE
        victim.txns = max(victim.txns, 4)
        knobs["qos_aging"] = max(knobs["qos_aging"], 64)

    params = SimParams(geom=geom, max_cycles=cfg.max_cycles,
                       stages=SCHEDULE_PIPELINE, collect="stream",
                       slots_override=FUZZ_SLOTS,
                       inflight_override=FUZZ_INFLIGHT, **knobs)
    scenario = Scenario(f"fuzz_{cfg.seed}_{index}", masters, geom,
                        f"fuzzed spec #{index} (seed {cfg.seed})")
    return FuzzCase(index, geometry, scenario, params, planted)


# ---------------------------------------------------------------------------
# JSON round-trip
# ---------------------------------------------------------------------------

_PARAM_JSON_FIELDS = DYN_FIELDS + ("max_cycles", "banking",
                                   "slots_override", "inflight_override")


def case_to_json(case: FuzzCase) -> Dict[str, object]:
    """A case as a plain-JSON dict (reproducer / corpus format, v1)."""
    masters = []
    for m in case.scenario.masters:
        if not isinstance(m.model, str):
            raise ValueError("only string traffic models serialize (got a "
                             f"{type(m.model).__name__} source)")
        masters.append({
            "model": m.model, "qos": m.qos, "rate": m.rate, "txns": m.txns,
            "region": list(m.region) if m.region is not None else None,
            "seed": m.seed, "params": m.params, "priority": m.priority,
            "deadline": m.deadline, "slice_affinity": m.slice_affinity,
            "share_group": m.share_group,
        })
    return {
        "format": 1,
        "index": case.index,
        "name": case.scenario.name,
        "description": case.scenario.description,
        "geometry_name": case.geometry,
        "geometry": asdict(case.scenario.geom),
        "masters": masters,
        "params": {f: getattr(case.params, f) for f in _PARAM_JSON_FIELDS},
        "planted": case.planted,
    }


def case_from_json(d: Dict[str, object]) -> FuzzCase:
    """Rebuild a case from :func:`case_to_json` output (spec JSON replay)."""
    if d.get("format") != 1:
        raise ValueError(f"unknown fuzz-spec format {d.get('format')!r}")
    geom = MemoryGeometry(**d["geometry"])
    masters = []
    for m in d["masters"]:
        m = dict(m)
        region = m.pop("region")
        masters.append(MasterSpec(
            region=tuple(region) if region is not None else None, **m))
    scenario = Scenario(str(d["name"]), masters, geom,
                        str(d.get("description", "")))
    p = dict(d["params"])
    params = SimParams(geom=geom, stages=SCHEDULE_PIPELINE, collect="stream",
                       **p)
    name = str(d.get("geometry_name", "custom"))
    if GEOMETRIES.get(name) != geom:
        name = "custom"
    return FuzzCase(int(d.get("index", -1)), name, scenario, params,
                    bool(d.get("planted", False)))


# ---------------------------------------------------------------------------
# batched evaluation
# ---------------------------------------------------------------------------

def needs_alone_run(case: FuzzCase) -> bool:
    """Isolation oracle applies: safety masters + best-effort interference +
    the QoS machinery (priority aging and the regulator) switched on."""
    qos = [m.qos for m in case.scenario.masters]
    return ("safety" in qos and "besteffort" in qos
            and case.params.qos_aging > 0 and case.params.reg_rate > 0)


def _alone_trace(trace: Trace, keep: np.ndarray) -> Trace:
    """The same padded trace with every non-kept master's bursts zeroed:
    the alone-run baseline rides the same batch as extra lanes."""
    return Trace(trace.is_write,
                 np.where(keep[:, None], trace.burst, 0).astype(np.int32),
                 trace.addr, trace.start, trace.prio)


def evaluate_cases(cases: Sequence[FuzzCase], cfg: FuzzConfig,
                   envelope: Optional[Tuple[int, int]] = None,
                   device=None) -> List[CaseResult]:
    """Evaluate cases in batched chunks on ``device`` (default: CUDA);
    returns one CaseResult per case.

    Cases are grouped by their static envelope (geometry etc.); each group
    becomes ONE ``simulate_batch`` call (chunked at ``cfg.chunk``), with
    isolation alone-runs appended as extra lanes of the same batch.
    ``envelope=(X, N)`` pads every trace at least that large, so repeated
    calls (fuzz blocks, shrinker candidates) run the shapes the reference
    runs and give its results bit for bit.
    """
    out: List[Optional[CaseResult]] = [None] * len(cases)
    groups: Dict[tuple, List[int]] = {}
    for i, c in enumerate(cases):
        groups.setdefault(c.params.static_key(), []).append(i)
    for idxs in groups.values():
        _evaluate_group([cases[i] for i in idxs], idxs, out, cfg, envelope,
                        device)
    return [r for r in out if r is not None]


def _evaluate_group(group: List[FuzzCase], idxs: List[int],
                    out: List[Optional[CaseResult]], cfg: FuzzConfig,
                    envelope: Optional[Tuple[int, int]], device) -> None:
    compiled = [c.scenario.compile() for c in group]
    X = max(c.trace.num_masters for c in compiled)
    N = max(c.trace.num_txns for c in compiled)
    if envelope is not None:
        X, N = max(X, envelope[0]), max(N, envelope[1])
    padded = [pad_trace(c.trace, X, N) for c in compiled]
    wrappers = [replace(c, trace=t) for c, t in zip(compiled, padded)]

    inputs, prms, lanes = [], [], []       # lanes: (case_pos, kind, wrapper)
    for pos, (case, wrap, trace) in enumerate(zip(group, wrappers, padded)):
        inputs.append(_padded_schedule(wrap, trace))
        prms.append(case.params)
        lanes.append((pos, "full", wrap))
        if needs_alone_run(case):
            keep = np.zeros(X, bool)
            keep[wrap.masters_of_class("safety")] = True
            alone = _alone_trace(trace, keep)
            inputs.append(_padded_schedule(wrap, alone))
            prms.append(case.params)
            lanes.append((pos, "alone", replace(wrap, trace=alone)))

    env = batch_envelope(prms)
    pinned = [replace(p, slots_override=env.slots_per_master,
                      inflight_override=env.inflight_slots) for p in prms]
    stacked = simulate_batch(inputs, pinned, chunk=cfg.chunk, device=device)

    results: Dict[int, SweepResult] = {}
    alones: Dict[int, SweepResult] = {}
    full_prm: Dict[int, SimParams] = {}
    full_wrap: Dict[int, CompiledScenario] = {}
    for lane, ((pos, kind, wrap), prm) in enumerate(zip(lanes, pinned)):
        metrics = {k: np.asarray(v)[lane] for k, v in stacked.items()}
        summary = summarize_compiled(wrap, prm, metrics)
        if kind == "full":
            results[pos], full_prm[pos], full_wrap[pos] = summary, prm, wrap
        else:
            alones[pos] = summary
    for pos, case in enumerate(group):
        res, alone = results[pos], alones.get(pos)
        ctx = PropertyContext(full_wrap[pos], full_prm[pos], res, alone,
                              cfg.bounds)
        out[idxs[pos]] = CaseResult(case, res, alone, check_properties(ctx))


# ---------------------------------------------------------------------------
# shrinking
# ---------------------------------------------------------------------------

def _still_violates(case: FuzzCase, oracle: str, cfg: FuzzConfig,
                    envelope: Tuple[int, int], device) -> bool:
    try:
        res = evaluate_cases([case], cfg, envelope=envelope, device=device)[0]
    except (ValueError, KeyError):
        return False                  # reduction produced an invalid spec
    return any(v.oracle == oracle for v in res.violations)


def _with_masters(case: FuzzCase, masters: List[MasterSpec]) -> FuzzCase:
    sc = case.scenario
    return replace(case, scenario=Scenario(sc.name, masters, sc.geom,
                                           sc.description))


def _geometry_candidate(case: FuzzCase) -> Optional[FuzzCase]:
    """Collapse to the smallest palette geometry (regions/affinities cleared
    so placement re-resolves, router knobs zeroed)."""
    if case.geometry == "small16":
        return None
    masters = [replace(m, region=None, slice_affinity=None)
               for m in case.scenario.masters]
    geom = GEOMETRIES["small16"]
    shrunk = _with_masters(case, masters)
    sc = shrunk.scenario
    return replace(shrunk, geometry="small16",
                   scenario=Scenario(sc.name, sc.masters, geom,
                                     sc.description),
                   params=replace(case.params, geom=geom, hop_latency=0,
                                  slice_ingress=0))


def shrink_case(case: FuzzCase, oracle: str, cfg: FuzzConfig,
                log: Optional[Callable[[str], None]] = None,
                envelope: Optional[Tuple[int, int]] = None,
                device=None) -> FuzzCase:
    """Greedy delta-debugging: smallest spec still violating ``oracle``.

    Reductions (each kept only if the violation survives re-evaluation):
    drop masters one at a time, halve per-master transaction counts, halve
    integer burst/window model parameters, collapse the geometry to the
    smallest palette entry, and neutralize dyn knobs.  Every candidate is
    evaluated padded to one fixed envelope (the original case's shape by
    default; pass the fuzz run's global envelope to judge candidates as the
    run judged the case).  Each candidate is one ``simulate_batch`` call on
    ``device`` (default: CUDA).
    """
    if envelope is None:
        envelope = (len(case.scenario.masters),
                    max(m.txns for m in case.scenario.masters))
    say = log or (lambda s: None)
    cur = case
    for rnd in range(cfg.shrink_rounds):
        progressed = False
        # 1. drop masters (highest index first: aggressors were appended)
        i = len(cur.scenario.masters) - 1
        while i >= 0 and len(cur.scenario.masters) > 1:
            cand = _with_masters(cur, [m for j, m in
                                       enumerate(cur.scenario.masters)
                                       if j != i])
            if _still_violates(cand, oracle, cfg, envelope, device):
                say(f"shrink: dropped master {i} "
                    f"({len(cand.scenario.masters)} left)")
                cur, progressed = cand, True
            i -= 1
        # 2. halve transaction counts (per master)
        for i, m in enumerate(cur.scenario.masters):
            while m.txns > 1:
                cand_m = replace(m, txns=max(m.txns // 2, 1))
                cand = _with_masters(cur, [cand_m if j == i else mm for j, mm
                                           in enumerate(cur.scenario.masters)])
                if not _still_violates(cand, oracle, cfg, envelope, device):
                    break
                say(f"shrink: master {i} txns -> {cand_m.txns}")
                cur, m, progressed = cand, cand_m, True
        # 3. halve integer model parameters (bursts, windows, tiles)
        for i, m in enumerate(cur.scenario.masters):
            for key, val in list(m.params.items()):
                if isinstance(val, bool) or not isinstance(val, int) \
                        or val <= 1:
                    continue
                cand_m = replace(m, params={**m.params, key: val // 2})
                cand = _with_masters(cur, [cand_m if j == i else mm for j, mm
                                           in enumerate(cur.scenario.masters)])
                if _still_violates(cand, oracle, cfg, envelope, device):
                    say(f"shrink: master {i} {key} -> {val // 2}")
                    cur, m, progressed = cand, cand_m, True
        # 4. collapse the geometry
        cand = _geometry_candidate(cur)
        if cand is not None and _still_violates(cand, oracle, cfg, envelope, device):
            say("shrink: geometry -> small16")
            cur, progressed = cand, True
        # 5. neutralize dyn knobs
        for knob, neutral in _NEUTRAL_KNOBS:
            if getattr(cur.params, knob) == neutral:
                continue
            cand = replace(cur, params=replace(cur.params, **{knob: neutral}))
            if _still_violates(cand, oracle, cfg, envelope, device):
                say(f"shrink: {knob} -> {neutral}")
                cur, progressed = cand, True
        if not progressed:
            break
    return cur


# ---------------------------------------------------------------------------
# the budgeted run
# ---------------------------------------------------------------------------

def run_fuzz(cfg: FuzzConfig, *, time_limit_s: Optional[float] = None,
             shrink: bool = True,
             log: Optional[Callable[[str], None]] = None,
             device=None) -> FuzzOutcome:
    """Generate + evaluate ``cfg.budget`` specs on ``device`` (default:
    CUDA); shrink any violations.

    ``time_limit_s`` bounds wall-clock between evaluation blocks: the run
    stops early (``truncated=True``) rather than overshooting a CI budget.
    Spec identity is index-based, so a truncated run evaluates a prefix of
    exactly the specs a full run would.
    """
    say = log or (lambda s: None)
    t0 = time.perf_counter()
    block = max(cfg.chunk, 16)
    violating: List[CaseResult] = []
    evaluated, truncated = 0, False
    envelope = (cfg.max_masters, cfg.txns_hi)
    while evaluated < cfg.budget:
        if time_limit_s is not None \
                and time.perf_counter() - t0 > time_limit_s:
            truncated = True
            say(f"fuzz: time limit hit after {evaluated}/{cfg.budget} specs")
            break
        n = min(block, cfg.budget - evaluated)
        cases = [sample_case(cfg, evaluated + i) for i in range(n)]
        for res in evaluate_cases(cases, cfg, envelope=envelope,
                                  device=device):
            if res.violations:
                violating.append(res)
        evaluated += n
        say(f"fuzz: {evaluated}/{cfg.budget} specs, "
            f"{len(violating)} violating")

    reproducers: List[Dict[str, object]] = []
    for res in violating[:cfg.shrink_limit]:
        worst = res.violations[0]
        shrunk = (shrink_case(res.case, worst.oracle, cfg, log=log,
                              envelope=envelope, device=device)
                  if shrink else res.case)
        # re-verify the minimized spec at the run's envelope
        final = evaluate_cases([shrunk], cfg, envelope=envelope,
                               device=device)[0]
        reproducers.append({
            "case": case_to_json(shrunk),
            "violation": worst.to_json(),
            "verdict": {"violated_oracles":
                        sorted({v.oracle for v in final.violations})},
            "original": {"index": res.case.index,
                         "masters": len(res.case.scenario.masters),
                         "violations": [v.to_json()
                                        for v in res.violations]},
            "shrunk": {"masters": len(shrunk.scenario.masters),
                       "txns": [m.txns for m in shrunk.scenario.masters]},
        })
    if len(violating) > cfg.shrink_limit:
        say(f"fuzz: shrunk only the first {cfg.shrink_limit} of "
            f"{len(violating)} violating cases")
    return FuzzOutcome(cfg, evaluated, violating, reproducers, truncated,
                       time.perf_counter() - t0)


def replay_case(case: FuzzCase, cfg: Optional[FuzzConfig] = None,
                device=None) -> CaseResult:
    """Evaluate one case (e.g. loaded from a reproducer JSON) standalone on
    ``device`` (default: CUDA)."""
    cfg = cfg or FuzzConfig(max_cycles=case.params.max_cycles)
    return evaluate_cases([case], cfg, device=device)[0]


def load_reproducer(path) -> Tuple[FuzzCase, Dict[str, object]]:
    """Read a reproducer JSON file -> (case, expected-verdict dict)."""
    d = json.loads(open(path).read())
    return case_from_json(d["case"]), d.get("verdict", {})
