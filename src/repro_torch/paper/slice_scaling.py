"""Multi-slice scaling: the paper's §IV claim that tiling several memory
instances behind an interconnect "enables the scalability and modularity of
the design", made measurable; the port's copy of the reference's
``benchmarks/slice_scaling.py``.

For S in {1, 2, 4} slices the ``slice_scaling`` preset runs once per
placement on an S-slice fabric whose banks are deliberately slow
(``bank_occupancy`` well above the paper's nominal 2), so the banks, not the
port buses, are the bottleneck and the slice count is the capacity knob:

  * ``local``  every master's working set pinned to its home slice: zero
               router crossings, aggregate throughput scales with S (the
               headline assertion: >= 1.8x going 1 -> 2 slices)
  * ``remote`` each port group's placement rotated one slice over: every
               beat pays ``hop_latency`` ring hops and competes for
               ``slice_ingress`` credits, which shows in the realtime
               streamers' end-to-end p99 and the aggregate throughput; the
               safety Radar, each group's lowest-indexed port, is shielded by
               the in-order ingress queue (``remote_p99_delta_safety``)

Each slice count is one batch over both placements (the geometry is static
per S, so local and remote share one envelope).

  PYTHONPATH=src python -m repro_torch.paper --only slice_scaling
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from repro_torch.core.simulator import SimParams
from repro_torch.scenarios import SweepPoint, run_sweep, slice_scaling

#: aggregate-throughput scaling floor the 1 -> 2 slice step must clear
#: under slice-local placement (acceptance criterion)
SCALING_FLOOR = 1.8


def _aggregate_tput(metrics: Dict[str, np.ndarray]) -> float:
    """Fabric-level beats/cycle: every completed transaction's beats over the
    wall span from first acceptance to last completion.  (Per-port views
    saturate at 1 beat/cycle on the port buses; the aggregate view is the
    one slice count scales.)"""
    acc = np.asarray(metrics["accept_cycle"])
    com = np.asarray(metrics["complete_cycle"])
    done = (com >= 0) & (acc >= 0)
    # slice_beats counts every granted beat (beats_done sees only the read
    # return bus; writes complete at grant)
    beats = int(np.asarray(metrics["slice_beats"]).sum())
    if not done.any() or beats == 0:
        return 0.0
    span = int(com[done].max()) - int(acc[done].min())
    return beats / max(span, 1)


def _e2e_p99(per_class: Dict[str, Dict[str, float]], cls: str) -> float:
    """Worst end-to-end p99 for a class (earliest issue to completion: the
    view that charges router-ingress stalls at the port)."""
    s = per_class[cls]
    return float(max(v for v in (s["read_e2e_lat_p99"], s["write_e2e_lat_p99"]) if not np.isnan(v)))


def slice_scaling_bench(
    *,
    txns: int = 96,
    max_cycles: int = 12_000,
    bank_occupancy: int = 48,
    hop_latency: int = 8,
    slice_ingress: int = 32,
    slice_counts=(1, 2, 4),
    device=None,
) -> Dict:
    """Aggregate throughput + safety p99 vs slice count, local vs remote, on
    ``device`` (default: the CUDA card)."""
    rows: Dict[str, Dict] = {}
    for s in slice_counts:
        placements = ("local",) if s == 1 else ("local", "remote")
        scs = [slice_scaling(s, txns=txns, remote=(p == "remote")) for p in placements]
        prm = SimParams(
            geom=scs[0].geom,
            max_cycles=max_cycles,
            bank_occupancy=bank_occupancy,
            hop_latency=hop_latency,
            slice_ingress=slice_ingress,
        )
        results = run_sweep([SweepPoint(sc, prm) for sc in scs], device=device)
        for p, r in zip(placements, results):
            assert bool(r.metrics["all_done"]), (r.name, "did not drain")
            rows[f"s{s}_{p}"] = {
                "scenario": r.name,
                "aggregate_tput": round(_aggregate_tput(r.metrics), 4),
                "safety_read_p99": r.per_class["safety"]["read_lat_p99"],
                "safety_e2e_p99": _e2e_p99(r.per_class, "safety"),
                "realtime_e2e_p99": _e2e_p99(r.per_class, "realtime"),
                "deadline_misses": r.per_class["safety"]["deadline_misses"],
                "crossing_fraction": r.slices["crossing_fraction"],
                "slice_occupancy": [round(x, 4) for x in r.slices["slice_occupancy"]],
                "remote_beat_fraction": float(r.metrics["remote_beat_fraction"]),
            }

    t1 = rows["s1_local"]["aggregate_tput"]
    scaling = {f"x{s}": round(rows[f"s{s}_local"]["aggregate_tput"] / t1, 3) for s in slice_counts}
    multi = [s for s in slice_counts if s > 1]

    def remote_minus_local(s: int, key: str) -> float:
        return rows[f"s{s}_remote"][key] - rows[f"s{s}_local"][key]

    def tput_ratio(s: int) -> float:
        return rows[f"s{s}_remote"]["aggregate_tput"] / rows[f"s{s}_local"]["aggregate_tput"]

    out = {
        "headline": {
            "local_scaling_vs_1_slice": scaling,
            "scaling_floor_1_to_2": SCALING_FLOOR,
            # the ingress queue admits in port order and each group's safety
            # Radar is its lowest-indexed port, so the router's queueing
            # penalty lands on the higher-indexed realtime streamers; safety
            # stays protected (reported, not asserted)
            "remote_p99_penalty_realtime": {
                f"x{s}": round(remote_minus_local(s, "realtime_e2e_p99"), 1) for s in multi
            },
            "remote_p99_delta_safety": {
                f"x{s}": round(remote_minus_local(s, "safety_e2e_p99"), 1) for s in multi
            },
            "remote_tput_penalty": {f"x{s}": round(1.0 - tput_ratio(s), 3) for s in multi},
        },
        "params": {
            "txns": txns,
            "max_cycles": max_cycles,
            "bank_occupancy": bank_occupancy,
            "hop_latency": hop_latency,
            "slice_ingress": slice_ingress,
        },
        "rows": rows,
    }
    h = out["headline"]
    if 2 in slice_counts:
        # the scalability claim: tiling a second slice nearly doubles the
        # bank-bound fabric's aggregate throughput under local placement ...
        assert scaling["x2"] >= SCALING_FLOOR, h
        # ... while remote placement pays the router: higher realtime e2e
        # p99 (hop latency + ingress queueing) and ingress-capped aggregate
        # throughput
        assert rows["s2_remote"]["realtime_e2e_p99"] > rows["s2_local"]["realtime_e2e_p99"], h
        assert rows["s2_remote"]["aggregate_tput"] < rows["s2_local"]["aggregate_tput"], h
    return out
