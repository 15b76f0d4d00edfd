"""Regenerate src/repro_torch/data/sweep_reference.json with the reference.

The PyTorch port's full-width sweep (``chip_smoke.py``, phase ``sweep``) is
held to this file: every preset scenario at ``SWEEP_TXNS`` transactions per
master under each of ``SWEEP_OUTSTANDING`` credits, one batched
``run_sweep`` on the dense pipeline with exact collection.  ``max_cycles`` is
the smallest multiple of 1000 above 1.3 times the slowest point's
``drained_cycle`` in a first pass at a generous horizon.  Beside it the
streaming runs that ``chip_smoke.py`` holds to the reference: lanes
``SCALE_LANES`` of the scale grid, each run alone at the grid's envelope, and
the time-skip batch.  Run from the repo root (a few minutes on one CPU):

  PYTHONPATH=src python tests/data/capture_torch_sweep.py
"""

from __future__ import annotations

import json
from dataclasses import replace

from repro.core.simulator import (
    SCHEDULE_PIPELINE,
    SimParams,
    batch_envelope,
    simulate,
    simulate_batch,
)
from repro.core.traffic import random_bursty
from repro.scenarios import SweepPoint, preset_scenarios, run_sweep, urban_perception
from repro_torch.data import (
    SCALE_LANES,
    SWEEP_OUTSTANDING,
    SWEEP_REFERENCE,
    SWEEP_TXNS,
    TIME_SKIP_LANES,
    TIME_SKIP_MAX_CYCLES,
    TIME_SKIP_TRAFFIC,
    metrics_record,
    scale_grid_fields,
    sweep_record,
)

#: horizon of the first pass, which only finds the slowest drain
PROBE_CYCLES = 100_000


def sweep_points(max_cycles: int):
    return [
        SweepPoint(sc, SimParams(outstanding=o, max_cycles=max_cycles))
        for sc in preset_scenarios(SWEEP_TXNS)
        for o in SWEEP_OUTSTANDING
    ]


def stream_runs() -> dict:
    """The scale grid's ``SCALE_LANES``, each alone, and the time-skip batch."""
    sched = urban_perception().compile().schedule()
    grid = [SimParams(stages=SCHEDULE_PIPELINE, **f) for f in scale_grid_fields()]
    env = batch_envelope(grid)
    pin = dict(slots_override=env.slots_per_master, inflight_override=env.inflight_slots)
    lanes = {str(i): metrics_record(simulate(sched, replace(grid[i], **pin))) for i in SCALE_LANES}
    bursty = [random_bursty(**TIME_SKIP_TRAFFIC, seed=i) for i in range(TIME_SKIP_LANES)]
    prm = SimParams(max_cycles=TIME_SKIP_MAX_CYCLES, stages=SCHEDULE_PIPELINE, collect="stream")
    skip = metrics_record(simulate_batch(bursty, [prm] * TIME_SKIP_LANES))
    return {"scale_lanes": lanes, "time_skip": skip}


def main() -> None:
    probe = run_sweep(sweep_points(PROBE_CYCLES))
    drained = [int(r.metrics["drained_cycle"]) for r in probe]
    if min(drained) < 0:
        raise SystemExit(f"a point did not drain in {PROBE_CYCLES} cycles: {drained}")
    slowest = max(drained)
    max_cycles = (int(1.3 * slowest) // 1000 + 1) * 1000
    results = run_sweep(sweep_points(max_cycles))
    out = {
        "txns": SWEEP_TXNS,
        "outstanding": list(SWEEP_OUTSTANDING),
        "max_cycles": max_cycles,
        "slowest_drained_cycle": slowest,
        "points": [sweep_record(r) for r in results],
        **stream_runs(),
    }
    SWEEP_REFERENCE.write_text(json.dumps(out, indent=1) + "\n")
    print(f"wrote {SWEEP_REFERENCE}: max_cycles {max_cycles}, drained {drained}")


if __name__ == "__main__":
    main()
