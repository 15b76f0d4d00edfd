"""Replayable reference data: the golden cases and the full-width sweep.

``golden_inputs.npz`` holds the ``urban_perception`` and ``highway_qos``
scenario traces (int32 columns ``<case>__<column>``), which the reference
builds with its scenario engine; ``random_uniform`` comes from the port's own
generator.  The expected outputs are ``tests/data/golden_single_slice.json``:
``"cases"`` for the three single points (:func:`golden_cases`) and ``"batch"``
for the two scenario points run as one batch (:func:`golden_batch`), compared
on ``GOLDEN_KEYS``.

``sweep_reference.json`` holds the reference's ``run_sweep`` results for every
preset scenario at ``SWEEP_TXNS`` transactions per master under each of
``SWEEP_OUTSTANDING`` (one batch, dense pipeline, exact collection), each
point as :func:`sweep_record` writes it; and the streaming runs' metrics, as
:func:`metrics_record` writes them: ``SCALE_LANES`` of the scale grid
(:func:`scale_grid_fields`), each run alone, and the time-skip batch
(``TIME_SKIP_*``).  ``tests/data/capture_torch_sweep.py`` makes it with the
reference package.
"""

from __future__ import annotations

import itertools
import json
from dataclasses import replace
from pathlib import Path

import numpy as np

from repro_torch.core.simulator import SimParams, Trace
from repro_torch.core.traffic import random_uniform, stack_traces

GOLDEN_INPUTS = Path(__file__).resolve().parent / "golden_inputs.npz"
SWEEP_REFERENCE = Path(__file__).resolve().parent / "sweep_reference.json"
TRACE_COLUMNS = ("is_write", "burst", "addr", "start", "prio")

#: metric keys the golden file pins
GOLDEN_KEYS = (
    "throughput",
    "read_throughput",
    "write_throughput",
    "throughput_busy",
    "read_throughput_busy",
    "write_throughput_busy",
    "busy_cycles",
    "read_lat_avg",
    "read_lat_max",
    "write_lat_avg",
    "write_lat_max",
    "all_done",
    "beats_done",
    "cycles",
    "complete_cycle",
    "accept_cycle",
)


def _stored_trace(arrays, name: str) -> Trace:
    return Trace(*(arrays[f"{name}__{col}"] for col in TRACE_COLUMNS))


def golden_cases():
    """(name, trace, params) of the golden cases, as the reference defines them."""
    with np.load(GOLDEN_INPUTS) as arrays:
        urban = _stored_trace(arrays, "urban_perception")
        highway = _stored_trace(arrays, "highway_qos")
    return [
        ("random_uniform", random_uniform(8, 40, burst=8, seed=3), SimParams(max_cycles=3000)),
        ("urban_perception", urban, SimParams(max_cycles=4000)),
        (
            "highway_qos",
            highway,
            SimParams(
                max_cycles=4000,
                outstanding=4,
                bank_occupancy=6,
                qos_aging=64,
                reg_rate=32,
                reg_burst=8,
            ),
        ),
    ]


def golden_batch():
    """(traces, params) of the golden ``"batch"`` entry: the two scenario
    cases padded to one shape and run as one batch at 4000 cycles."""
    cases = golden_cases()
    traces = stack_traces([cases[1][1], cases[2][1]])
    return traces, [replace(cases[1][2], max_cycles=4000), replace(cases[2][2], max_cycles=4000)]


#: the full-width sweep: every preset at this many transactions per master ...
SWEEP_TXNS = 256
#: ... under each of these outstanding-command credits
SWEEP_OUTSTANDING = (1, 8)
#: raw integer metrics kept per sweep point, beside its summary
SWEEP_INT_KEYS = (
    "cycles",
    "drained_cycle",
    "effective_cycles",
    "skipped_cycles",
    "beats_done",
    "busy_cycles",
    "txns_done_port",
    "slice_beats",
)
#: ``sim_rate`` keys that are host timings, not results
SWEEP_TIMING_KEYS = ("wall_s", "sim_cycles_per_sec", "effective_cycles_per_sec")


def sweep_record(result) -> dict:
    """One sweep point as ``sweep_reference.json`` keeps it: the summary
    without its host timings, and the raw integer metrics ``SWEEP_INT_KEYS``.
    Takes the reference's ``SweepResult`` and the port's alike."""
    summary = result.summary()
    summary["sim_rate"] = {
        k: v for k, v in summary["sim_rate"].items() if k not in SWEEP_TIMING_KEYS
    }
    summary["raw"] = {k: np.asarray(result.metrics[k]).tolist() for k in SWEEP_INT_KEYS}
    return json.loads(json.dumps(summary))


#: the scale grid's horizon: the smallest multiple of 1000 above 1.3 x its
#: slowest lane's drain (7951 cycles in the reference, every lane alike)
SCALE_MAX_CYCLES = 11_000
#: lanes of the scale grid whose metrics the reference keeps (each run alone)
SCALE_LANES = (0, 47)
#: the time-skip batch: ``random_bursty(**TIME_SKIP_TRAFFIC, seed=i)`` for
#: ``i < TIME_SKIP_LANES``, schedule pipeline, streaming percentiles
TIME_SKIP_TRAFFIC = dict(num_masters=16, num_txns=32, burst=8, gap=150)
TIME_SKIP_LANES = 8
TIME_SKIP_MAX_CYCLES = 6000


def scale_grid_fields() -> list:
    """``SimParams`` fields of the scale grid's 48 points, in lane order
    (outstanding x qos_aging x reg_rate x bank_occupancy), on the schedule
    pipeline's streaming collector; the caller adds its package's
    ``stages=SCHEDULE_PIPELINE``.  One ``urban_perception`` schedule (256
    transactions per master) is shared by every point."""
    return [
        dict(
            outstanding=o,
            qos_aging=a,
            reg_rate=r,
            bank_occupancy=b,
            max_cycles=SCALE_MAX_CYCLES,
            collect="stream",
        )
        for o, a, r, b in itertools.product((2, 4, 8, 16), (0, 128), (0, 128), (1, 2, 3))
    ]


def metrics_record(metrics: dict) -> dict:
    """A metrics dict (one lane or a batch) as nested lists, NaN kept."""
    return {k: np.asarray(v).tolist() for k, v in metrics.items()}


def sweep_reference() -> dict:
    """``sweep_reference.json``: ``max_cycles``, the capture's slowest
    ``drained_cycle`` and one :func:`sweep_record` per point, scenario-major
    in ``preset_scenarios`` order, then ``SWEEP_OUTSTANDING`` order;
    ``scale_lanes`` (one :func:`metrics_record` per ``SCALE_LANES`` entry,
    keyed by its index) and ``time_skip`` (the batch's)."""
    return json.loads(SWEEP_REFERENCE.read_text())
