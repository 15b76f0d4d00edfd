"""The three golden single-slice cases, replayable without the reference.

``golden_inputs.npz`` holds the ``urban_perception`` and ``highway_qos``
scenario traces (int32 columns ``<case>__<column>``), which the reference
builds with its scenario engine; ``random_uniform`` comes from the port's own
generator.  The expected outputs are ``tests/data/golden_single_slice.json``
(``"cases"``), compared on ``GOLDEN_KEYS``.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from repro_torch.core.simulator import SimParams, Trace
from repro_torch.core.traffic import random_uniform

GOLDEN_INPUTS = Path(__file__).resolve().parent / "golden_inputs.npz"
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
