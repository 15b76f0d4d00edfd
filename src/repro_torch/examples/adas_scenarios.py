"""Define a custom ADAS workload mix with the scenario DSL and sweep it; the
port's copy of ``examples/adas_scenarios.py``.

  PYTHONPATH=src python -m repro_torch.examples.adas_scenarios [--device cpu]

Builds an emergency-braking corner case — two safety-rated Radars and a
safety camera pinned to explicit low-address regions, an NPU re-running the
detection net at full tilt, CPUs logging — then sweeps it against the
``sensor_stress`` preset across outstanding-credit settings as lanes of one
batch and prints the per-QoS-class latency picture.
"""

from __future__ import annotations

import argparse
import json

from repro_torch.core.simulator import SimParams
from repro_torch.examples import device_arg
from repro_torch.scenarios import MasterSpec, Scenario, SweepPoint, run_sweep, sensor_stress

TXNS = 48


def emergency_braking(txns: int = TXNS) -> Scenario:
    quarter = 2**20 // 4  # beats_total / 4 — one sub-bank granule each
    masters = [
        MasterSpec("radar", qos="safety", rate=0.9, txns=txns, region=(0, quarter // 2)),
        MasterSpec("radar", qos="safety", rate=0.9, txns=txns, region=(quarter // 2, quarter)),
        MasterSpec("camera", qos="safety", rate=0.9, txns=txns, region=(quarter, 2 * quarter)),
        MasterSpec("npu", qos="realtime", rate=1.0, txns=txns),
        MasterSpec("cpu", qos="besteffort", rate=0.5, txns=txns),
        MasterSpec("cpu", qos="besteffort", rate=0.5, txns=txns, seed=1),
    ]
    return Scenario(
        "emergency_braking", masters, description="AEB corner case: safety sensors pinned low"
    )


def run(*, txns: int = TXNS, device=None) -> dict:
    """Each sweep point's summary (emergency braking and ``sensor_stress``
    at ``txns`` transactions a master, outstanding 1 and 8)."""
    scenarios = [emergency_braking(txns), sensor_stress(txns=txns)]
    grid = [(sc, o) for sc in scenarios for o in (1, 8)]
    points = [SweepPoint(sc, SimParams(outstanding=o, max_cycles=8000)) for sc, o in grid]
    return {"summaries": [r.summary() for r in run_sweep(points, batched=True, device=device)]}


def text(result: dict) -> str:
    return "".join(json.dumps(s, indent=1, default=str) + "\n" for s in result["summaries"])


def check(result: dict) -> None:
    """The script asserts nothing."""


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.examples.adas_scenarios")
    device_arg(ap)
    args = ap.parse_args(argv)
    result = run(device=args.device)
    print(text(result), end="")
    check(result)


if __name__ == "__main__":
    main()
