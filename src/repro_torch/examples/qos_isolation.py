"""Demonstrate the QoS machinery: priority arbitration, aging, regulator; the
port's copy of ``examples/qos_isolation.py``.

  PYTHONPATH=src python -m repro_torch.examples.qos_isolation [--device cpu]

Runs the ``qos_isolation`` preset (2 safety Radars with deadlines + 1
realtime NPU vs 13 saturating best-effort aggressors) through a grid that
toggles the QoS knobs — all points as lanes of one batch, since
``qos_aging`` / ``reg_rate`` / ``reg_burst`` travel in each lane's dyn
vector — and prints the per-class latency/deadline picture, then the
victim-vs-aggressors ``interference_report`` (itself one batch of two lanes).
"""

from __future__ import annotations

import argparse
import json

from repro_torch.core.qos import interference_report
from repro_torch.core.simulator import SimParams, Trace
from repro_torch.examples import device_arg
from repro_torch.scenarios import SweepPoint, qos_isolation, run_sweep

TXNS = 48
SLOW_SRAM = dict(bank_occupancy=12, max_cycles=8000)  # congested corner
LABELS = ("priority+regulator", "priority only", "no aging (starvation risk)")


def run(*, txns: int = TXNS, device=None) -> dict:
    """Each QoS point's safety and best-effort numbers, and the safety
    Radar's ``interference_report`` (``txns`` transactions a master)."""
    sc = qos_isolation(txns=txns)
    points = [
        SweepPoint(sc, SimParams(**SLOW_SRAM, reg_rate=64, reg_burst=32)),
        SweepPoint(sc, SimParams(**SLOW_SRAM)),  # regulator off
        SweepPoint(sc, SimParams(**SLOW_SRAM, qos_aging=0)),  # pure priority
    ]
    rows = {}
    for label, r in zip(LABELS, run_sweep(points, batched=True, device=device)):
        safety = r.per_class["safety"]
        best = r.per_class["besteffort"]
        rows[label] = {
            "safety_read_p99": safety["read_lat_p99"],
            "safety_deadline_misses": safety["deadline_misses"],
            "besteffort_done": f"{best['txns_done']}/{best['txns_total']}",
            "besteffort_read_throughput": best["read_throughput"],
        }

    # victim-alone vs victim-under-load, one batched call
    full = sc.compile().trace
    victim = Trace(
        full.is_write[:1],
        full.burst[:1],
        full.addr[:1],
        None if full.start is None else full.start[:1],
        None if full.prio is None else full.prio[:1],
    )
    rep = interference_report(victim, full, SimParams(**SLOW_SRAM, reg_rate=64), device=device)
    return {"points": rows, "interference_report": rep}


def text(result: dict) -> str:
    out = ""
    for label, row in result["points"].items():
        out += f"--- {label}\n" + json.dumps(row, indent=1, default=str) + "\n"
    out += "--- interference_report (safety Radar row 0)\n"
    return out + json.dumps(result["interference_report"], indent=1) + "\n"


def check(result: dict) -> None:
    """The script asserts nothing."""


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.examples.qos_isolation")
    device_arg(ap)
    args = ap.parse_args(argv)
    result = run(device=args.device)
    print(text(result), end="")
    check(result)


if __name__ == "__main__":
    main()
