"""Demonstrate the multi-slice fabric: tiling, placement, and the router; the
port's copy of ``examples/slice_scaling.py``.

  PYTHONPATH=src python -m repro_torch.examples.slice_scaling [--device cpu]

Builds the ``slice_scaling`` preset on a 2-slice region-affine fabric twice —
working sets pinned slice-local, then rotated one slice over — and runs both
placements as lanes of one batch (the geometry is shared, and the router
knobs ``hop_latency`` / ``slice_ingress`` travel in each lane's dyn vector).
Prints the sweep's slice report (crossing fraction, per-slice occupancy) and
the safety-class end-to-end latency picture, showing what remote placement
costs.
"""

from __future__ import annotations

import argparse
import json

from repro_torch.core.simulator import SimParams
from repro_torch.examples import device_arg
from repro_torch.scenarios import SweepPoint, run_sweep, slice_scaling

TXNS = 48
SLOW_SRAM = dict(
    max_cycles=10_000,
    bank_occupancy=48,  # bank-bound corner
    hop_latency=8,
    slice_ingress=32,
)


def run(*, txns: int = TXNS, device=None) -> dict:
    """Each placement's name and its slice report and safety numbers
    (``txns`` transactions a master)."""
    local = slice_scaling(2, txns=txns)
    remote = slice_scaling(2, txns=txns, remote=True)
    prm = SimParams(geom=local.geom, **SLOW_SRAM)
    rows = []
    for r in run_sweep([SweepPoint(local, prm), SweepPoint(remote, prm)], device=device):
        safety = r.per_class["safety"]
        row = {
            "slices": r.slices,
            "safety_write_e2e_p99": safety["write_e2e_lat_p99"],
            "safety_deadline_misses": safety["deadline_misses"],
            "remote_beat_fraction": float(r.metrics["remote_beat_fraction"]),
        }
        rows.append((r.name, row))
    return {"placements": rows}


def text(result: dict) -> str:
    return "".join(
        f"--- {name}\n" + json.dumps(row, indent=1, default=str) + "\n"
        for name, row in result["placements"]
    )


def check(result: dict) -> None:
    """The script asserts nothing."""


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.examples.slice_scaling")
    device_arg(ap)
    args = ap.parse_args(argv)
    result = run(device=args.device)
    print(text(result), end="")
    check(result)


if __name__ == "__main__":
    main()
