"""The paper's core experiment, directly: sweep parallel masters over the
banked shared memory and print per-port throughput/latency (Fig. 4), plus a
comparator showing why the split+fractal dispatch matters.  The port's copy
of ``examples/memory_sim_sweep.py``.

  PYTHONPATH=src python -m repro_torch.examples.memory_sim_sweep [--device cpu]
"""

from __future__ import annotations

import argparse

from repro_torch.core.simulator import SimParams, simulate
from repro_torch.core.traffic import bulk_linear, random_uniform
from repro_torch.examples import device_arg

BANKINGS = ("paper", "no_fractal", "linear")


def run(*, masters=(1, 2, 4, 8, 16), txns: int = 200, bulk_kb: int = 64, device=None) -> dict:
    """Fig. 4's rows (``random_uniform(X, txns)``, full duplex) and each
    banking's read throughput over 16 bulk streams of ``bulk_kb`` KB."""
    rows = []
    for X in masters:
        tr = random_uniform(X, txns, burst=16, full_duplex=True)
        m = simulate(tr, SimParams(max_cycles=6000), device=device)
        rows.append(
            {
                "masters": X,
                "read_throughput": m["read_throughput"][:X].mean(),
                "write_throughput": m["write_throughput"][X:].mean(),
                "read_lat": m["read_lat_avg"][:X].mean(),
                "write_lat": m["write_lat_avg"][X:].mean(),
            }
        )
    banking = {}
    for name in BANKINGS:
        tr = bulk_linear(16, bulk_kb * 1024, burst=16)
        m = simulate(tr, SimParams(banking=name, max_cycles=12_000), device=device)
        banking[name] = m["read_throughput"].mean()
    return {"fig4": rows, "banking": banking}


def text(result: dict) -> str:
    lines = ["masters read_throughput write_throughput read_lat write_lat   (Fig. 4)"]
    for r in result["fig4"]:
        lines.append(
            f"{r['masters']:7d} {r['read_throughput']:9.3f} "
            f"{r['write_throughput']:10.3f} "
            f"{r['read_lat']:8.1f} "
            f"{r['write_lat']:9.1f}"
        )
    lines.append("\nbanking comparator (bulk streams, §II-A):")
    for name, tput in result["banking"].items():
        lines.append(f"  {name:12s} read_throughput={tput:.3f}")
    return "\n".join(lines) + "\n"


def check(result: dict) -> None:
    """The script asserts nothing."""


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.examples.memory_sim_sweep")
    device_arg(ap)
    args = ap.parse_args(argv)
    result = run(device=args.device)
    print(text(result), end="")
    check(result)


if __name__ == "__main__":
    main()
