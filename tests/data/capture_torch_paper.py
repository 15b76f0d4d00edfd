"""Regenerate src/repro_torch/data/paper_reference.json with the reference.

The PyTorch port's paper jobs (``repro_torch.paper``; ``chip_smoke.py``,
phase ``paper_jobs``) are held to this file, made with the JAX package on
the CPU: the reference's own functions from ``benchmarks/`` at the
arguments ``benchmarks/run.py`` passes them (``PAPER_JOBS``), their asserts
included.  For each job it keeps the arguments, the returned dict
(``paper_record``) and the drained cycle of every lane of every simulator
call the job makes, in call order (``drains``; the reference steps each run
to its horizon, the port stops at the drain).

Run from the repo root (about two minutes on one CPU):

  PYTHONPATH=src:. python tests/data/capture_torch_paper.py
"""

from __future__ import annotations

import contextlib
import json
import sys

import numpy as np

import repro.core.simulator as ref_sim
from benchmarks import paper_figures as F
from benchmarks.qos_isolation import qos_isolation_sweep
from benchmarks.slice_scaling import slice_scaling_bench
from repro_torch.data import PAPER_JOBS, PAPER_REFERENCE, paper_record

#: the reference's function of each job of ``PAPER_JOBS``
REFERENCE_JOBS = {
    "fig5_bulk": F.fig5_bulk,
    "fig67_traces": F.fig67_traces,
    "comparators": F.comparators,
    "qos_isolation": F.qos_isolation,
    "pool_balance": F.pool_balance,
    "qos_isolation_sweep": qos_isolation_sweep,
    "slice_scaling": slice_scaling_bench,
}


@contextlib.contextmanager
def logged_drains():
    """While active, every call of the reference's ``simulate`` and
    ``simulate_batch`` (under every name a loaded module of ``repro`` or
    ``benchmarks`` holds them by) appends its lanes' drained cycles to the
    yielded list; a call made inside another is not logged again."""
    drains, depth = [], [0]
    originals = {name: getattr(ref_sim, name) for name in ("simulate", "simulate_batch")}

    def logged(inner):
        def run(*args, **kwargs):
            depth[0] += 1
            try:
                out = inner(*args, **kwargs)
            finally:
                depth[0] -= 1
            if depth[0] == 0:
                drains.extend(np.asarray(out["drained_cycle"]).reshape(-1).tolist())
            return out

        return run

    patched = []
    for mod in list(sys.modules.values()):
        if mod is None or not mod.__name__.startswith(("repro.", "benchmarks.")):
            continue
        for name, fn in originals.items():
            if getattr(mod, name, None) is fn:
                patched.append((mod, name, fn))
                setattr(mod, name, logged(fn))
    try:
        yield drains
    finally:
        for mod, name, fn in patched:
            setattr(mod, name, fn)


def capture() -> dict:
    """``{"source", "jobs": {name: {"args", "result", "drains"}}}`` for
    ``PAPER_JOBS``, each run by the reference."""
    out = {}
    for name, args in PAPER_JOBS.items():
        with logged_drains() as drains:
            result = REFERENCE_JOBS[name](**args)
        out[name] = {"args": paper_record(args), "result": paper_record(result), "drains": drains}
    return {"source": "benchmarks/run.py's jobs, without --full", "jobs": out}


def main() -> None:
    ref = capture()
    PAPER_REFERENCE.write_text(json.dumps(ref, indent=1) + "\n")
    print(f"wrote {PAPER_REFERENCE}")
    for name, job in ref["jobs"].items():
        print(f"  {name}: {len(job['drains'])} lanes, drains {job['drains']}")


if __name__ == "__main__":
    main()
