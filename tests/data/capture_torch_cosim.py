"""Regenerate src/repro_torch/data/cosim_reference.json with the reference.

The PyTorch port's serving co-sim and fuzzer (``chip_smoke.py``, phases
``cosim``, ``cosim_scale`` and ``fuzz``) are held to this file, made with the
JAX package on the CPU at the sizes the card runs:

  * ``grid``: every group of the co-sim grid (``COSIM_GRID``, the reference
    benchmark's defaults, its asserts included): the record's summary, the
    trace's shape, and each configuration's summary and gather stats;
  * ``scale``: the scale mode (``COSIM_SCALE``, 1024 requests, time skip on):
    its summary and metrics; and at ``COSIM_SCALE_FIXED_REQUESTS`` requests
    the time-skip and the fixed-horizon legs' metrics;
  * ``fuzz``: the clean-tree job (``FUZZ_JOB``) case by case (spec,
    violations, summaries) with its summary, and the planted find
    (``FUZZ_PLANTED``) with its shrunk reproducer.

Run from the repo root (about six minutes on one CPU):

  PYTHONPATH=src:. python tests/data/capture_torch_cosim.py
"""

from __future__ import annotations

import json
from contextlib import contextmanager
from dataclasses import replace

from benchmarks.serving_cosim import serving_cosim
from repro.core.simulator import SCHEDULE_PIPELINE, SimParams, carry_nbytes, simulate
from repro.scenarios import fuzz, record_serving_run, serving_scenario
from repro_torch.data import (
    COSIM_GRID,
    COSIM_REFERENCE,
    COSIM_SCALE,
    COSIM_SCALE_FIXED_REQUESTS,
    FUZZ_JOB,
    FUZZ_PLANTED,
    case_record,
    cosim_scale_params,
    metrics_record,
    scale_summary,
)


def grid() -> dict:
    cfg = dict(COSIM_GRID)
    out = serving_cosim(**cfg)  # the reference's asserts hold
    shape = {k: cfg[k] for k in ("num_requests", "prompt_lo", "prompt_hi", "max_new_tokens")}
    groups = {}
    for name, g in out["groups"].items():
        b, s = (int(x) for x in name.replace("batch", "").split("_slices"))
        rec = record_serving_run(
            max_batch=b, max_len=cfg["prompt_hi"] + cfg["max_new_tokens"] + 16, seed=cfg["seed"],
            **shape,
        )
        assert rec.summary() == g["record"], name
        comp = serving_scenario(rec, cycles_per_step=cfg["cycles_per_step"]).compile()
        groups[name] = {
            "record": g["record"],
            "trace_shape": list(comp.trace.burst.shape),
            "rows": g["rows"],
            "gathers": g["gathers"],
        }
    return groups


def scale_setup(n: int):
    cfg = {k: v for k, v in COSIM_SCALE.items() if k not in ("cycles_per_step", "bank_occupancy")}
    cfg["num_requests"] = n
    cps = COSIM_SCALE["cycles_per_step"]
    rec = record_serving_run(
        **cfg, max_len=cfg["prompt_hi"] + cfg["max_new_tokens"] + 16, max_steps=None
    )
    comp = serving_scenario(rec, cycles_per_step=cps, decode_deadline=4 * cps).compile()
    return rec, comp, SimParams(**cosim_scale_params(rec, SCHEDULE_PIPELINE))


def scale() -> dict:
    rec, comp, prm = scale_setup(COSIM_SCALE["num_requests"])
    res = comp.simulate(prm)
    m = res.metrics
    assert bool(m["all_done"]) and res.per_class["realtime"]["deadline_txns"] > 0
    carry = carry_nbytes(prm, comp.trace.num_masters, comp.trace.num_txns)
    summary = scale_summary(rec, comp, prm, res, carry)
    rec, comp, prm = scale_setup(COSIM_SCALE_FIXED_REQUESTS)
    sched = comp.schedule()
    legs = {
        "skip": metrics_record(simulate(sched, prm)),
        "fixed": metrics_record(simulate(sched, replace(prm, early_exit=False, time_skip=False))),
    }
    return {
        "summary": summary,
        "metrics": metrics_record(m),
        f"legs{COSIM_SCALE_FIXED_REQUESTS}": legs,
        f"legs{COSIM_SCALE_FIXED_REQUESTS}_shape": {
            "engine_steps": rec.steps,
            "trace_shape": list(comp.trace.burst.shape),
            "max_cycles": prm.max_cycles,
        },
    }


@contextmanager
def recorded_cases():
    """Every case ``run_fuzz`` evaluates, in order."""
    results, inner = [], fuzz.evaluate_cases

    def evaluate(*args, **kwargs):
        out = inner(*args, **kwargs)
        results.extend(out)
        return out

    fuzz.evaluate_cases = evaluate
    try:
        yield results
    finally:
        fuzz.evaluate_cases = inner


def fuzz_runs() -> dict:
    with recorded_cases() as results:
        outcome = fuzz.run_fuzz(fuzz.FuzzConfig(**FUZZ_JOB))
    summary = outcome.summary()
    job = {
        "cases": [case_record(r, fuzz.case_to_json(r.case)) for r in results],
        "summary": {k: summary[k] for k in ("evaluated", "violations", "violated_oracles")},
    }
    planted = fuzz.run_fuzz(fuzz.FuzzConfig(**FUZZ_PLANTED))
    assert planted.violating, "the planted violation was not found"
    return {"job": job, "planted": {"reproducers": planted.reproducers}}


def main() -> None:
    out = {"grid": grid(), "scale": scale(), "fuzz": fuzz_runs()}
    COSIM_REFERENCE.write_text(json.dumps(out, indent=1) + "\n")
    s, f = out["scale"]["summary"], out["fuzz"]["job"]["summary"]
    print(
        f"wrote {COSIM_REFERENCE}: scale effective {s['effective_cycles']}, skipped "
        f"{s['skipped_cycles']}; fuzz {f}"
    )


if __name__ == "__main__":
    main()
