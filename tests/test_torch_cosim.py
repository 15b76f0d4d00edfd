"""The serving co-sim on the port against the JAX package: one small group of
the co-sim grid on the CPU (three lanes of one dense batch: decode alone, QoS
on, QoS off) against the reference benchmark's group, summaries and gather
stats alike (tolerance 0, floats included); and the sizes that
``src/repro_torch/data/cosim_reference.json`` recorded against what the port
computes now, so that a stale capture fails here and not first on the card."""

import json
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import chip_smoke  # noqa: E402
from benchmarks.serving_cosim import _one_group  # noqa: E402
from repro_torch.core.simulator import carry_nbytes  # noqa: E402
from repro_torch.data import (  # noqa: E402
    COSIM_GRID,
    COSIM_SCALE,
    COSIM_SCALE_FIXED_REQUESTS,
    cosim_reference,
)
from repro_torch.scenarios import record_serving_run, serving_scenario  # noqa: E402

#: the grid's shapes and knobs at batch 2, 1 slice, 4 of its 24 requests
SMALL_GROUP = dict(
    max_batch=2,
    num_slices=1,
    num_requests=4,
    **{k: COSIM_GRID[k] for k in ("prompt_lo", "prompt_hi", "max_new_tokens", "cycles_per_step",
                                  "bank_occupancy", "reg_rate", "reg_burst", "seed")},
)


def _same(got, want):
    mismatches, float_diff = chip_smoke._diff_records(
        json.loads(json.dumps(got)), json.loads(json.dumps(want))
    )
    assert not mismatches, mismatches[:5]
    assert float_diff == 0.0


def test_cosim_group_matches_reference():
    torch.set_num_threads(1)
    ours = chip_smoke.cosim_group(**SMALL_GROUP, device="cpu")
    ref = _one_group(**SMALL_GROUP, max_cycles=None)
    _same({k: ours[k] for k in ("record", "rows", "gathers")},
          {k: ref[k] for k in ("record", "rows", "gathers")})
    for cfg in chip_smoke.COSIM_CONFIGS:
        assert ours["gathers"][cfg]["gather_lat_p99"] == ref["decode_gather_p99"][cfg]
    assert ours["gathers"]["alone"]["gathers"] > 0
    assert ours["trace_shape"][0] == SMALL_GROUP["max_batch"] + 2  # decode slots + prefill ports


def _grid_record(max_batch):
    g = COSIM_GRID
    return record_serving_run(
        num_requests=g["num_requests"],
        max_batch=max_batch,
        max_len=g["prompt_hi"] + g["max_new_tokens"] + 16,
        **{k: g[k] for k in ("prompt_lo", "prompt_hi", "max_new_tokens", "seed")},
    )


def test_capture_sizes_match_the_port():
    ref = cosim_reference()
    for name, group in ref["grid"].items():
        rec = _grid_record(int(name.replace("batch", "").split("_slices")[0]))
        assert rec.summary() == group["record"], name
        comp = serving_scenario(rec, cycles_per_step=COSIM_GRID["cycles_per_step"]).compile()
        assert list(comp.trace.burst.shape) == group["trace_shape"], name
    legs = ref["scale"][f"legs{COSIM_SCALE_FIXED_REQUESTS}_shape"]
    for n, want in ((COSIM_SCALE_FIXED_REQUESTS, legs),
                    (COSIM_SCALE["num_requests"], ref["scale"]["summary"])):
        rec, comp, prm = chip_smoke.cosim_scale_setup(n)
        assert rec.steps == want["engine_steps"]
        assert list(comp.trace.burst.shape) == want["trace_shape"]
        assert prm.max_cycles == want["max_cycles"]
    summary, sched = ref["scale"]["summary"], comp.schedule()
    assert (sched.num_txns, sched.nbytes) == (summary["schedule_txns"], summary["schedule_bytes"])
    assert carry_nbytes(prm, *comp.trace.burst.shape) == summary["carry_bytes"]
    assert (summary["effective_cycles"], summary["skipped_cycles"]) == (28510, 13792)


def test_cosim_claims_hold_on_the_capture_and_fail_when_broken():
    ref = cosim_reference()["grid"]
    bound, margin = COSIM_GRID["bound_cycles"], COSIM_GRID["margin_cycles"]
    headline = chip_smoke.check_cosim_claims(ref, bound, margin)
    heavy = headline["batch4_slices1"]
    p99 = (heavy["alone_p99"], heavy["qos_on_p99"], heavy["qos_off_p99"])
    assert [round(v, 2) for v in p99] == [274.0, 307.32, 950.62]  # as the reference prints them
    broken = json.loads(json.dumps(ref))
    broken["batch4_slices2"]["gathers"]["qos_off"]["gather_lat_p99"] = p99[2]
    with pytest.raises(RuntimeError, match="halve"):
        chip_smoke.check_cosim_claims(broken, bound, margin)
