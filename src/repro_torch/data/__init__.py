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

``cosim_reference.json`` holds the reference's results for the serving co-sim
and the fuzzer at the sizes ``chip_smoke.py`` runs on the card: every group of
the co-sim grid (``COSIM_GRID``), the co-sim's scale mode (``COSIM_SCALE``;
its fixed-horizon leg at ``COSIM_SCALE_FIXED_REQUESTS``), the clean-tree fuzz
job (``FUZZ_JOB``) case by case, and the planted find with its shrunk spec
(``FUZZ_PLANTED``).  ``tests/data/capture_torch_cosim.py`` makes it.

``moe_reference.json`` holds the reference's MoE routing on the inputs of its
``moe_whitening`` benchmark (:func:`moe_whitening_inputs`), with the fractal
slot permutation on and off: drop rate, the share of drops in the last
quarter of the sequence, and every (b, s, k) expert choice and slot
(:func:`moe_whitening_record`).  ``tests/data/capture_torch_moe.py`` makes it.
"""

from __future__ import annotations

import base64
import hashlib
import itertools
import json
from dataclasses import replace
from pathlib import Path

import numpy as np

from repro_torch.core.simulator import SimParams, Trace
from repro_torch.core.traffic import random_uniform, stack_traces

GOLDEN_INPUTS = Path(__file__).resolve().parent / "golden_inputs.npz"
SWEEP_REFERENCE = Path(__file__).resolve().parent / "sweep_reference.json"
COSIM_REFERENCE = Path(__file__).resolve().parent / "cosim_reference.json"
MOE_REFERENCE = Path(__file__).resolve().parent / "moe_reference.json"
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


#: the serving co-sim grid: the reference benchmark's defaults
#: (``benchmarks/serving_cosim.py::serving_cosim``); every group records a
#: traffic-only engine run and runs it alone, with QoS on and with QoS off as
#: three lanes of one dense, exact batch
COSIM_GRID = dict(
    batch_sizes=(2, 4),
    slice_counts=(1, 2),
    num_requests=24,
    prompt_lo=48,
    prompt_hi=96,
    max_new_tokens=8,
    cycles_per_step=192,
    bank_occupancy=32,
    reg_rate=8,
    reg_burst=8,
    bound_cycles=64,
    margin_cycles=64,
    seed=0,
)
#: the co-sim's scale mode (``serving_cosim.py::serving_scale``): a recorded
#: run on the schedule pipeline with streaming percentiles, cut from the
#: benchmark's 1024 requests to 512 (at 1024 it took 92.7 s of
#: ``chip_smoke.py``, which the hybrid stack's phases pushed past its aim),
#: then to 256 (the whole script took 1073.5 s against its 1050 s aim; the
#: phase 108.4 s of it at 512)
COSIM_SCALE = dict(
    num_requests=256,
    max_batch=16,
    prompt_lo=16,
    prompt_hi=33,
    max_new_tokens=8,
    cycles_per_step=256,
    bank_occupancy=8,
    seed=0,
)
#: requests of the scale mode's fixed-horizon leg (and of the time-skip leg it
#: is held to): 1024 would step all 118784 cycles of the horizon; 128 until
#: the cut above
COSIM_SCALE_FIXED_REQUESTS = 64
#: the clean-tree fuzz job (``benchmarks/fuzz.py::fuzz_job``): ``FuzzConfig``
#: fields
FUZZ_JOB = dict(seed=0, budget=48, shrink_limit=0, max_cycles=20_000)
#: one planted deadline violation found and shrunk (the reference's
#: ``tests/test_fuzz.py::test_planted_violation_found_and_shrunk``)
FUZZ_PLANTED = dict(
    seed=7,
    budget=2,
    chunk=8,
    geometries=("small16",),
    max_masters=6,
    txns_hi=16,
    max_cycles=6000,
    plant_rate=1.0,
    shrink_limit=1,
)


def cosim_scale_params(record, stages) -> dict:
    """``SimParams`` fields of the scale mode for a recorded run: a horizon
    of the run's steps plus 16, ``bank_occupancy`` and the streaming
    collector on the caller's package's ``stages`` (``SCHEDULE_PIPELINE``)."""
    cps = COSIM_SCALE["cycles_per_step"]
    return dict(
        max_cycles=(record.steps + 16) * cps,
        bank_occupancy=COSIM_SCALE["bank_occupancy"],
        stages=stages,
        collect="stream",
    )


def scale_summary(record, compiled, params, result, carry_bytes: int) -> dict:
    """The scale mode's summary, as the reference's benchmark reports it: the
    recording's size, the run's cycle counts, the schedule's and the carry's
    bytes, the decode class's latency and deadline numbers and the prefill
    ports' write throughput.  Takes the reference's objects and the port's
    alike (``carry_bytes`` from the caller's ``carry_nbytes``)."""
    m, dec = result.metrics, result.per_class["realtime"]
    sched = compiled.schedule()
    keys = (
        "txns_done",
        "read_lat_p50",
        "read_lat_p99",
        "read_lat_max",
        "deadline_txns",
        "deadline_misses",
        "deadline_miss_rate",
    )
    return {
        "requests": record.num_requests,
        "engine_steps": record.steps,
        "trace_shape": list(compiled.trace.burst.shape),
        "max_cycles": params.max_cycles,
        **{k: int(m[k]) for k in ("cycles", "effective_cycles", "skipped_cycles", "drained_cycle")},
        "schedule_txns": sched.num_txns,
        "schedule_bytes": sched.nbytes,
        "carry_bytes": carry_bytes,
        "decode": {k: dec[k] for k in keys},
        "prefill_write_throughput": result.per_class["besteffort"]["write_throughput"],
    }


def case_record(result, spec: dict) -> dict:
    """One evaluated fuzz case as ``cosim_reference.json`` keeps it: its spec
    (``case_to_json`` of the caller's package), its violations and the
    summaries (:func:`sweep_record`) of its run and of its alone-run.  Takes
    the reference's ``CaseResult`` and the port's alike."""
    return {
        "index": result.case.index,
        "spec": spec,
        "violations": json.loads(json.dumps([v.to_json() for v in result.violations])),
        "result": sweep_record(result.result),
        "alone": None if result.alone is None else sweep_record(result.alone),
    }


def cosim_reference() -> dict:
    """``cosim_reference.json`` (see the module docstring)."""
    return json.loads(COSIM_REFERENCE.read_text())


# ---------------------------------------------------------------------------
# MoE whitening: the reference benchmark's inputs and what it reads from them
# ---------------------------------------------------------------------------

#: the benchmark's capacity factor: half of what top-8 over 64 experts needs, so it drops
MOE_WHITENING_CAPACITY_FACTOR = 0.5


def moe_whitening_inputs():
    """``(x [4, 512, 64], router [64, 64])`` float32, drawn as the reference's
    ``benchmarks/paper_figures.py::moe_whitening`` draws them (olmoe-1b-7b's
    64 experts over a 64-wide input)."""
    rng = np.random.default_rng(0)
    x = rng.normal(size=(4, 512, 64)).astype(np.float32)
    router = rng.normal(size=(64, 64)).astype(np.float32)
    return x, router


def _pack(a: np.ndarray) -> dict:
    raw = np.ascontiguousarray(a, np.uint8).tobytes()
    return {
        "shape": list(a.shape),
        "sha256": hashlib.sha256(raw).hexdigest(),
        "uint8_base64": base64.b64encode(raw).decode(),
    }


def unpack_decisions(d: dict) -> np.ndarray:
    """The int array a :func:`moe_whitening_record` field packs."""
    raw = base64.b64decode(d["uint8_base64"])
    return np.frombuffer(raw, np.uint8).reshape(d["shape"]).astype(np.int64)


def moe_whitening_record(top_e, slot, capacity: int) -> dict:
    """The benchmark's two numbers for one routing (``slot >= capacity`` is a
    drop) and its decisions, packed as uint8 (experts < 64, slots <= C)."""
    top_e, slot = np.asarray(top_e), np.asarray(slot)
    dropped = slot >= capacity
    quarter = 3 * slot.shape[1] // 4
    return {
        "drop_rate": float(dropped.mean()),
        "fraction_of_drops_in_last_quarter": float(
            dropped[:, quarter:, :].sum() / max(dropped.sum(), 1)
        ),
        "top_e": _pack(top_e),
        "slot": _pack(slot),
    }


def moe_reference() -> dict:
    return json.loads(MOE_REFERENCE.read_text())
