"""The port's dense simulator against the reference, exactly.

Inputs are the reference's golden cases and small seeded traces; outputs
must equal the reference's ``simulate()`` key for key, dtypes included, and
the golden file on ``GOLDEN_KEYS``.  The per-cycle test steps both cycle
bodies side by side and compares every state field after every cycle.

Regenerate ``src/repro_torch/data/golden_inputs.npz`` (only after a reviewed
change to the reference's golden scenarios) with

    PYTHONPATH=src python tests/test_torch_simulator.py
"""

import dataclasses
import functools
import json
import sys
from dataclasses import asdict, replace
from pathlib import Path

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.core.simulator as jsim
from repro.core.address import MemoryGeometry as JGeometry
from repro_torch import interop
from repro_torch.core import simulator as tsim
from repro_torch.core.state import SimState, bank_dtype, init_state
from repro_torch.data import GOLDEN_INPUTS, GOLDEN_KEYS, TRACE_COLUMNS
from repro_torch.data import golden_cases as port_golden_cases

torch.set_num_threads(1)

DATA = Path(__file__).parent / "data"
sys.path.insert(0, str(DATA))
try:
    from capture_golden import GOLDEN_KEYS as JGOLDEN_KEYS
    from capture_golden import golden_cases
finally:
    sys.path.pop(0)

CASE_NAMES = ("random_uniform", "urban_perception", "highway_qos")


@functools.lru_cache(maxsize=None)
def _case(name):
    """The reference's golden (trace, params), built once per process."""
    return {n: (t, p) for n, t, p in golden_cases()}[name]


def _port(trace, prm, **kw):
    """Run the port on the CPU for a reference (trace, params) pair."""
    tp = replace(interop.params_from_reference(asdict(prm)), **kw)
    tt = interop.trace_from_arrays(trace.is_write, trace.burst, trace.addr, trace.start, trace.prio)
    return tsim.simulate(tt, tp, device="cpu")


def _assert_same(got, want):
    assert set(want) <= set(got), set(want) - set(got)
    for k, v in want.items():
        assert got[k].dtype == v.dtype, (k, got[k].dtype, v.dtype)
        np.testing.assert_array_equal(got[k], v, err_msg=k)


def _golden_input_arrays():
    """The reference's scenario traces, as stored in ``golden_inputs.npz``."""
    return {
        f"{name}__{col}": np.asarray(getattr(_case(name)[0], col), np.int32)
        for name in ("urban_perception", "highway_qos")
        for col in TRACE_COLUMNS
    }


# ---------------------------------------------------------------------------
# (a) golden cases; (b) the committed golden inputs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", CASE_NAMES)
def test_golden_case_matches_golden_file_and_reference(name):
    trace, prm = _case(name)
    got = _port(trace, prm)
    golden = json.loads((DATA / "golden_single_slice.json").read_text())["cases"][name]
    for k in GOLDEN_KEYS:
        assert np.asarray(got[k]).tolist() == golden[k], (name, k)
    _assert_same(got, jsim.simulate(trace, prm))


def test_golden_inputs_file_equals_reference_traces():
    assert GOLDEN_KEYS == JGOLDEN_KEYS
    want = _golden_input_arrays()
    with np.load(GOLDEN_INPUTS) as stored:
        assert sorted(stored.files) == sorted(want)
        for k, v in want.items():
            assert stored[k].dtype == np.int32, k
            np.testing.assert_array_equal(stored[k], v, err_msg=k)
    for (name, t, p), (jname, jt, jp) in zip(port_golden_cases(), golden_cases()):
        assert name == jname
        assert p == interop.params_from_reference(asdict(jp))
        for col in TRACE_COLUMNS:
            a, b = getattr(t, col), getattr(jt, col)
            assert (a is None) == (b is None), (name, col)
            if a is not None:
                np.testing.assert_array_equal(a, b, err_msg=f"{name}.{col}")


@pytest.mark.parametrize(
    "gen,args,kw",
    [
        ("random_uniform", (16, 300), dict(burst=16)),
        ("random_uniform", (8, 40), dict(burst=8, seed=3)),
        ("random_uniform", (4, 10), dict(full_duplex=False, read_fraction=0.3, seed=2)),
        ("random_bursty", (6, 12), dict(seed=4, gap=50)),
        ("bulk_linear", (16, 64 * 1024), dict(is_write=True)),
        ("adas_mixed_trace", (16,), dict(max_txns=300, seed=1)),
    ],
)
def test_traffic_generators_match_reference(gen, args, kw):
    """The same arguments and seed give the same trace as the reference."""
    from repro.core import traffic as jtraffic
    from repro_torch.core import traffic as ttraffic

    want = getattr(jtraffic, gen)(*args, **kw)
    got = getattr(ttraffic, gen)(*args, **kw)
    for col in TRACE_COLUMNS:
        a, b = getattr(got, col), getattr(want, col)
        assert (a is None) == (b is None), col
        if a is not None:
            assert a.dtype == b.dtype, col
            np.testing.assert_array_equal(a, b, err_msg=col)
    X, N = got.num_masters, got.num_txns
    padded = ttraffic.stack_traces([got, ttraffic.pad_trace(got, X + 1, N + 3)])
    wpadded = jtraffic.stack_traces([want, jtraffic.pad_trace(want, X + 1, N + 3)])
    for p, w in zip(padded, wpadded):
        np.testing.assert_array_equal(p.burst, w.burst)
        np.testing.assert_array_equal(p.addr, w.addr)


# ---------------------------------------------------------------------------
# (c) multi-slice fabric
# ---------------------------------------------------------------------------


def _directed_trace(geom, *, masters, txns, burst, seed=0, writes=False):
    """Traffic aimed at the slice after each master's home slice (the
    reference's slice tests build the same shape of trace)."""
    rng = np.random.default_rng(seed)
    home = jsim.master_home_slices(masters, geom)
    bps = geom.beats_per_slice
    tgt = (home + 1) % geom.num_slices
    addr = np.stack([t * bps + rng.integers(0, bps - burst, txns) for t in tgt])
    is_w = rng.integers(0, 2, (masters, txns)) if writes else np.zeros((masters, txns))
    return jsim.Trace(
        is_w.astype(np.int32), np.full((masters, txns), burst, np.int32), addr.astype(np.int32)
    )


@pytest.mark.parametrize("policy", ["region", "hash"])
@pytest.mark.parametrize(
    "case",
    [
        dict(burst=8, prm=dict(hop_latency=8)),
        dict(burst=8, prm=dict(slice_ingress=8, bank_occupancy=8)),
        dict(burst=16, writes=True, prm=dict(slice_ingress=4, hop_latency=3)),
        dict(burst=8, txns=2, prm=dict(slice_ingress=8, banking="linear")),
        dict(burst=8, prm=dict(banking="no_fractal")),
    ],
)
def test_two_slice_fabric_matches_reference(policy, case):
    """16 ports offering remote bursts at once, so router admission order,
    ingress debt and hop latency all show."""
    trace = _directed_trace(
        JGeometry(num_slices=2, slice_policy="region"),
        masters=16,
        txns=case.get("txns", 4),
        burst=case["burst"],
        writes=case.get("writes", False),
    )
    geom = JGeometry(num_slices=2, slice_policy=policy)
    prm = jsim.SimParams(geom=geom, max_cycles=4000, **case["prm"])
    want = jsim.simulate(trace, prm)
    assert int(want["drained_cycle"]) > 0 and int(want["remote_beats"]) > 0
    _assert_same(_port(trace, prm), want)


# ---------------------------------------------------------------------------
# (d) early exit; the cycle driver
# ---------------------------------------------------------------------------


def _small_trace(seed=0, X=6, N=6):
    rng = np.random.default_rng(seed)
    return jsim.Trace(
        is_write=rng.integers(0, 2, (X, N)).astype(np.int32),
        burst=rng.integers(1, 13, (X, N)).astype(np.int32),
        addr=rng.integers(0, 4000, (X, N)).astype(np.int32),
        prio=rng.integers(0, 4, X).astype(np.int32),
    )


def test_early_exit_equals_fixed_horizon():
    trace = _small_trace()
    prm = jsim.SimParams(max_cycles=700, qos_aging=32, reg_rate=64)
    fixed = _port(trace, prm, early_exit=False)
    assert int(fixed["drained_cycle"]) > 0
    for K in (1, 7, 32, 5000):
        _assert_same(_port(trace, prm, block_cycles=K), fixed)
    _assert_same(fixed, jsim.simulate(trace, replace(prm, early_exit=False)))


def _predicted_cycles(drained_cycle, K, mc, early):
    """Cycle bodies a run steps when no lane takes the time skip: the drain
    rounded up to whole blocks of K, or every cycle where early exit is off
    or the run never drains."""
    drained = int(drained_cycle)
    if not early or drained < 0:
        return mc
    K = max(1, min(K, mc))
    return min(mc, -(-drained // K) * K)


def test_driver_steps_the_cycles_it_reports():
    """The driver counts every cycle body it runs (``DRIVER_COUNTS``, what
    ``chip_smoke.py`` holds the kernel's launch count to) and reads one flag
    back per block, plus one for the tail; on the schedule pipeline with the
    time skip and per-lane activity too.  Where no lane skips, the count
    equals the drain rounded up to whole blocks, predicted apart from the
    driver."""
    calls = []

    @tsim.register_stage("test_count_cycles")
    def count(st, wires, ctx):
        calls.append(1)
        return st, wires

    pipelines = [
        (tsim.DEFAULT_PIPELINE, {}, True),
        (tsim.SCHEDULE_PIPELINE, {}, False),
        (tsim.SCHEDULE_PIPELINE, {"time_skip": False}, True),
    ]
    try:
        trace = _small_trace(1)
        runs = [(7, 700, True), (32, 700, True), (5000, 700, True), (32, 90, True), (32, 90, False)]
        for K, mc, early in runs:
            for base, kw, predictable in pipelines:
                calls.clear()
                tsim.reset_driver_counts()
                prm = jsim.SimParams(max_cycles=mc, block_cycles=K, early_exit=early)
                out = _port(trace, prm, stages=base + ("test_count_cycles",), **kw)
                assert len(calls) == tsim.DRIVER_COUNTS["cycles"] > 0, (K, mc, early)
                if predictable:
                    want = _predicted_cycles(out["drained_cycle"], K, mc, early)
                    assert len(calls) == want, (K, mc, early, kw)
                blocks = -(-len(calls) // min(K, mc))
                assert tsim.DRIVER_COUNTS["host_reads"] <= (blocks + 2 if early else 0)
                assert int(out["cycles"]) == mc
    finally:
        del tsim.STAGE_REGISTRY["test_count_cycles"]


def test_registered_stage_is_swappable():
    @tsim.register_stage("test_freeze_clock")
    def freeze(st, wires, ctx):
        return st.replace(now=st.now - 1), wires  # cancel retire's +1

    try:
        stages = tsim.DEFAULT_PIPELINE + ("test_freeze_clock",)
        prm = jsim.SimParams(max_cycles=50)
        out = _port(_small_trace(), prm, stages=stages, early_exit=False)
        assert int(out["cycles"]) == 0
        assert not bool(out["all_done"])
    finally:
        del tsim.STAGE_REGISTRY["test_freeze_clock"]


# ---------------------------------------------------------------------------
# (e) per-cycle state parity
# ---------------------------------------------------------------------------


def _jax_state_numpy(st):
    return {f.name: np.asarray(getattr(st, f.name)) for f in dataclasses.fields(st)}


def test_every_state_field_matches_reference_each_cycle():
    trace, prm = _case("highway_qos")
    jargs = jsim._to_device_args(prm, jsim._host_args(trace, prm, False), prm.dyn_vector(), False)
    jstate, jctx = jsim._dense_setup(*jargs, prm)
    jstep = jax.jit(lambda s: jsim._pipeline_cycle(prm, jctx)(s, None)[0])

    tprm = interop.params_from_reference(asdict(prm))
    tt = interop.trace_from_arrays(trace.is_write, trace.burst, trace.addr, trace.start, trace.prio)
    host = [a[None] for a in tsim._host_args(tt, tprm)]
    targs = tsim._device_args(tprm, host, tprm.dyn_vector()[None], "cpu")
    tstate, tctx = tsim._dense_setup(*targs, tprm)
    tstep = tsim._pipeline_cycle(tprm, tctx)

    names = [f.name for f in dataclasses.fields(SimState)]
    for cycle in range(161):
        want = interop.state_from_numpy(_jax_state_numpy(jstate), "cpu")
        for n in names:
            a, b = getattr(tstate, n), getattr(want, n)
            assert a.dtype == b.dtype and torch.equal(a, b), f"{n} differs after {cycle} cycles"
        jstate, tstate = jstep(jstate), tstep(tstate)
    assert int(tstate.slice_beats.sum()) > 0 and int((tstate.complete_cycle >= 0).sum()) > 50


def test_state_from_numpy_is_loud():
    trace, prm = _case("random_uniform")
    jargs = jsim._to_device_args(prm, jsim._host_args(trace, prm, False), prm.dyn_vector(), False)
    fields = _jax_state_numpy(jsim._dense_setup(*jargs, prm)[0])
    st = interop.state_from_numpy(fields, "cpu")
    assert st.now.shape == (1,) and st.sl_flags.dtype == torch.uint8
    with pytest.raises(KeyError, match="missing"):
        interop.state_from_numpy({k: v for k, v in fields.items() if k != "now"}, "cpu")
    with pytest.raises(ValueError, match="does not have"):
        interop.state_from_numpy({**fields, "ift_table": np.ones((2, 2), np.int8)}, "cpu")


def test_init_state_narrow_dtypes_with_batch_axis():
    d = {
        "split_buffer": torch.tensor([64, 32], dtype=torch.int32),
        "reg_burst": torch.tensor([16, 8], dtype=torch.int32),
    }
    burst = torch.ones((2, 4, 6), dtype=torch.int8)
    st = init_state(X=4, N=6, P=32, NB=256, NSL=1, tx_burst=burst, d=d)
    assert st.sl_flags.dtype == torch.uint8 and st.sl_flags.shape == (2, 4, 32)
    assert st.sl_hops.dtype == st.remaining.dtype == torch.int8
    assert st.outstanding.dtype == st.credits.dtype == torch.int16
    assert st.sl_bank.dtype == bank_dtype(256) == torch.int16
    assert st.now.shape == st.drained_at.shape == (2,)
    assert st.credits[:, 0, 0].tolist() == [64, 32]
    assert st.reg_tokens[:, 0].tolist() == [16 * 256, 8 * 256]


# ---------------------------------------------------------------------------
# (f) loud errors; (g) the device default
# ---------------------------------------------------------------------------


def test_loud_errors():
    g = tsim.MemoryGeometry()
    oob_addr = np.array([[g.beats_total - 1]], np.int32)
    oob = tsim.Trace(np.zeros((1, 1), np.int32), np.full((1, 1), 4, np.int32), oob_addr)
    with pytest.raises(ValueError, match="out of range"):
        tsim.simulate(oob, tsim.SimParams(max_cycles=100), device="cpu")
    zero = np.zeros((1, 1), np.int32)
    big = tsim.Trace(zero, np.full((1, 1), 200, np.int32), zero)
    with pytest.raises(ValueError, match="max_burst"):
        tsim.simulate(big, tsim.SimParams(max_burst=200), device="cpu")
    with pytest.raises(ValueError, match="int16 credit counters"):
        tsim.SimParams(split_buffer=2**14).dyn_vector()
    with pytest.raises(ValueError, match="out of range"):
        tsim.simulate(oob, tsim.SimParams(stages=tsim.SCHEDULE_PIPELINE), device="cpu")
    with pytest.raises(ValueError, match="needs the schedule pipeline"):
        tsim.simulate(oob, tsim.SimParams(collect="stream"), device="cpu")
    with pytest.raises(ValueError, match="collect must be"):
        tsim.SimParams(collect="sampled").pipeline()
    with pytest.raises(ValueError, match="unknown stage"):
        tsim.SimParams(stages=("accept", "teleport")).pipeline()
    with pytest.raises(ValueError, match="unknown arbiter"):
        tsim.SimParams(arbiter="pallas").pipeline()


def test_ref_arbiter_equals_kernel_arbiter_on_cpu():
    trace, prm = _case("random_uniform")
    _assert_same(_port(trace, prm, arbiter="ref"), _port(trace, prm))


def test_simulate_defaults_to_cuda_and_raises_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    zero = np.zeros((1, 1), np.int32)
    tr = tsim.Trace(zero, np.full((1, 1), 4, np.int32), zero)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tsim.simulate(tr, tsim.SimParams(max_cycles=100))


def test_reference_params_carry_over():
    prm = jsim.SimParams(
        geom=JGeometry(num_slices=2, slice_policy="region"),
        arbiter="pallas",
        stages=jsim.DEFAULT_PIPELINE,
        reg_rate=32,
        max_cycles=1234,
    )
    tp = interop.params_from_reference(asdict(prm))
    assert tp.arbiter == "kernel" and tp.stages == tsim.DEFAULT_PIPELINE
    assert tp.geom.num_banks == 512 and tp.max_cycles == 1234
    assert tp.slots_per_master == prm.slots_per_master
    np.testing.assert_array_equal(tp.dyn_vector(), prm.dyn_vector())


if __name__ == "__main__":
    np.savez_compressed(GOLDEN_INPUTS, **_golden_input_arrays())
    print(f"wrote {GOLDEN_INPUTS}")
