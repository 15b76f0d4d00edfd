"""The port's event-schedule pipeline against the reference, exactly.

The tensor twins of the address map against the port's numpy functions; the
schedule pipeline against the reference's ``simulate`` on its golden cases,
on scenario schedules with QoS classes and deadlines (``collect="exact"``
and ``"stream"``) and on gapped traces with the time skip; and every state
field after every cycle against the reference's cycle body.  Integer outputs
must be equal bit for bit; the P² float outputs too (stated tolerance 0).
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
from repro.core.traffic import compile_schedule as jcompile_schedule
from repro.core.traffic import random_bursty as jrandom_bursty
from repro.scenarios import highway_pilot
from repro_torch import interop
from repro_torch.core import address as taddr
from repro_torch.core import simulator as tsim
from repro_torch.core.state import SimState
from repro_torch.core.traffic import EventSchedule, compile_schedule, random_uniform
from repro_torch.data import GOLDEN_KEYS

torch.set_num_threads(1)

DATA = Path(__file__).parent / "data"
sys.path.insert(0, str(DATA))
try:
    from capture_golden import golden_cases
finally:
    sys.path.pop(0)

SCHED = jsim.SCHEDULE_PIPELINE


@functools.lru_cache(maxsize=None)
def _case(name):
    return {n: (t, p) for n, t, p in golden_cases()}[name]


def _port_input(inp):
    """A reference Trace or EventSchedule as the port's."""
    if hasattr(inp, "cls"):
        cols = ("is_write", "burst", "addr", "start", "prio", "cls", "deadline")
        return interop.schedule_from_arrays(*(getattr(inp, c) for c in cols))
    return interop.trace_from_arrays(inp.is_write, inp.burst, inp.addr, inp.start, inp.prio)


def _port(inp, prm, **kw):
    tp = replace(interop.params_from_reference(asdict(prm)), **kw)
    return tsim.simulate(_port_input(inp), tp, device="cpu")


def _assert_same(got, want):
    assert set(want) <= set(got), set(want) - set(got)
    for k, v in want.items():
        assert got[k].dtype == v.dtype, (k, got[k].dtype, v.dtype)
        np.testing.assert_array_equal(got[k], v, err_msg=k)


# ---------------------------------------------------------------------------
# (a) the address twins
# ---------------------------------------------------------------------------


def test_hash32_dev_matches_numpy():
    rng = np.random.default_rng(0)
    edges = np.array([0, 1, 0xFFFF, 0x10000, 2**31 - 1, 2**31, 2**32 - 2, 2**32 - 1], np.int64)
    x = np.concatenate([edges, rng.integers(0, 2**32, 100_000)])
    want = taddr._hash32(x.astype(np.uint32)).astype(np.int64)
    got = taddr._hash32_dev(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, want)
    # int32 inputs read as uint32, as the reference's cast does
    neg = torch.tensor([-1, -(2**31)], dtype=torch.int32)
    np.testing.assert_array_equal(
        taddr._hash32_dev(neg).numpy(), taddr._hash32(np.array([2**32 - 1, 2**31], np.uint32))
    )


@pytest.mark.parametrize("banking", ["paper", "linear", "no_fractal"])
@pytest.mark.parametrize("num_slices", [1, 2, 4])
@pytest.mark.parametrize("policy", ["hash", "region"])
def test_bank_of_dev_matches_numpy(policy, num_slices, banking):
    """Every beat of a small geometry, 20k random beats of the paper's."""
    for kw in (dict(total_bytes=2**16), {}):
        g = taddr.MemoryGeometry(num_slices=num_slices, slice_policy=policy, **kw)
        prm = tsim.SimParams(geom=g, banking=banking)
        if kw:
            beats = np.arange(g.beats_total, dtype=np.int32)
        else:
            beats = np.random.default_rng(num_slices).integers(0, g.beats_total, 20_000)
        beats = beats.astype(np.int32).reshape(-1, 4)
        got = tsim.bank_of_dev(torch.from_numpy(beats), prm)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), tsim.bank_of(beats, prm))


# ---------------------------------------------------------------------------
# (b) the schedule pipeline against the goldens and the reference
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["random_uniform", "urban_perception", "highway_qos"])
def test_schedule_golden_matches_golden_file(name):
    """The golden cases on the schedule pipeline (the reference pins them to
    the dense pipeline's golden entries; its other keys are held to the
    reference by the tests below)."""
    trace, prm = _case(name)
    got = _port(trace, replace(prm, stages=SCHED))
    golden = json.loads((DATA / "golden_single_slice.json").read_text())["cases"][name]
    for k in GOLDEN_KEYS:
        assert np.asarray(got[k]).tolist() == golden[k], (name, k)


def test_scenario_schedule_with_classes_and_deadlines():
    """A scenario schedule carries its masters' QoS classes; its safety
    masters get a deadline that three quarters of their transactions miss.
    Every stream accumulator, P² floats included."""
    sched = highway_pilot(txns=10).compile().schedule()
    sched = replace(sched, deadline=np.where(sched.cls == 0, 20, -1).astype(np.int32))
    p = jsim.SimParams(max_cycles=2000, outstanding=4, qos_aging=64, stages=SCHED, collect="stream")
    want = jsim.simulate(sched, p)
    _assert_same(_port(sched, p), want)
    assert bool(want["all_done"])
    assert int(want["cls_done"].sum()) == int((sched.burst > 0).sum())
    assert 0 < int(want["dl_miss"].sum()) < int(want["dl_done"].sum())


def test_time_skip_matches_reference_and_fires():
    """Gapped traces: the skip jumps idle stretches (``skipped_cycles`` > 0),
    with the regulator refilled analytically; on equals the reference, and
    off equals on but for ``skipped_cycles``."""
    trace = jrandom_bursty(4, 3, burst=8, gap=250, seed=2)
    p = jsim.SimParams(max_cycles=800, stages=SCHED, collect="stream", reg_rate=48, reg_burst=4)
    on = _port(trace, p)
    off = _port(trace, p, time_skip=False)
    _assert_same(on, jsim.simulate(trace, p))
    assert int(on["skipped_cycles"]) > 0 and int(off["skipped_cycles"]) == 0
    on.pop("skipped_cycles")
    off.pop("skipped_cycles")
    _assert_same(on, off)


def test_schedule_early_exit_equals_fixed_horizon():
    """The per-lane block driver (blocks of 7, the gated tail) against the
    plain fixed-horizon loop, with and without the time skip."""
    trace = jrandom_bursty(4, 3, burst=8, gap=100, seed=6)
    p = jsim.SimParams(max_cycles=400, stages=SCHED, collect="stream", block_cycles=7)
    fixed = _port(trace, p, early_exit=False)
    assert int(fixed["drained_cycle"]) > 0
    _assert_same(_port(trace, p, time_skip=False), fixed)
    skipped = _port(trace, p)
    assert int(skipped.pop("skipped_cycles")) > 0
    fixed.pop("skipped_cycles")
    _assert_same(skipped, fixed)


# ---------------------------------------------------------------------------
# (c) per-cycle state parity
# ---------------------------------------------------------------------------


def _jax_state_numpy(st):
    return {f.name: np.asarray(getattr(st, f.name)) for f in dataclasses.fields(st)}


@pytest.mark.parametrize("collect", ["exact", "stream"])
def test_every_state_field_matches_reference_each_cycle(collect):
    """The schedule pipeline's cycle body side by side with the reference's
    (``jax.jit``, as its loop runs it), every field after every cycle."""
    sched = highway_pilot(txns=12).compile().schedule()
    prm = jsim.SimParams(
        max_cycles=4000, outstanding=4, qos_aging=64, stages=SCHED, collect=collect
    )
    host = jsim._host_args(sched, prm, True)
    jstate, jctx = jsim._sched_setup(*jsim._to_device_args(prm, host, prm.dyn_vector(), True), prm)
    jstep = jax.jit(lambda s: jsim._pipeline_cycle(prm, jctx)(s, None)[0])

    tprm = interop.params_from_reference(asdict(prm))
    thost = [a[None] for a in tsim._host_args(_port_input(sched), tprm, True)]
    targs = tsim._device_args(tprm, thost, tprm.dyn_vector()[None], "cpu", True)
    tstate, tctx = tsim._sched_setup(*targs, tprm)
    tstep = tsim._pipeline_cycle(tprm, tctx)

    names = [f.name for f in dataclasses.fields(SimState)]
    for cycle in range(121):
        want = interop.state_from_numpy(_jax_state_numpy(jstate), "cpu")
        for n in names:
            a, b = getattr(tstate, n), getattr(want, n)
            assert a.dtype == b.dtype and torch.equal(a, b), f"{n} differs after {cycle} cycles"
        jstate, tstate = jstep(jstate), tstep(tstate)
    assert int(tstate.slice_beats.sum()) > 0 and int(tstate.ift_remaining.sum()) > 0


# ---------------------------------------------------------------------------
# (d) EventSchedule, compile_schedule, loud errors
# ---------------------------------------------------------------------------


def test_compile_schedule_matches_reference_and_round_trips():
    tr = random_uniform(4, 12, burst=8, seed=0, full_duplex=False)
    jtr = jsim.Trace(tr.is_write, tr.burst, tr.addr)
    kw = dict(classes=[0, 1, 2, 3], deadlines=[100, None, 50, None])
    got, want = compile_schedule(tr, **kw), jcompile_schedule(jtr, **kw)
    assert isinstance(got, EventSchedule) and got.nbytes == want.nbytes
    for f in dataclasses.fields(got):
        a, b = getattr(got, f.name), getattr(want, f.name)
        assert a.dtype == b.dtype, f.name
        np.testing.assert_array_equal(a, b, err_msg=f.name)
    back = got.to_trace()
    for col in ("is_write", "burst", "addr"):
        np.testing.assert_array_equal(getattr(back, col), getattr(tr, col))
    with pytest.raises(ValueError, match="classes"):
        compile_schedule(tr, classes=[0, 1])
    with pytest.raises(ValueError, match="class"):
        compile_schedule(tr, classes=[0, 1, 2, 9])
    with pytest.raises(ValueError, match="deadline"):
        compile_schedule(tr, deadlines=[0, 1, 2])
    # a dense pipeline runs a schedule through its trace view
    prm = tsim.SimParams(max_cycles=600)
    _assert_same(
        tsim.simulate(got, prm, device="cpu"), tsim.simulate(tr, prm, device="cpu")
    )


def test_schedule_loud_errors():
    g = taddr.MemoryGeometry()
    zero = np.zeros((1, 1), np.int32)
    oob = tsim.Trace(zero, np.full((1, 1), 4, np.int32), np.full((1, 1), g.beats_total - 2))
    prm = tsim.SimParams(max_cycles=100, stages=tsim.SCHEDULE_PIPELINE)
    with pytest.raises(ValueError, match="out of range"):
        tsim.simulate(oob, prm, device="cpu")
    big = tsim.Trace(zero, np.full((1, 1), 20, np.int32), zero)
    with pytest.raises(ValueError, match="max_burst"):
        tsim.simulate(big, prm, device="cpu")
    assert tsim.SimParams(stages=tsim.SCHEDULE_PIPELINE).uses_schedule()
    assert not tsim.SimParams().uses_schedule()
    assert tsim.SimParams(outstanding=5).inflight_slots == 16
