"""The port's scenario engine against the reference, key by key.

The generators, the scenario compiler and every library preset give the
reference's traces, regions and classes; ``run_sweep`` summaries equal the
reference's on every preset, on both pipelines and both collection modes
(host timings aside); the deprecation shims and the isolation helpers
behave as the reference's.
"""

import math
from dataclasses import asdict, replace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.core.qos as jqos
import repro.core.simulator as jsim
import repro.scenarios as jsc
from repro.core.traffic import random_uniform as jrandom_uniform
from repro_torch import interop
from repro_torch import scenarios as tsc
from repro_torch.core import qos as tqos
from repro_torch.core import simulator as tsim
from repro_torch.core.traffic import random_uniform
from repro_torch.data import SWEEP_TIMING_KEYS

torch.set_num_threads(1)

SCHED = jsim.SCHEDULE_PIPELINE


def _same(a, b, path=""):
    """Deep equality of summaries: NaN equals NaN, floats exactly."""
    if isinstance(a, dict):
        assert set(a) == set(b), (path, set(a) ^ set(b))
        for k in a:
            _same(a[k], b[k], f"{path}/{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{path}[{i}]")
    elif isinstance(a, float) and math.isnan(a):
        assert isinstance(b, float) and math.isnan(b), (path, b)
    else:
        assert a == b and type(a) is type(b), (path, a, b)


def _summary(result):
    s = result.summary()
    s["sim_rate"] = {k: v for k, v in s["sim_rate"].items() if k not in SWEEP_TIMING_KEYS}
    s["params"] = asdict(result.params)
    s["params"]["arbiter"] = None  # the backends differ by name only
    return s


@pytest.mark.parametrize("txns", [5, 40])
def test_presets_compile_as_reference(txns):
    """Every library preset (and both slice_scaling placements): the same
    trace columns, regions, classes, priorities, deadlines and schedule."""
    for remote in (False, True):
        pairs = zip(
            [*jsc.preset_scenarios(txns), jsc.slice_scaling(4, txns, remote=remote)],
            [*tsc.preset_scenarios(txns), tsc.slice_scaling(4, txns, remote=remote)],
        )
        for js, ts in pairs:
            jc, tc = js.compile(), ts.compile()
            assert (tc.regions, tc.qos, tc.priorities, tc.deadlines) == (
                jc.regions,
                jc.qos,
                jc.priorities,
                jc.deadlines,
            ), ts.name
            for col in ("is_write", "burst", "addr", "start", "prio"):
                np.testing.assert_array_equal(getattr(tc.trace, col), getattr(jc.trace, col))
            jsched, tsched = jc.schedule(), tc.schedule()
            for col in ("is_write", "burst", "addr", "start", "prio", "cls", "deadline"):
                a, b = getattr(tsched, col), getattr(jsched, col)
                assert a.dtype == b.dtype
                np.testing.assert_array_equal(a, b, err_msg=col)


@pytest.mark.parametrize("model", sorted(jsc.GENERATORS))
def test_generators_match_reference(model):
    params = {"camera": {"readback": True}, "radar": {"readback": False}}.get(model, {})
    for seed, rate in ((0, 1.0), (3, 0.37)):
        kw = dict(txns=97, rate=rate, seed=seed, params=params)
        want = jsc.GENERATORS[model](1000, 9000, **kw)
        got = tsc.GENERATORS[model](1000, 9000, **kw)
        for a, b in zip(got, want):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("stages,collect", [(None, "exact"), (SCHED, "stream")])
def test_run_sweep_summaries_match_reference(stages, collect):
    """Every library preset x two credit settings as one batched sweep, on
    the dense pipeline (exact) and the schedule pipeline (streaming)."""
    jpts, tpts = [], []
    for js, ts in zip(jsc.preset_scenarios(6), tsc.preset_scenarios(6)):
        for o in (1, 8):
            p = jsim.SimParams(outstanding=o, max_cycles=700, stages=stages, collect=collect)
            jpts.append(jsc.SweepPoint(js, p))
            tpts.append(tsc.SweepPoint(ts, interop.params_from_reference(asdict(p))))
    want = jsc.run_sweep(jpts)
    got = tsc.run_sweep(tpts, device="cpu")
    for g, w in zip(got, want):
        _same(_summary(g), _summary(w))
    done = [r.summary()["all_done"] for r in got]
    assert any(done) and not all(done)  # drained and cut-off points both


def test_compiled_scenario_batch_and_shims():
    """``CompiledScenario.simulate_batch`` (one shared schedule, chunks); the
    deprecated metric keys and ``compile_scenario``."""
    prms = [jsim.SimParams(outstanding=o, max_cycles=1500, stages=SCHED) for o in (2, 4, 8)]
    jc = jsc.highway_pilot(8).compile()
    tc = tsc.highway_pilot(8).compile()
    tprms = [interop.params_from_reference(asdict(p)) for p in prms]
    want = jc.simulate_batch(prms, chunk=2)
    got = tc.simulate_batch(tprms, chunk=2, device="cpu")
    for g, w in zip(got, want):
        _same(_summary(g), _summary(w))

    stats = got[0].per_class["realtime"]
    with pytest.warns(DeprecationWarning, match="read_tput"):
        assert stats["read_tput"] == stats["read_throughput"] > 0
    assert "write_tput" in stats and stats.get("nope", 7) == 7
    with pytest.warns(DeprecationWarning, match="compile"):
        tsc.compile_scenario(tsc.highway_pilot(4))


def test_isolation_helpers_match_reference():
    t = random_uniform(4, 12, burst=8, seed=4, full_duplex=False)
    jt = jsim.Trace(t.is_write, t.burst, t.addr)
    for m in range(4):
        got = tqos.touched_subbanks(t.addr[m], t.burst[m])
        np.testing.assert_array_equal(got, jqos.touched_subbanks(t.addr[m], t.burst[m]))
        assert tqos.touched_intervals(t.addr[m], t.burst[m]) == jqos.touched_intervals(
            t.addr[m], t.burst[m]
        )
    for groups in (None, [0, 0, 1, 1]):
        assert tqos.regions_isolated(t, groups=groups) == jqos.regions_isolated(jt, groups=groups)
    assert tqos.subbank_isolated(t) == jqos.subbank_isolated(jt)
    sc = tsc.qos_isolation(6).compile()
    assert tqos.regions_isolated(sc.trace) and not tqos.subbank_isolated(sc.trace)

    victim = jrandom_uniform(1, 8, burst=8, seed=1, full_duplex=False)
    full = jrandom_uniform(4, 8, burst=8, seed=1, full_duplex=False)
    prm = jsim.SimParams(max_cycles=600)
    tprm = interop.params_from_reference(asdict(prm))
    port = [interop.trace_from_arrays(x.is_write, x.burst, x.addr) for x in (victim, full)]
    got = tqos.interference_report(*port, tprm, device="cpu")
    assert got == jqos.interference_report(victim, full, prm)


def test_sweeps_default_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    pt = tsc.SweepPoint(tsc.highway_pilot(4), tsim.SimParams(max_cycles=100))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tsc.run_sweep([pt, replace(pt, params=replace(pt.params, outstanding=2))])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        pt.scenario.compile().simulate(pt.params)
