"""The port's batch entry points against the reference, exactly.

``simulate_batch`` on both pipelines, exact and streaming: the golden
``"batch"`` entry, batched equal to sequential and to the reference's batch
(lanes whose clocks diverge under the time skip), a shared trace, chunks with
a padded last chunk, and the footprint helpers.  Integer and float outputs
must equal the reference's bit for bit.
"""

import json
from dataclasses import asdict, replace
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.core.simulator as jsim
from repro.core.traffic import random_bursty as jrandom_bursty
from repro.core.traffic import random_uniform as jrandom_uniform
from repro_torch import interop
from repro_torch.core import simulator as tsim
from repro_torch.data import GOLDEN_KEYS, golden_batch

torch.set_num_threads(1)

DATA = Path(__file__).parent / "data"

SCHED = jsim.SCHEDULE_PIPELINE
VARIANTS = [(None, "exact"), (SCHED, "exact"), (SCHED, "stream")]
IDS = ["dense", "sched_exact", "sched_stream"]


def _tt(t):
    return interop.trace_from_arrays(t.is_write, t.burst, t.addr, t.start, t.prio)


def _tp(p, **kw):
    return replace(interop.params_from_reference(asdict(p)), **kw)


def _port_batch(traces, prms, **kw):
    return tsim.simulate_batch([_tt(t) for t in traces], [_tp(p) for p in prms], device="cpu", **kw)


def _assert_same(got, want):
    assert set(want) <= set(got), set(want) - set(got)
    for k, v in want.items():
        assert got[k].dtype == v.dtype, (k, got[k].dtype, v.dtype)
        np.testing.assert_array_equal(got[k], v, err_msg=k)


@pytest.mark.parametrize("stages", [None, SCHED], ids=["dense", "sched"])
def test_golden_batch_entry(stages):
    """The golden ``"batch"`` entry (two scenario points of different ring
    sizes in one batch) from the port's own replay of its inputs, on both
    pipelines (the reference pins both to the same entry)."""
    traces, prms = golden_batch()
    got = tsim.simulate_batch(traces, [replace(p, stages=stages) for p in prms], device="cpu")
    golden = json.loads((DATA / "golden_single_slice.json").read_text())["batch"]
    for k in GOLDEN_KEYS:
        assert np.asarray(got[k]).tolist() == golden[k], k


@pytest.mark.parametrize("stages,collect", VARIANTS, ids=IDS)
def test_batched_equals_sequential_and_reference(stages, collect):
    """Three lanes with their own traces and credits; gapped traces of
    different cadence, so under the time skip each lane's clock moves by its
    own amount.  Each row equals its own ``simulate`` at the envelope's ring
    and table sizes, and the reference's batch."""
    traces = [jrandom_bursty(4, 4, burst=8, gap=160 + 60 * i, seed=i) for i in range(3)]
    prms = [
        jsim.SimParams(max_cycles=1200, stages=stages, collect=collect, outstanding=o, reg_rate=r)
        for o, r in ((2, 0), (4, 64), (8, 32))
    ]
    got = _port_batch(traces, prms)
    want = jsim.simulate_batch(traces, prms)
    _assert_same(got, want)
    if stages:
        skipped = got["skipped_cycles"]
        assert (skipped > 0).all() and len(set(skipped.tolist())) == 3
    env = jsim.batch_envelope(prms)
    pin = dict(slots_override=env.slots_per_master, inflight_override=env.inflight_slots)
    for i, (t, p) in enumerate(zip(traces, prms)):
        row = tsim.simulate(_tt(t), _tp(p, **pin), device="cpu")
        _assert_same(row, {k: v[i] for k, v in got.items()})


@pytest.mark.parametrize("stages,collect", VARIANTS, ids=IDS)
def test_shared_trace_and_chunks(stages, collect):
    """One trace shared by five points, and the same five as listed traces,
    in chunks of 2 (the last chunk padded by a repeated lane): all equal the
    unchunked batch.  (A shared schedule in chunks against the reference:
    ``test_torch_scenarios.py::test_compiled_scenario_batch_and_shims``.)"""
    trace = jrandom_uniform(4, 6, burst=8, seed=1)
    prms = [
        jsim.SimParams(max_cycles=900, stages=stages, collect=collect, outstanding=o)
        for o in (1, 2, 3, 4, 8)
    ]
    whole = _port_batch([trace], prms)
    _assert_same(_port_batch([trace], prms, chunk=2), whole)
    _assert_same(_port_batch([trace] * 5, prms, chunk=2), whole)
    assert whole["all_done"].all()


@pytest.mark.parametrize("stages,collect", VARIANTS, ids=IDS)
def test_carry_and_input_nbytes_match_reference(stages, collect):
    trace = jrandom_uniform(8, 40, burst=8, seed=3)
    for o in (1, 8, 16):
        prm = jsim.SimParams(max_cycles=100, stages=stages, collect=collect, outstanding=o)
        for X, N in ((8, 40), (16, 4000)):
            assert tsim.carry_nbytes(_tp(prm), X, N) == jsim.carry_nbytes(prm, X, N), (o, X, N)
        assert tsim.input_nbytes(_tt(trace), _tp(prm)) == jsim.input_nbytes(trace, prm)


def test_batch_entry_points_are_loud(monkeypatch):
    trace = tsim.Trace(*(np.ones((2, 3), np.int32) for _ in range(3)))
    prm = tsim.SimParams(max_cycles=200)
    with pytest.raises(ValueError, match="empty"):
        tsim.simulate_batch([trace], [], device="cpu")
    with pytest.raises(ValueError, match="traces vs"):
        tsim.simulate_batch([trace] * 2, [prm] * 3, device="cpu")
    with pytest.raises(ValueError, match="must share"):
        tsim.simulate_batch([trace], [prm, replace(prm, max_cycles=300)], device="cpu")
    other = tsim.Trace(*(np.ones((2, 4), np.int32) for _ in range(3)))
    with pytest.raises(ValueError, match=r"share \[X, N\]"):
        tsim.simulate_batch([trace, other], [prm, prm], device="cpu")
    # a prepared runner gives what simulate gives
    run = tsim.compile_simulate(trace, prm, device="cpu")
    _assert_same(run(), tsim.simulate(trace, prm, device="cpu"))
    # the card by default; no silent CPU fallback, no silent single card
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tsim.simulate_batch([trace], [prm, prm])
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    with pytest.raises(NotImplementedError, match="the multi-device layer"):
        tsim.simulate_batch([trace], [prm, prm], device="cuda")
