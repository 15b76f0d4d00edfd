"""The port's fuzz evaluation and property oracles against the JAX package.

Four cases of the reference test's space (``tests/test_fuzz.py``: seed 5, the
``small16`` geometry, envelope (6, 16)) are evaluated by both packages, the
port on the CPU: every verdict and every summary of the run and its
alone-run must be equal, floats included (tolerance 0: the streaming P²
percentiles are bit for bit).  Then each oracle is fed the doctored
contexts of the reference's oracle tests, built from each package's own
results, and must return the same ``Violation``s."""

from dataclasses import replace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import traffic as ref_traffic  # noqa: E402
from repro.scenarios import fuzz as ref_fuzz  # noqa: E402
from repro.scenarios import properties as ref_props  # noqa: E402
from repro_torch.core import traffic  # noqa: E402
from repro_torch.data import sweep_record  # noqa: E402
from repro_torch.scenarios import fuzz, properties  # noqa: E402

ENV = (6, 16)
CFG = dict(seed=5, budget=4, chunk=8, geometries=("small16",), max_masters=ENV[0],
           txns_hi=ENV[1], max_cycles=6000)
PACKAGES = {
    "port": (fuzz, properties, traffic),
    "reference": (ref_fuzz, ref_props, ref_traffic),
}


@pytest.fixture(scope="module")
def evaluated():
    torch.set_num_threads(1)
    out = {}
    for name, (fz, _, _) in PACKAGES.items():
        cfg = fz.FuzzConfig(**CFG)
        cases = [fz.sample_case(cfg, i) for i in range(cfg.budget)]
        kw = {"device": "cpu"} if name == "port" else {}
        out[name] = cases, fz.evaluate_cases(cases, cfg, envelope=ENV, **kw)
    return out


def _records(results):
    return [
        (
            [v.to_json() for v in r.violations],
            sweep_record(r.result),
            None if r.alone is None else sweep_record(r.alone),
        )
        for r in results
    ]


def _nan_equal(a, b):
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_nan_equal(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_nan_equal(x, y) for x, y in zip(a, b))
    if isinstance(a, float) and np.isnan(a):
        return isinstance(b, float) and np.isnan(b)
    return a == b


def test_evaluate_cases_matches_reference(evaluated):
    (cases, ours), (_, ref) = evaluated["port"], evaluated["reference"]
    assert len(ours) == len(ref) == CFG["budget"]
    assert [r.case.index for r in ours] == [c.index for c in cases]
    assert any(r.alone is not None for r in ours)  # an isolation alone-run rode along
    for i, (a, b) in enumerate(zip(_records(ours), _records(ref))):
        assert _nan_equal(a, b), i


def _ctx(pkg, case, result, **over):
    """The PropertyContext ``evaluate_cases`` built (envelope-padded)."""
    _, props, trf = PACKAGES[pkg]
    comp = case.scenario.compile()
    wrap = replace(comp, trace=trf.pad_trace(comp.trace, *ENV))
    return props.PropertyContext(**{"compiled": wrap, "params": case.params, "result": result,
                                    **over})


def _with(result, **metrics):
    return replace(result, metrics={**result.metrics, **metrics})


def over_retire(pkg, case, res):
    tdp = np.array(res.metrics["txns_done_port"], copy=True)
    tdp[0, 0] += 1  # one phantom retired transaction
    return "oracle_conservation", _ctx(pkg, case, _with(res, txns_done_port=tdp))


def lost_at_drain(pkg, case, res):
    tdp = np.array(res.metrics["txns_done_port"], copy=True)
    tdp[0] = 0  # a master's work vanished
    return "oracle_conservation", _ctx(pkg, case, _with(res, txns_done_port=tdp))


def inconsistent_counters(pkg, case, res):
    cycles = int(res.metrics["cycles"])
    rt = np.full_like(np.asarray(res.metrics["read_throughput"]), 1.5)
    bad = _with(res, drained_cycle=np.int32(cycles + 5), read_throughput=rt)
    return "oracle_metric_sanity", _ctx(pkg, case, bad)


def starved_master(pkg, case, res):
    ctx = _ctx(pkg, case, res)
    early = np.flatnonzero((ctx.offered() > 0) & (ctx.first_start() <= 0.25 * 6000))
    tdp = np.array(res.metrics["txns_done_port"], copy=True)
    tdp[early[0]] = 0
    bad = _with(res, txns_done_port=tdp, drained_cycle=np.int32(-1))
    return "oracle_no_starvation", _ctx(pkg, case, bad)


def excess_misses(pkg, case, res):
    stats = {"deadline_txns": 10, "deadline_misses": 5, "deadline_miss_rate": 0.5}
    params = replace(case.params, qos_aging=64)
    return "oracle_deadline_misses", _ctx(pkg, case, replace(res, per_class={"safety": stats}),
                                          params=params)


def _isolation(pkg, case, res, full_p99):
    full = replace(res, per_class={"safety": {"read_lat_p99": full_p99, "write_lat_p99": 10.0}})
    alone = replace(res, per_class={"safety": {"read_lat_p99": 12.0, "write_lat_p99": 9.0}})
    params = replace(case.params, qos_aging=64, reg_rate=8)
    return "oracle_isolation", _ctx(pkg, case, full, alone=alone, params=params)


def latency_blowup(pkg, case, res):
    return _isolation(pkg, case, res, 9000.0)


def within_bound(pkg, case, res):
    return _isolation(pkg, case, res, 20.0)


@pytest.mark.parametrize(
    "doctor,fires",
    [
        (over_retire, True),
        (lost_at_drain, True),
        (inconsistent_counters, True),
        (starved_master, True),
        (excess_misses, True),
        (latency_blowup, True),
        (within_bound, False),
    ],
    ids=lambda x: getattr(x, "__name__", str(x)),
)
def test_oracles_fire_as_the_reference_does(evaluated, doctor, fires):
    got = {}
    for pkg in PACKAGES:
        cases, results = evaluated[pkg]
        assert not results[0].violations
        name, ctx = doctor(pkg, cases[0], results[0].result)
        got[pkg] = [v.to_json() for v in getattr(PACKAGES[pkg][1], name)(ctx)]
    assert _nan_equal(got["port"], got["reference"])
    assert bool(got["port"]) == fires
    assert list(properties.ORACLES) == list(ref_props.ORACLES)
