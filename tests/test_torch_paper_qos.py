"""The port's QoS and pool jobs against the reference on the CPU:
``qos_isolation`` (``interference_report``: victim alone and among its
aggressors as two lanes of one batch), ``qos_isolation_sweep`` (four lanes,
one of them QoS-blind with no priorities) and ``pool_balance`` (host only),
each beside the reference's function at the same arguments with equal
returned dicts; the capture ``paper_reference.json`` (made at
``PAPER_JOBS``'s arguments, two of its jobs reproduced here at full size);
and the command line's job list."""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

from benchmarks import paper_figures as ref_figures  # noqa: E402
from benchmarks import qos_isolation as ref_qos  # noqa: E402
from repro_torch.core import simulator as sim  # noqa: E402
from repro_torch.data import PAPER_JOBS, paper_record, paper_reference  # noqa: E402
from repro_torch.paper import job_table  # noqa: E402
from repro_torch.paper import paper_figures as port_figures  # noqa: E402
from repro_torch.paper.qos_isolation import CONFIGS, qos_isolation_sweep  # noqa: E402

REPO = Path(__file__).resolve().parents[1]


def _json(x) -> str:
    return json.dumps(paper_record(x), sort_keys=True)


def test_qos_isolation_matches_reference():
    kwargs = dict(num_txns=40)
    want = ref_figures.qos_isolation(**kwargs)
    got = port_figures.qos_isolation(**kwargs, device="cpu")
    assert _json(got) == _json(want)


def test_qos_isolation_sweep_matches_reference():
    """24 transactions a master (at 16 the safety class has no read p99 and
    the asserts fail), a 4000-cycle horizon."""
    kwargs = dict(txns=24, max_cycles=4000)
    want = ref_qos.qos_isolation_sweep(**kwargs)
    got = qos_isolation_sweep(**kwargs, device="cpu")
    assert _json(got) == _json(want)
    assert set(got["rows"]) == set(CONFIGS)


def test_pool_balance_matches_reference():
    """At full size: the churn draws from the generator alike on both sides."""
    want = ref_figures.pool_balance()
    got = port_figures.pool_balance(device="cpu")
    assert _json(got) == _json(want)


def test_capture_made_at_the_jobs_arguments():
    """``paper_reference.json`` holds the seven jobs at ``PAPER_JOBS``'s
    arguments, which are ``benchmarks/run.py``'s without ``--full`` (the
    port's ``job_table``); every simulator lane drained."""
    ref = paper_reference()["jobs"]
    assert list(ref) == list(PAPER_JOBS)
    table = job_table()
    for name, args in PAPER_JOBS.items():
        assert ref[name]["args"] == paper_record(args), name
        assert table[name][1] == args, name
        assert all(d > 0 for d in ref[name]["drains"]), name
    assert ref["pool_balance"]["drains"] == []
    assert len(ref["fig5_bulk"]["drains"]) == 2 * len(PAPER_JOBS["fig5_bulk"]["payloads_kb"])


@pytest.mark.parametrize("name", ["pool_balance", "qos_isolation_sweep"])
def test_capture_reproduced_on_cpu(monkeypatch, name):
    """Two of the capture's jobs at ``PAPER_JOBS``'s arguments on the CPU:
    the returned dict and every lane's drained cycle equal the capture's."""
    drains = []
    inner = sim._run

    def run(args, prm, use_sched):
        out = inner(args, prm, use_sched)
        drains.extend(out["drained_cycle"].reshape(-1).tolist())
        return out

    monkeypatch.setattr(sim, "_run", run)
    want = paper_reference()["jobs"][name]
    got = job_table()[name][0](**PAPER_JOBS[name], device="cpu")
    assert _json(got) == json.dumps(want["result"], sort_keys=True)
    assert drains == want["drains"]


def _cli(*args):
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.paper", *args],
        env=env,
        capture_output=True,
        text=True,
        timeout=120,
        cwd=REPO,
    )


def test_cli_refuses_an_unknown_job_with_the_list():
    res = _cli("--only", "nope")
    assert res.returncode != 0
    assert "unknown --only jobs: ['nope']" in res.stderr
    for name in job_table():
        assert name in res.stderr


def test_cli_lists_and_runs_a_job_on_the_cpu():
    listed = _cli("--list")
    assert listed.returncode == 0 and listed.stdout.split() == list(job_table())
    res = _cli("--only", "pool_balance", "--device", "cpu")
    assert res.returncode == 0, res.stderr
    line = json.loads(res.stdout.strip().splitlines()[-1])
    assert line["job"] == "pool_balance"
    assert line["result"] == paper_reference()["jobs"]["pool_balance"]["result"]
