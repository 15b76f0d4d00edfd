"""The port's paper figures (``repro_torch.paper.paper_figures``) against the
reference's ``benchmarks/paper_figures.py`` on the CPU: each function runs
beside the reference's at the same shrunk arguments, and the two returned
dicts must be equal, every float to the bit (both are numpy reductions of
the same integer metrics; ``moe_whitening``'s of the same routing
decisions).

The port's CPU simulator steps each run only to its drain, the reference to
its horizon; both report the fixed horizon's metrics."""

import json

import pytest

pytest.importorskip("torch")

from benchmarks import paper_figures as ref  # noqa: E402
from repro_torch.data import paper_record  # noqa: E402
from repro_torch.paper import paper_figures as port  # noqa: E402


def _same(got, want) -> None:
    """Equal as JSON keeps them: keys, types, every float's bits, NaN as NaN."""
    a = json.dumps(paper_record(got), sort_keys=True)
    b = json.dumps(paper_record(want), sort_keys=True)
    assert a == b


def _both(name: str, **kwargs):
    want = getattr(ref, name)(**kwargs)
    got = getattr(port, name)(**kwargs, device="cpu")
    _same(got, want)
    return got


def test_fig4_throughput_matches_reference():
    """100 transactions a port (at 64 the reference's own asserts fail, and
    the port's with them), X = 1 and 16."""
    rows = _both("fig4_throughput", num_txns=100, counts=(1, 16))
    assert rows[16]["read_throughput"] > 0.93


def test_fig5_bulk_matches_reference():
    """Read and write of a payload as two lanes of one batch in the port,
    two runs in the reference; 32 KB is the utilization assert's threshold
    (1024 beats)."""
    rows = _both("fig5_bulk", payloads_kb=(4, 32))
    assert rows[32]["read"]["utilization"] > 0.9


def test_table1_outstanding_matches_reference():
    rows = _both("table1_outstanding", num_txns=24)
    assert rows[16]["read_lat"] / rows[1]["read_lat"] > 4.5


def test_fig67_traces_matches_reference():
    rows = _both("fig67_traces", max_txns=80)
    assert rows["all_done"]


def test_moe_whitening_matches_reference():
    """At its only size: olmoe-1b-7b's routing on the benchmark's inputs."""
    out = _both("moe_whitening")
    assert out["fractal"]["fraction_of_drops_in_last_quarter"] < 0.35
