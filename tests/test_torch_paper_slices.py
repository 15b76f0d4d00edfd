"""The port's fabric-structure jobs against the reference on the CPU:
``slice_scaling_bench`` (one batch per slice count: the 1- and 2-slice
geometries, local and remote placement) and ``comparators`` (the paper's,
the ``linear`` and the ``no_fractal`` banking), each beside the reference's
function at the same shrunk arguments, with equal returned dicts."""

import json

import pytest

pytest.importorskip("torch")

from benchmarks import paper_figures as ref_figures  # noqa: E402
from benchmarks import slice_scaling as ref_slices  # noqa: E402
from repro_torch.data import paper_record  # noqa: E402
from repro_torch.paper import paper_figures as port_figures  # noqa: E402
from repro_torch.paper import slice_scaling as port_slices  # noqa: E402

#: transactions a master of the ML + image trace in ``comparators``' second
#: part (the job fixes 600; at 48 the port's CPU run takes seconds)
TRACE_TXNS = 48


def _json(x) -> str:
    return json.dumps(paper_record(x), sort_keys=True)


def test_slice_scaling_matches_reference():
    kwargs = dict(txns=16, max_cycles=4000, slice_counts=(1, 2))
    want = ref_slices.slice_scaling_bench(**kwargs)
    got = port_slices.slice_scaling_bench(**kwargs, device="cpu")
    assert _json(got) == _json(want)
    assert got["headline"]["local_scaling_vs_1_slice"]["x2"] >= port_slices.SCALING_FLOOR


def test_slice_scaling_helpers_copied():
    assert port_slices.SCALING_FLOOR == ref_slices.SCALING_FLOOR
    per_class = {"safety": {"read_e2e_lat_p99": float("nan"), "write_e2e_lat_p99": 12.5}}
    assert port_slices._e2e_p99(per_class, "safety") == ref_slices._e2e_p99(per_class, "safety")


def test_comparators_matches_reference(monkeypatch):
    """A 4 KB payload, and the trace part at ``TRACE_TXNS`` transactions a
    master on both sides (``adas_mixed_trace`` capped where each module
    looks it up); every banking keeps its own call."""
    for mod in (ref_figures, port_figures):
        full = mod.adas_mixed_trace
        monkeypatch.setattr(
            mod,
            "adas_mixed_trace",
            lambda X, max_txns, full=full: full(X, max_txns=min(max_txns, TRACE_TXNS)),
        )
    want = ref_figures.comparators(payload_kb=4)
    got = port_figures.comparators(payload_kb=4, device="cpu")
    assert _json(got) == _json(want)
    assert set(got) == {"paper", "linear", "no_fractal", "trace_paper", "trace_no_fractal"}
