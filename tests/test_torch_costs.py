"""The port's analytic cost model (``repro_torch.analysis.costs``) against
the JAX package's (``repro.analysis.costs``): for every config in the port's
registry and every ``SHAPES`` cell, with ``triangular`` and ``mla_absorbed``
on and off, the counts (FLOPs, device-memory bytes, cache bytes, active
parameters, the 6 N D yardstick) agree to 1e-12 of the reference's (the
same float64 arithmetic).  The rates differ by design: the port's are an
H100's, the reference's a TPU's, so times are not compared."""

import itertools

import pytest

pytest.importorskip("torch")

from repro.analysis import costs as R  # noqa: E402
from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.configs.base import SHAPES as REF_SHAPES  # noqa: E402
from repro_torch.analysis import costs as C  # noqa: E402
from repro_torch.configs import get_config, list_archs  # noqa: E402
from repro_torch.configs.base import SHAPES  # noqa: E402

COUNTS = ("flops_per_device", "hbm_bytes_per_device", "model_flops", "useful_ratio")
REL = 1e-12


def _close(got, want, what):
    assert abs(got - want) <= REL * abs(want), f"{what}: {got} != {want}"


@pytest.mark.parametrize("arch", list_archs())
@pytest.mark.parametrize("shape", [s.name for s in SHAPES])
@pytest.mark.parametrize("triangular,mla_absorbed", list(itertools.product((False, True), repeat=2)))
def test_costs_match_reference(arch, shape, triangular, mla_absorbed):
    cfg, rcfg = get_config(arch), ref_get_config(arch)
    s = next(x for x in SHAPES if x.name == shape)
    rs = next(x for x in REF_SHAPES if x.name == shape)
    assert (s.seq_len, s.global_batch, s.kind) == (rs.seq_len, rs.global_batch, rs.kind)
    _close(C.active_params(cfg), R.active_params(rcfg), "active_params")
    _close(C.model_flops(cfg, s), R.model_flops(rcfg, rs), "model_flops")
    kw = dict(triangular=triangular, mla_absorbed=mla_absorbed)
    _close(C.step_flops(cfg, s, **kw), R.step_flops(rcfg, rs, **kw), "step_flops")
    _close(
        C.forward_flops(cfg, 2, 512, kind="decode", cache_len=4096, **kw),
        R.forward_flops(rcfg, 2, 512, kind="decode", cache_len=4096, **kw),
        "forward_flops at a decode with a cache",
    )
    for chips, tp in ((1, 1), (4, 4), (16, 4)):
        got = C.roofline_terms(cfg, s, chips=chips, tp=tp, **kw)
        want = R.roofline_terms(rcfg, rs, chips=chips, tp=tp, **kw)
        for key in COUNTS:
            _close(got[key], want[key], f"{key} at {chips} chips, tp {tp}")
        _close(
            C.cache_bytes_per_device(cfg, s, chips=chips, tp=tp),
            R.cache_bytes_per_device(rcfg, rs, chips=chips, tp=tp),
            "cache_bytes_per_device",
        )


def test_costs_use_the_h100_rates():
    assert (C.PEAK_FLOPS, C.HBM_BW, C.NVLINK_BW) == (989e12, 3.35e12, 450e9)
    cfg, s = get_config("deepseek-v2-lite-16b"), SHAPES[0]
    t = C.roofline_terms(cfg, s, chips=1, tp=1)
    assert t["compute_s"] == t["flops_per_device"] / 989e12
    assert t["memory_s"] == t["hbm_bytes_per_device"] / 3.35e12
    # MLA + MoE: the active parameters are the top-6 of 64 routed experts
    assert C.active_params(cfg) < cfg.num_params() / 5


@pytest.mark.parametrize("arch", ["h2o-danube-1.8b", "mamba2-1.3b"])
@pytest.mark.parametrize(
    "kind,B,S,cache_len", [("train", 2, 4096, 0), ("prefill", 1, 8192, 0), ("decode", 8, 1, 8320)]
)
def test_window_and_ssm_counts_match_reference(arch, kind, B, S, cache_len):
    """The sliding-window and SSM configs: parameters (an SSM layer's
    projections, conv taps, A, D, dt bias and gated norm; one vocabulary
    matrix where mamba2 ties its embeddings), active parameters and forward
    FLOPs (the SSD chunk terms, or the recurrent step's) equal the
    reference's exactly."""
    cfg, rcfg = get_config(arch), ref_get_config(arch)
    assert cfg.num_params() == rcfg.num_params()
    assert C.active_params(cfg) == R.active_params(rcfg)
    got = C.forward_flops(cfg, B, S, kind=kind, cache_len=cache_len)
    assert got == R.forward_flops(rcfg, B, S, kind=kind, cache_len=cache_len)
    assert got > 0
