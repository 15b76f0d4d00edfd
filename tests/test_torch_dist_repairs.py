"""Sharded train steps of the three smoke stacks whose steps DTensor could
not propagate (``distributed.train`` on a 2 x 2 gloo mesh, sequence
parallelism on, the reference's default): MLA + MoE
(deepseek-v2-lite-16b: the flash through ``attention._flash``, the MoE
routed per batch row where ``model`` does not divide its experts), the SSD
(mamba2-1.3b: the mixer per batch row) and whisper's cross-attention
(whisper-base: the encoder's output gathered from sequence parallelism as
the decoder's input is).  Two steps from the same initial state on the same
batch, then the metrics, every gradient leaf (as the update takes it) and
every updated parameter leaf, held to:

  * the single-process port's steps, with ``test_torch_dist_train.py``'s
    tolerances (float32: the products split over ``model`` and the
    gradients over ``data`` sum in another order; the biases that start at
    zero, the norms' and the MLPs' ``b_in``/``b_out``, within 5e-4), but
    whisper's leaves within 2x those (measured: gradients up to 8.0e-5,
    ``cross_norm.scale``; the updated ``ffn.b_in`` 5.1e-4), as
    ``test_torch_encdec.py``'s float32 bounds are 2-5x the dense files';
  * the reference's jitted ``make_train_step``
    (``torch_dist.reference_train_steps``), the MoE's aux loss in its
    gradient: the same tolerances (measured: deepseek-v2-lite 2.5e-5 on the
    embedding's gradient, mamba2 2.9e-6 on ``A_log``'s), but whisper's those
    of ``test_torch_train_encdec.py`` (``WHISPER_TOLS``).

deepseek-v2-lite's sharded prefill is held to the single-process port in
``test_torch_dist_decode.py``."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config, smoke  # noqa: E402
from repro_torch.configs.base import RunConfig  # noqa: E402
from repro_torch.train import step as S_  # noqa: E402
from repro_torch.tree import leaves_with_path  # noqa: E402
from test_torch_dist_train import BIAS_TOL, GRAD_TOL, REL_TOL, _rel  # noqa: E402
from torch_dist import TRAIN_BODY, reference_train_steps, run_ranks  # noqa: E402

ARCHS = ("deepseek-v2-lite-16b", "mamba2-1.3b", "whisper-base")
B, S = 4, 16


def _batch():
    rng = np.random.default_rng(3)
    tok = rng.integers(0, 256, (B, S + 1)).astype(np.int32)
    frames = rng.standard_normal((B, 16, 64)).astype(np.float32)  # whisper's smoke encoder
    return {"tokens": tok[:, :-1], "labels": tok[:, 1:], "frames": frames}


@pytest.fixture(scope="module")
def sharded(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("repairs4")
    out = {}
    for arch in ARCHS:  # whisper alone takes frames
        sub = tmp / arch
        sub.mkdir()
        batch = _batch()
        if arch != "whisper-base":
            del batch["frames"]
        np.savez(sub / "batch.npz", **batch)
        (sub / "job.txt").write_text(repr(([arch], (2, 2), 2, [True])))
        out[arch] = run_ranks(4, TRAIN_BODY, sub, timeout=300)[arch][True]
    return out


def _single(arch):
    cfg = smoke(get_config(arch))
    run = RunConfig(remat_policy="none", attn_impl="jnp", compute_dtype="float32")
    state = S_.init_train_state(cfg, run, seed=0, device="cpu")
    batch = {k: torch.from_numpy(v) for k, v in _batch().items()}
    if not cfg.is_encoder_decoder:
        del batch["frames"]
    step = S_.make_train_step(cfg, run, total_steps=10)
    for _ in range(2):
        state, metrics = step(state, batch)
    return dict(
        metrics={k: float(v) for k, v in metrics.items()},
        grads={p: x.numpy() for p, x in leaves_with_path(state.grads)},
        params={p: x.detach().numpy() for p, x in leaves_with_path(state.params)},
    )


@pytest.fixture(scope="module")
def reference():
    out = {}
    for arch in ARCHS:
        batch = _batch()
        if arch != "whisper-base":
            del batch["frames"]
        out[arch] = reference_train_steps(arch, batch, 2)
    return out


#: (metrics, gradient leaves, updated leaves, updated biases that start at
#: zero): ``test_torch_dist_train.py``'s, whisper's at 2x against the
#: single process, and whisper's against the reference the float32 bounds
#: of ``test_torch_train_encdec.py``, the port's own distance from the
#: reference at this depth (the single-process step is 6.1e-5 from it on the
#: gradient norm, 3.1e-4 on a gradient leaf, 6.8e-4 on the updated
#: ``ffn.b_in``): measured 6.6e-5, 3.2e-4 (``cross_norm.scale``), 5.2e-5
#: (``encoder.ffn.w_out``) and 3.3e-4 (``encoder.ffn_norm.bias``)
TOLS = {"single": (REL_TOL, GRAD_TOL, REL_TOL, BIAS_TOL)}
WHISPER_TOLS = {
    "single": (REL_TOL, 2 * GRAD_TOL, 2 * REL_TOL, 2 * BIAS_TOL),
    "reference": ({"loss": 1e-5, "grad_norm": 5e-4, "param_norm": 1e-4}, 5e-4, 1e-4, 1e-3),
}


def _check(got, want, arch, against):
    """The metrics, every gradient leaf and every updated leaf of ``got``
    (the sharded step) against ``want``: within ``TOLS``' bounds of the
    metric, or of a leaf's largest entry."""
    metric_tol, grad_tol, param_tol, bias_tol = (
        WHISPER_TOLS[against] if arch == "whisper-base" else TOLS["single"]
    )
    if not isinstance(metric_tol, dict):
        metric_tol = dict.fromkeys(("loss", "grad_norm", "param_norm"), metric_tol)
    m, w = got["metrics"], want["metrics"]
    for k, tol in metric_tol.items():
        assert abs(m[k] - w[k]) <= tol * abs(w[k]), (k, m[k], w[k])
    assert abs(m["lr"] - w["lr"]) <= 1e-6 * w["lr"], (m["lr"], w["lr"])
    # MoE: the load-balancing loss is no zero
    assert abs(m["aux_loss"] - w["aux_loss"]) <= 1e-5 * w["aux_loss"]
    assert (m["aux_loss"] == 0) == (arch != "deepseek-v2-lite-16b")
    for what in ("grads", "params"):
        assert set(got[what]) == set(want[what])
        for p, x in want[what].items():
            zero_init = p.endswith(("['bias']", "['b_in']", "['b_out']"))
            tol = grad_tol if what == "grads" else (bias_tol if zero_init else param_tol)
            assert _rel(got[what][p], x) <= tol, (what, p, _rel(got[what][p], x))
    moved = {p for p, x in want["params"].items() if not np.array_equal(x, got["initial"][p])}
    assert moved == set(want["params"])


@pytest.mark.parametrize("arch", ARCHS)
def test_repaired_sharded_step_matches_single_process(sharded, arch):
    _check(sharded[arch], _single(arch), arch, "single")


@pytest.mark.parametrize("arch", ARCHS)
def test_repaired_sharded_step_matches_reference(sharded, reference, arch):
    """The reference's jitted ``make_train_step`` from the same initial
    state (``torch_dist.reference_train_steps``; the reference runs the
    same function under the cells' ``NamedSharding``s)."""
    _check(sharded[arch], reference[arch], arch, "reference")
