"""The sharded training step (``distributed.train``) of GQA stacks whose
heads and KV groups the ``model`` axis does not divide, on a 2 x 8 gloo mesh
(16 ranks of one host: ``data`` 2, ``model`` 8): smoke(chameleon-34b) (4
heads over 1 KV group of 16, QK-norm) and smoke(h2o-danube-1.8b) (the same
heads, a 16-token sliding window).  The rules keep those heads and groups
whole (``sharding.spec_for_param``'s divisibility fallback), so ``wq``,
``wk``, ``wv`` and ``wo`` are replicated over ``model``; DTensor's products
may still split a flattened ``heads * head_dim`` dim 8 ways, a split the
heads' view cannot unflatten, in the forward and in the backward
(``models.attention._heads_flat`` keeps the split on whole heads).  On 2 x
2, 2 x 4 and 1 x 8 gloo meshes DTensor kept those products whole, so 2 x 8
is the smallest mesh tried that reaches this layout.

Held to the reference's jitted ``make_train_step`` from the same initial
state (``torch_dist.reference_train_steps``), two steps on one batch (the
first at learning rate 0), with sequence parallelism (the reference's
default; the 2 x 2 file covers the step without it), at
``tests/test_torch_dist_train.py``'s tolerances and reasons: the metrics
within 1e-5 relative, every gradient leaf within 5e-5 of its largest
entry, every parameter leaf within 1e-5 of its largest entry but the norms'
biases within 5e-4.  h2o-danube's embedding is held entry by entry
instead: AdamW's first moving step sends each entry by about the learning
rate whatever its gradient's size, so an entry whose gradient the gradient
check cannot tell from zero (below 5e-5 of the leaf's largest: 13 of the
3712 entries with a gradient, e.g. 3.2e-8 against the reference's 7.5e-8,
the leaf's largest 0.16) may move either way, and such entries came out up
to 7.3e-5 of the leaf's largest entry apart (the single-process port:
2.0e-5).  Those entries are held within twice the step's learning rate,
the others within 1e-5 of the leaf's largest entry.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_dist_train import (  # noqa: E402
    GRAD_TOL,
    REL_TOL,
    _batch,
    check_leaves,
    check_metrics,
)
from torch_dist import TRAIN_BODY, reference_train_steps, run_ranks  # noqa: E402

ARCHS = ("chameleon-34b", "h2o-danube-1.8b")
ARCH = pytest.mark.parametrize("arch", ARCHS)


@pytest.fixture(scope="module")
def sharded(tmp_path_factory):
    """Both archs' steps on one spawn of 16 ranks (~13 s)."""
    tmp = tmp_path_factory.mktemp("train16")
    np.savez(tmp / "batch.npz", **_batch())
    (tmp / "job.txt").write_text(repr((list(ARCHS), (2, 8), 2, [True])))
    return run_ranks(16, TRAIN_BODY, tmp, timeout=300)


@pytest.fixture(scope="module")
def reference():
    return {arch: reference_train_steps(arch, _batch(), 2) for arch in ARCHS}


@ARCH
def test_gqa_sharded_step_metrics_match_reference(sharded, reference, arch):
    check_metrics(sharded[arch][True]["metrics"], reference[arch]["metrics"])


@ARCH
@pytest.mark.parametrize("what", ["grads", "params"])
def test_gqa_sharded_step_leaves_match_reference(sharded, reference, arch, what):
    got, want = sharded[arch][True], reference[arch]
    own = ("['embed']",) if arch == "h2o-danube-1.8b" else ()
    check_leaves(got[what], want[what], what, got["initial"], own)
    for p in own if what == "params" else ():
        g, err = want["grads"][p], np.abs(got["params"][p] - want["params"][p])
        resolved = np.abs(g) > GRAD_TOL * np.abs(g).max()
        scale = np.abs(want["params"][p]).max()
        assert err[resolved].max() <= REL_TOL * scale, p
        assert err[~resolved].max() <= 2 * want["metrics"]["lr"], p


@ARCH
def test_heads_the_model_axis_does_not_divide_stay_whole(sharded, arch):
    """The attention weights are replicated over ``model`` (FSDP over
    ``data`` on d_model), the MLP split over it."""
    pl = sharded[arch][True]["placements"]
    for w in ("wq", "wk", "wv"):
        assert pl[f"['layers']['attn']['{w}']"] == "(Shard(dim=1), Replicate())", w
    assert pl["['layers']['attn']['wo']"] == "(Shard(dim=3), Replicate())"
    assert pl["['layers']['ffn']['w_up']"] == "(Shard(dim=1), Shard(dim=2))"
