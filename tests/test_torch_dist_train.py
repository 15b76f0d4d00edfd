"""One sharded training step (``distributed.train``) of the dense smoke
config (stablelm-1.6b's, 2 layers, d 64, 4 heads of 16, vocab 256) on a
2 x 2 gloo mesh (``data`` x ``model``): FSDP over ``data``, TP over
``model``, the activation hooks registered, the plain attention path.  Held
to the single-process port's steps and to the reference's jitted
``make_train_step`` (``torch_dist.reference_train_steps``: the same initial
state through ``interop``) on the same weights and batch: two steps (the
first step's learning rate is 0 after the warm-up's start, so the second
moves the parameters), then the loss, every gradient leaf (as the update
takes it, clipped by the global norm), the gradient norm and every updated
parameter leaf.

Tolerance: float32 compute; the sharded step sums the products split over
``model`` (heads, MLP, vocab) and the gradients over ``data`` in another
order, so values agree to float32 rounding: the metrics within 1e-5
relative (measured: 2.9e-6 on the gradient norm), each updated parameter
leaf within 1e-5 of the leaf's largest entry but the norms' biases within
5e-4 (measured 2.9e-4 on ``ffn_norm.bias``: zero at init, so after one
update the leaf is the update itself, +-lr, and AdamW divides each entry's
gradient by its own RMS, which turns the gradients' rounding differences
into relative differences of the update; every other leaf within 4e-7),
each gradient leaf within
5e-5 (measured: 1.4e-5 on the embedding's, whose rows sum the repeated
tokens' gradients per data rank and then across the ranks).  The same
tolerances hold against the reference (measured: the gradient norm 1.4e-6,
the gradient leaves 2.1e-5 on ``wq``, the norms' biases 2.9e-4, every other
parameter leaf 4.9e-7).  Two configurations: with
sequence parallelism (the reference's default: the residual stream split
over ``model`` between blocks) and without.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config, smoke  # noqa: E402
from repro_torch.configs.base import RunConfig  # noqa: E402
from repro_torch.train import step as S_  # noqa: E402
from repro_torch.tree import leaves_with_path  # noqa: E402
from torch_dist import TRAIN_BODY, reference_train_steps, run_ranks  # noqa: E402

B, S = 4, 16
REL_TOL = 1e-5
GRAD_TOL = 5e-5
BIAS_TOL = 5e-4

def _batch():
    rng = np.random.default_rng(3)
    tok = rng.integers(0, 256, (B, S + 1)).astype(np.int32)
    return {"tokens": tok[:, :-1], "labels": tok[:, 1:]}


@pytest.fixture(scope="module")
def sharded(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("train4")
    np.savez(tmp / "batch.npz", **_batch())
    (tmp / "job.txt").write_text(repr((["stablelm-1.6b"], (2, 2), 2, [True, False])))
    return run_ranks(4, TRAIN_BODY, tmp, timeout=300)["stablelm-1.6b"]


@pytest.fixture(scope="module")
def single():
    cfg = smoke(get_config("stablelm-1.6b"))
    run = RunConfig(remat_policy="none", attn_impl="jnp", compute_dtype="float32")
    state = S_.init_train_state(cfg, run, seed=0, device="cpu")
    batch = {k: torch.from_numpy(v) for k, v in _batch().items()}
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
    return reference_train_steps("stablelm-1.6b", _batch(), 2)


def _rel(got, want) -> float:
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def check_metrics(got, want):
    for k in ("loss", "grad_norm", "param_norm"):
        assert abs(got[k] - want[k]) <= REL_TOL * abs(want[k]), (k, got[k], want[k])
    assert abs(got["lr"] - want["lr"]) <= 1e-6 * want["lr"], (got["lr"], want["lr"])
    assert got["aux_loss"] == want["aux_loss"] == 0


def check_leaves(got, want, what, initial, own=()):
    """``own``: parameter leaves that the caller checks itself."""
    assert set(got) == set(want)
    errs = {p: _rel(got[p], want[p]) for p in want}
    for p, e in errs.items():
        if what == "grads":
            assert e <= GRAD_TOL, (p, e)
        elif p not in own:
            assert e <= (BIAS_TOL if p.endswith("['bias']") else REL_TOL), (p, e)
    if what == "params":  # the second step moved every leaf
        moved = {p for p in want if not np.array_equal(want[p], initial[p])}
        assert moved == set(want)


SP = pytest.mark.parametrize("sp", [True, False], ids=["seq-parallel", "no-seq-parallel"])
WHAT = pytest.mark.parametrize("what", ["grads", "params"])


@SP
def test_sharded_step_metrics(sharded, single, sp):
    check_metrics(sharded[sp]["metrics"], single["metrics"])


@SP
@WHAT
def test_sharded_step_leaves(sharded, single, sp, what):
    check_leaves(sharded[sp][what], single[what], what, sharded[sp]["initial"])


@SP
def test_sharded_step_metrics_match_reference(sharded, reference, sp):
    """The reference's jitted step from the same initial state (the
    reference runs it under ``NamedSharding``s as the same function)."""
    check_metrics(sharded[sp]["metrics"], reference["metrics"])


@SP
@WHAT
def test_sharded_step_leaves_match_reference(sharded, reference, sp, what):
    check_leaves(sharded[sp][what], reference[what], what, sharded[sp]["initial"])


def test_state_is_laid_out_by_the_rules(sharded):
    """FSDP over ``data`` and TP over ``model`` on the leaves the rules
    split (``sharding.param_rules``), e.g. a stacked ``wq [L, d, H, D]``."""
    pl = sharded[True]["placements"]
    assert pl["['layers']['attn']['wq']"] == "(Shard(dim=1), Shard(dim=2))"
    assert pl["['embed']"] == "(Replicate(), Shard(dim=0))"
    assert pl["['lm_head']"] == "(Shard(dim=0), Shard(dim=1))"


