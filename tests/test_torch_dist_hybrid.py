"""The hybrid stack's sharded steps on a 2 x 2 gloo mesh (``data`` x
``model``), each rank a process of its own: smoke jamba-1.5-large-398b
(one super-block of 8 layers: the attention layer at position 0, 7 SSD
layers, MoE at the odd positions; 4 query heads over one KV group, 4
experts, 8 SSD heads split 2 ways over ``model``, so the SSD mixer runs
split over its heads, ``models.ssm.SSMBlock._mix_heads``, and the MoE
expert-parallel).

  * The sharded train step (``distributed.train``, sequence parallelism
    on): two steps from the same initial state on the same batch, the
    metrics, every gradient leaf (as the update takes it) and every
    updated leaf held to the single-process port's steps and to the
    reference's jitted ``make_train_step``
    (``torch_dist.reference_train_steps``), at ``test_torch_train_hybrid.py``'s
    tolerances: the loss within ``LOSS_TOL`` = 1e-5, each gradient leaf
    within ``GRAD_TOL`` = 2e-4 of its largest entry (measured: 2.6e-6
    against the single process, ``dt_bias``; 8.6e-6 against the
    reference, the embedding's), the other metrics and each updated leaf
    within ``test_torch_dist_train.py``'s ``REL_TOL``, but the leaves that
    start at zero and the embedding within ``ZERO_INIT_TOL`` and
    ``EMBED_TOL`` (below).  A third sharded run under remat ``full`` (each
    position's mixer and FFN checkpointed on its own, the split mixer's
    collectives replayed in the backward) gives the same values as the one
    without.
  * The sharded prefill into the contiguous cache and 4 decode steps over
    it (``distributed.serve``, decode_32k's layout: the attention cache's
    slots over ``model``, the SSD state over its heads, its conv window
    over its channels), held step by step to ``prefill_cache``/
    ``decode_step_cache`` and to the reference's ``prefill``/``decode_step``:
    the attention cache within ``test_torch_dist_decode.py``'s
    ``CACHE_TOL`` = 1e-5 of its largest entry, ``pos`` exactly, but the
    logits within ``HYBRID_LOGIT_TOL``, the SSD state within
    ``test_torch_hybrid.py``'s ``STATE_REL`` and the bf16 conv window within
    one bf16 step or ``CONV_ATOL`` (below).

Where these bounds are wider than ``test_torch_dist_decode.py``'s, the
cause is the bf16 conv window, as in ``test_torch_hybrid.py``: a float32
projection a last bit apart (here: the products split over ``model`` sum
in another order) rounds to the neighbouring bf16 value, and that step
moves the state and the next logits.  The SSD mixer per batch row (the
path where ``model`` does not divide the heads) gives the same gaps to
within 4e-7, so they are not the split's.
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.models import model as RM  # noqa: E402
from repro_torch.configs import get_config, smoke  # noqa: E402
from repro_torch.configs.base import RunConfig  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.train import step as S_  # noqa: E402
from repro_torch.tree import leaves_with_path  # noqa: E402
from test_torch_cache import _leaves, port_tree  # noqa: E402
from test_torch_dist_decode import BODY as DECODE_BODY  # noqa: E402
from test_torch_dist_decode import CACHE_TOL  # noqa: E402
from test_torch_hybrid import STATE_REL  # noqa: E402
from test_torch_dist_train import REL_TOL, _rel  # noqa: E402
from test_torch_model import _np, _pair  # noqa: E402
from test_torch_train_hybrid import GRAD_TOL, LOSS_TOL  # noqa: E402
from torch_dist import reference_train_steps, run_ranks  # noqa: E402

ARCH = "jamba-1.5-large-398b"
B, S = 4, 32  # one whole SSD chunk of the smoke config
#: the decode case, as ``test_torch_dist_decode.CASES``' entries: (arch,
#: overrides, cell shape, batch, prompt, cache slots, steps, absorbed,
#: pos0 offset)
CASE = (ARCH, {}, "decode_32k", 2, 32, 40, 4, False, [0, -2])
#: the logits of the sharded serving steps against the single-process
#: port: ``test_torch_hybrid.py``'s float32 ``TOL`` (measured 1.25e-4, at
#: the third call, after a conv-window entry one bf16 step apart); against
#: the reference this plus the single-process port's own gap to it at each
#: call (4.1e-4 at the fourth call; the sharded step's 4.25e-4)
HYBRID_LOGIT_TOL = 2e-4
#: updated leaves that start at zero (``A_log``, ``dt_bias``), as a share
#: of the leaf's largest entry: AdamW's first updates move an entry by
#: about the learning rate whatever its gradient's size, except where the
#: gradient is near AdamW's eps, and there a last-bit change of the
#: gradient moves the update (measured 4.8e-4, ``A_log``, against the
#: single process; 3.9e-4 with the mixer per batch row; the single process
#: itself is 1.1e-5 from the reference)
ZERO_INIT_TOL = 1e-3
#: the updated embedding, for the same cause (entries of rarely seen
#: tokens): measured 3.5e-5 against the single process and 6.1e-5 against
#: the reference, from which the single process itself is 2.6e-5
EMBED_TOL = 2e-4
#: the bf16 conv window, beside one bf16 step of each entry: entries near
#: 0, where the projection's float32 sum cancels, within this
#: (``test_torch_hybrid_serving.py``'s 1e-4; measured 1.22e-4, two bf16
#: steps at 0.012, after decode steps whose inputs differ as the state does)
CONV_ATOL = 2.5e-4

TRAIN_BODY = """
import numpy as np
from torch.distributed.device_mesh import init_device_mesh

from repro_torch.configs import get_config, smoke
from repro_torch.configs.base import RunConfig
from repro_torch.distributed.train import make_sharded_train_step, shard_train_state
from repro_torch.train import step as S_
from repro_torch.tree import leaves_with_path


def main(rank, world, tmp):
    arch, steps, remats = eval(open(tmp + "/job.txt").read())
    d = np.load(tmp + "/batch.npz")
    batch = {k: torch.from_numpy(d[k]) for k in d.files}
    mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
    cfg = smoke(get_config(arch))
    out = {}
    for remat in remats:
        run = RunConfig(remat_policy=remat, attn_impl="jnp", compute_dtype="float32")
        state = shard_train_state(S_.init_train_state(cfg, run, seed=0, device="cpu"), run, mesh)
        initial = {p: x.full_tensor().numpy().copy() for p, x in leaves_with_path(state.params)}
        step = make_sharded_train_step(cfg, run, total_steps=10, mesh=mesh)
        for _ in range(steps):
            state, metrics = step(state, batch)
        full = lambda t: {p: x.full_tensor().numpy() for p, x in leaves_with_path(t)}
        out[remat] = dict(
            metrics={k: float(v) for k, v in metrics.items()},
            grads=full(state.grads),
            params=full(state.params),
            initial=initial,
        )
    return out
"""


def _batch():
    rng = np.random.default_rng(5)
    tok = rng.integers(0, 256, (B, S + 1)).astype(np.int32)
    return {"tokens": tok[:, :-1], "labels": tok[:, 1:]}


@pytest.fixture(scope="module")
def sharded_train(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("hybrid_train4")
    np.savez(tmp / "batch.npz", **_batch())
    (tmp / "job.txt").write_text(repr((ARCH, 2, ["none", "full"])))
    return run_ranks(4, TRAIN_BODY, tmp, timeout=400)


def _single():
    cfg = smoke(get_config(ARCH))
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


def _check_train(got, want):
    m, w = got["metrics"], want["metrics"]
    assert abs(m["loss"] - w["loss"]) <= LOSS_TOL * abs(w["loss"]), (m["loss"], w["loss"])
    for k in ("grad_norm", "param_norm", "aux_loss"):
        assert abs(m[k] - w[k]) <= REL_TOL * abs(w[k]), (k, m[k], w[k])
    assert m["aux_loss"] > 0  # the MoE's load-balancing loss is in the step
    assert abs(m["lr"] - w["lr"]) <= 1e-6 * w["lr"], (m["lr"], w["lr"])
    for what in ("grads", "params"):
        assert set(got[what]) == set(want[what])
        for p, x in want[what].items():
            if what == "grads":
                tol = GRAD_TOL
            elif p.endswith(("['A_log']", "['dt_bias']")):
                tol = ZERO_INIT_TOL
            else:
                tol = EMBED_TOL if p == "['embed']" else REL_TOL
            assert _rel(got[what][p], x) <= tol, (what, p, _rel(got[what][p], x))
    moved = {p for p, x in want["params"].items() if not np.array_equal(x, got["initial"][p])}
    assert moved == set(want["params"])


def test_sharded_hybrid_step_matches_single_process(sharded_train):
    _check_train(sharded_train["none"], _single())


def test_sharded_hybrid_step_matches_reference(sharded_train):
    _check_train(sharded_train["none"], reference_train_steps(ARCH, _batch(), 2))


def test_sharded_hybrid_step_under_remat_matches(sharded_train):
    """Remat ``full``: every position's mixer and FFN checkpointed on its
    own, so the backward replays the split mixer's forward and its
    collectives; the values are those of the step without remat."""
    got, want = sharded_train["full"], sharded_train["none"]
    for k, v in want["metrics"].items():
        assert abs(got["metrics"][k] - v) <= 1e-6 * abs(v), (k, got["metrics"][k], v)
    for what in ("grads", "params"):
        for p, x in want[what].items():
            assert _rel(got[what][p], x) <= 1e-6, (what, p, _rel(got[what][p], x))


def _inputs():
    arch, overrides, shape, Bd, Sd, T, steps, absorbed, off = CASE
    rng = np.random.default_rng(11)
    prompt = rng.integers(0, 200, (Bd, Sd)).astype(np.int32)
    tokens = rng.integers(0, 200, (steps, Bd, 1)).astype(np.int32)
    pos = (Sd + np.asarray(off))[None] + np.arange(steps)[:, None]
    return prompt, tokens, pos.astype(np.int64)


@pytest.fixture(scope="module")
def sharded_decode(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("hybrid_decode4")
    prompt, tokens, pos = _inputs()
    np.savez(tmp / "hybrid.npz", prompt=prompt, tokens=tokens, pos=pos)
    (tmp / "job.txt").write_text(repr({"hybrid": CASE}))
    return run_ranks(4, DECODE_BODY, tmp, timeout=400)["hybrid"]


@functools.cache
def _single_and_reference():
    """The single-process cache form's and the reference's logits per call
    and final caches (reference-shaped), on the same weights and inputs."""
    arch, overrides, shape, Bd, Sd, T, steps, absorbed, _ = CASE
    ref_cfg, ref_params, cfg, model = _pair(arch, overrides, "float32")
    prompt, tokens, pos = _inputs()
    cache = M.init_cache(cfg, Bd, T, torch.float32, device="cpu")
    got, cache = M.prefill_cache(model, torch.from_numpy(prompt), cache)
    single = [_np(got)]
    rprefill = jax.jit(functools.partial(RM.prefill, ref_cfg, compute_dtype=jnp.float32))
    rdecode = jax.jit(functools.partial(RM.decode_step, ref_cfg, compute_dtype=jnp.float32))
    want, rc = rprefill(
        ref_params, {"tokens": jnp.asarray(prompt)}, RM.init_cache(ref_cfg, Bd, T, jnp.float32)
    )
    ref = [_np(want)]
    for i in range(steps):
        got, cache = M.decode_step_cache(
            model, cache, torch.from_numpy(tokens[i]), torch.from_numpy(pos[i])
        )
        single.append(_np(got))
        want, rc = rdecode(ref_params, rc, jnp.asarray(tokens[i]), jnp.asarray(pos[i], jnp.int32))
        ref.append(_np(want))
    single_cache = {k: _np(v) for k, v in _leaves(cache)}
    ref_cache = {
        tuple(p.key for p in path): np.asarray(v)
        for path, v in jax.tree_util.tree_leaves_with_path(rc)
    }
    return cfg, single, single_cache, ref, ref_cache


def _check_cache(got, want):
    assert set(got) == set(want)
    for k in want:
        if k[-1] == "pos":
            np.testing.assert_array_equal(got[k], want[k], err_msg=str(k))
            continue
        if k[-1] == "conv":
            rtol, atol = 2**-7, CONV_ATOL
        else:
            tol = STATE_REL if k[-1] == "ssm" else CACHE_TOL
            rtol, atol = 0, tol * max(1.0, float(np.abs(want[k]).max()))
        np.testing.assert_allclose(got[k], want[k], rtol=rtol, atol=atol, err_msg=str(k))


def test_sharded_hybrid_decode_matches_single_process(sharded_decode):
    cfg, single, single_cache, _, _ = _single_and_reference()
    for i, (g, w) in enumerate(zip(sharded_decode["logits"], single)):
        np.testing.assert_allclose(g, w, rtol=0, atol=HYBRID_LOGIT_TOL, err_msg=f"call {i}")
    _check_cache(sharded_decode["cache"], single_cache)


def test_sharded_hybrid_decode_matches_reference(sharded_decode):
    cfg, single, _, ref, ref_cache = _single_and_reference()
    for i, (g, s, w) in enumerate(zip(sharded_decode["logits"], single, ref)):
        tol = HYBRID_LOGIT_TOL + float(np.abs(s - w).max())
        np.testing.assert_allclose(g, w, rtol=0, atol=tol, err_msg=f"call {i}")
    nested: dict = {}
    for k, v in sharded_decode["cache"].items():
        node = nested
        for part in k[:-1]:
            node = node.setdefault(part, {})
        node[k[-1]] = torch.from_numpy(v)
    _check_cache({k: _np(v) for k, v in _leaves(port_tree(cfg, nested))}, ref_cache)


def test_hybrid_cache_is_laid_out_by_the_cells(sharded_decode):
    """The attention cache's slots over ``model`` and its batch over
    ``data``; the SSD state over its heads, its conv window over its
    channels (the reference's ``cache_pspecs``)."""
    pl = sharded_decode["placements"]
    assert pl[("attn", "k")] == "(Shard(dim=1), Shard(dim=2))"
    assert pl[("ssm", "ssm")] == "(Shard(dim=2), Shard(dim=3))"
    assert pl[("ssm", "conv")] == "(Shard(dim=2), Shard(dim=4))"
