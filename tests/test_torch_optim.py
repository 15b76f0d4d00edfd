"""The port's optimizers against the JAX package's, on the same gradient
tree: AdamW and Adafactor updates over three steps, global-norm clipping,
the LR schedule and int8 error feedback.  Tolerance 1e-6 (relative, float32
arithmetic in another order; the int8 codes are equal).

The tree holds the reference's kinds of leaf: layer-stacked ``[2, ...]``
matrices and norm scales, whose two layers differ in scale by 100x, an
unstacked matrix and a vector.  So a reduction taken per layer (Adafactor's
update-clipping RMS, the int8 scale) and not over the stacked leaf gives
other numbers, and the tests check that it does.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.optim import compression as RC  # noqa: E402
from repro.optim import optimizers as RO  # noqa: E402
from repro_torch.optim import compression as TC  # noqa: E402
from repro_torch.optim import optimizers as TO  # noqa: E402
from repro_torch.tree import leaves_with_path, tree_map  # noqa: E402

RTOL = 1e-6


def _tree(seed: int) -> dict:
    rng = np.random.default_rng(seed)
    def stacked(*shape):  # two layers, the second 100x the first
        x = rng.standard_normal((2, *shape), dtype=np.float32)
        return x * np.array([1.0, 100.0], np.float32).reshape(2, *[1] * len(shape))

    return {
        "layers": {"w": stacked(6, 5), "norm": stacked(5), "wq": stacked(4, 3, 2)},
        "embed": rng.standard_normal((7, 5), dtype=np.float32),
        "final_norm": rng.standard_normal(5, dtype=np.float32),
    }


def _port(tree):
    return tree_map(lambda x: torch.tensor(np.array(x)), tree)


def _close(got, want, rtol=RTOL, atol=0.0):
    got = dict(leaves_with_path(tree_map(lambda x: x.numpy(), got)))
    want = dict(leaves_with_path(jax.tree_util.tree_map(np.asarray, want)))
    assert sorted(got) == sorted(want)
    for path in want:
        scale = np.abs(want[path]).max()
        np.testing.assert_allclose(
            got[path], want[path], rtol=rtol, atol=atol * scale, err_msg=path
        )


@pytest.mark.parametrize("name", ["adamw", "adafactor"])
def test_optimizer_updates_match_reference(name):
    params = _tree(0)
    r_init, r_update = RO.make_optimizer(name)
    t_init, t_update = TO.make_optimizer(name)
    rp = jax.tree_util.tree_map(jnp.asarray, params)
    r_state = r_init(rp)
    tp = _port(params)
    t_state = t_init(tp)
    for step in range(3):
        grads = _tree(step + 1)
        lr = 1e-3 * (step + 1)
        r_grads = jax.tree_util.tree_map(jnp.asarray, grads)
        r_upd, r_state = r_update(r_grads, r_state, rp, jnp.float32(lr))
        t_upd, t_state = t_update(_port(grads), t_state, tp, torch.tensor(lr))
        _close(t_upd, r_upd, atol=1e-7)
        rp = jax.tree_util.tree_map(lambda p, u: p - u, rp, r_upd)
        tp = tree_map(lambda p, u: p - u, tp, t_upd)
    _close(tp, rp, atol=1e-7)
    assert int(t_state["count"]) == int(r_state["count"]) == 3
    del t_state["count"], r_state["count"]
    _close(t_state, r_state, atol=1e-7)


def test_adafactor_clips_over_the_stacked_leaf():
    """Per-layer update clipping would change the stacked leaves' updates."""
    params, grads = _tree(0), _tree(1)
    _, t_update = TO.make_optimizer("adafactor")
    t_init, _ = TO.make_optimizer("adafactor")
    whole, _ = t_update(_port(grads), t_init(_port(params)), _port(params), torch.tensor(1e-3))
    per_layer = []
    for layer in range(2):
        p1, g1 = (
            tree_map(lambda x: torch.tensor(np.array(x[layer : layer + 1])), t["layers"])
            for t in (params, grads)
        )
        u1, _ = t_update(g1, t_init(p1), p1, torch.tensor(1e-3))
        per_layer.append(u1["w"])
    assert not torch.allclose(torch.cat(per_layer), whole["layers"]["w"], rtol=1e-3)


def test_clip_global_norm_and_schedule_match_reference():
    grads = _tree(3)
    r_clipped, r_norm = RO.clip_by_global_norm(jax.tree_util.tree_map(jnp.asarray, grads), 1.0)
    t_clipped, t_norm = TO.clip_by_global_norm(_port(grads), 1.0)
    np.testing.assert_allclose(float(t_norm), float(r_norm), rtol=RTOL)
    _close(t_clipped, r_clipped)
    np.testing.assert_allclose(float(TO.global_norm(t_clipped)), 1.0, rtol=1e-5)
    kw = dict(base_lr=3e-4, warmup_steps=20, total_steps=100)
    for step in (0, 1, 7, 19, 20, 21, 55, 99, 100, 150):
        want = float(RO.lr_schedule(jnp.int32(step), **kw))
        got = float(TO.lr_schedule(torch.tensor(step, dtype=torch.int32), **kw))
        np.testing.assert_allclose(got, want, rtol=RTOL, err_msg=str(step))


def test_int8_error_feedback_matches_reference():
    params = _tree(0)
    r_ef = RC.init_ef_state(jax.tree_util.tree_map(jnp.asarray, params))
    t_ef = TC.init_ef_state(_port(params))
    for step in range(3):
        grads = _tree(step + 5)
        r_deq, r_ef = RC.int8_ef_compress(jax.tree_util.tree_map(jnp.asarray, grads), r_ef)
        t_deq, t_ef = TC.int8_ef_compress(_port(grads), t_ef)
        _close(t_deq, r_deq, atol=1e-7)
        _close(t_ef, r_ef, atol=1e-7)


def test_int8_scale_spans_the_stacked_leaf():
    """The layer at 1/100 the scale keeps its own codes only if the scale
    were taken per layer; over the stacked leaf it rounds to few codes."""
    w = torch.tensor(_tree(0)["layers"]["w"])
    deq, _ = TC.int8_ef_compress({"w": w.clone()}, {"w": torch.zeros_like(w)})
    codes_small_layer = torch.unique(torch.round(deq["w"][0] / (w.abs().max() / 127))).numel()
    assert codes_small_layer <= 5
    per_layer = torch.stack([TC._quantize(x)[0].float() * TC._quantize(x)[1] for x in w])
    assert not torch.allclose(per_layer, deq["w"])
