"""The port's train step against the JAX package's on the CPU, float32
compute, the same parameters on both sides (the port's seeded init, carried
to the reference through ``interop.train_state_to_reference``):

  * gradients of ``forward_train`` + cross-entropy (+ the MoE aux loss)
    against ``jax.grad`` for smoke(stablelm-1.6b) and smoke(olmoe-1b-7b),
    leaf by leaf within 1e-4 of the leaf's largest entry (float32 sums in
    another order: up to 2.1e-5 of it seen, on an FFN weight);
  * three ``train_step``s of each optimizer (AdamW; Adafactor with int8
    error feedback): losses within 1e-5 (relative), the LR within 1e-6;
    the gradient and parameter norms and the aux loss within 1e-4, and the
    parameters within 1e-3 absolute after two steps at LR 1e-3 (the first
    step's LR is 0): a last-bit gradient difference flips the sign of
    Adam's normalized update of a near-zero entry, or an int8 code at a
    rounding midpoint, and moves that entry by about the LR;
  * two microbatches against one, and the three remat policies against each
    other, within the port.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.configs import smoke as ref_smoke  # noqa: E402
from repro.configs.base import RunConfig as RefRunConfig  # noqa: E402
from repro.models import model as RM  # noqa: E402
from repro.models.layers import cross_entropy as ref_cross_entropy  # noqa: E402
from repro.train import step as RS  # noqa: E402
from repro_torch.configs import get_config, smoke  # noqa: E402
from repro_torch.configs.base import RunConfig  # noqa: E402
from repro_torch.interop import train_state_to_reference  # noqa: E402
from repro_torch.train import step as S  # noqa: E402
from repro_torch.tree import leaves_with_path  # noqa: E402

GRAD_TOL = 1e-4
LOSS_TOL = 1e-5
NORM_TOL = 1e-4


def _batch(cfg, seed=0, B=2, S_=24):
    rng = np.random.default_rng(seed)
    return {
        "tokens": rng.integers(0, cfg.vocab_size, (B, S_)).astype(np.int32),
        "labels": rng.integers(0, cfg.vocab_size, (B, S_)).astype(np.int32),
    }


def _pair(arch, **run_kw):
    cfg = smoke(get_config(arch))
    run = RunConfig(compute_dtype="float32", **run_kw)
    state = S.init_train_state(cfg, run, 0, device="cpu")
    return cfg, run, state, ref_smoke(ref_get_config(arch))


@pytest.mark.parametrize("arch", ["stablelm-1.6b", "olmoe-1b-7b"])
def test_gradients_match_jax_grad(arch):
    cfg, run, state, rcfg = _pair(arch, remat_policy="none")
    params = jax.tree_util.tree_map(jnp.asarray, train_state_to_reference(state)["params"])
    batch = _batch(cfg)

    def loss_fn(p):
        tokens = {"tokens": jnp.asarray(batch["tokens"])}
        logits, aux = RM.forward_train(
            rcfg, p, tokens, compute_dtype=jnp.float32, remat_policy="none"
        )
        loss = ref_cross_entropy(logits, jnp.asarray(batch["labels"]), rcfg.vocab_size)
        return loss + rcfg.moe_aux_loss_weight * aux, (loss, aux)

    (_, (loss, aux)), want = jax.value_and_grad(loss_fn, has_aux=True)(params)
    grads, metrics = S.make_grad_fn(cfg, run)(state, batch)
    np.testing.assert_allclose(float(metrics["loss"]), float(loss), rtol=LOSS_TOL)
    np.testing.assert_allclose(float(metrics["aux_loss"]), float(aux), rtol=LOSS_TOL)
    if cfg.moe_num_experts:
        assert float(aux) > 0
    want = dict(leaves_with_path(jax.tree_util.tree_map(np.asarray, want)))
    got = dict(leaves_with_path(grads))
    assert sorted(got) == sorted(want)
    for path, g in got.items():
        scale = np.abs(want[path]).max()
        np.testing.assert_allclose(
            g.numpy(), want[path], rtol=0, atol=GRAD_TOL * scale, err_msg=path
        )


@pytest.mark.parametrize(
    "arch,run_kw",
    [
        ("stablelm-1.6b", {}),
        ("olmoe-1b-7b", {}),
        ("stablelm-1.6b", {"optimizer": "adafactor", "grad_compression": "int8_ef"}),
    ],
    ids=["stablelm-adamw", "olmoe-adamw", "stablelm-adafactor-int8ef"],
)
def test_three_train_steps_match_reference(arch, run_kw):
    run_kw = dict(learning_rate=1e-3, warmup_steps=1, remat_policy="full", **run_kw)
    cfg, run, state, rcfg = _pair(arch, **run_kw)
    rrun = RefRunConfig(compute_dtype="float32", **run_kw)
    rstate = jax.tree_util.tree_map(jnp.asarray, train_state_to_reference(state))
    ref_step = jax.jit(RS.make_train_step(rcfg, rrun, total_steps=3))
    step = S.make_train_step(cfg, run, total_steps=3)
    for i in range(3):
        batch = _batch(cfg, seed=i)
        rstate, rm = ref_step(rstate, jax.tree_util.tree_map(jnp.asarray, batch))
        state, m = step(state, batch)
        tols = {"loss": LOSS_TOL, "lr": 1e-6, "aux_loss": NORM_TOL, "grad_norm": NORM_TOL}
        for key, tol in dict(tols, param_norm=NORM_TOL).items():
            np.testing.assert_allclose(
                float(m[key]), float(rm[key]), rtol=tol, atol=1e-9, err_msg=f"step {i} {key}"
            )
    assert int(state.step) == int(rstate["step"]) == 3
    want = dict(leaves_with_path(jax.tree_util.tree_map(np.asarray, rstate["params"])))
    for path, x in leaves_with_path(train_state_to_reference(state)["params"]):
        np.testing.assert_allclose(x, want[path], rtol=0, atol=1e-3, err_msg=path)


def test_microbatches_match_one_batch():
    cfg, run1, s1, _ = _pair("stablelm-1.6b")
    _, run2, s2, _ = _pair("stablelm-1.6b", microbatches=2)
    batch = _batch(cfg, B=4)
    g1, m1 = S.make_grad_fn(cfg, run1)(s1, batch)
    g2, m2 = S.make_grad_fn(cfg, run2)(s2, batch)
    np.testing.assert_allclose(float(m2["loss"]), float(m1["loss"]), rtol=1e-6)
    for (path, a), (_, b) in zip(leaves_with_path(g1), leaves_with_path(g2)):
        torch.testing.assert_close(b, a, rtol=1e-5, atol=1e-6 * float(a.abs().max()), msg=path)


@pytest.mark.parametrize("arch", ["stablelm-1.6b", "olmoe-1b-7b"])
def test_remat_policies_give_the_same_values(arch):
    batch = _batch(smoke(get_config(arch)))
    out = {}
    for policy in ("none", "minimal", "full"):
        cfg, run, state, _ = _pair(arch, remat_policy=policy)
        grads, metrics = S.make_grad_fn(cfg, run)(state, batch)
        out[policy] = (float(metrics["loss"]), [g.clone() for _, g in leaves_with_path(grads)])
    for policy in ("minimal", "full"):
        assert out[policy][0] == out["none"][0]
        assert all(torch.equal(a, b) for a, b in zip(out[policy][1], out["none"][1]))


def test_model_parameters_are_views_of_the_stacked_leaves():
    cfg, run, state, _ = _pair("stablelm-1.6b")
    wq = state.params["layers"]["attn"]["wq"]
    for layer, blk in enumerate(state.model.layers):
        assert blk.attn.wq.data_ptr() == wq[layer].data_ptr()
        assert blk.attn.wq.grad.data_ptr() == state.grads["layers"]["attn"]["wq"][layer].data_ptr()
    step = S.make_train_step(cfg, run, total_steps=2)
    before = wq.clone()
    for seed in range(2):  # the first step's LR is 0
        step(state, _batch(cfg, seed))
    assert not torch.equal(state.model.layers[1].attn.wq.detach(), before[1])
    assert torch.equal(state.model.layers[1].attn.wq.detach(), wq[1])
