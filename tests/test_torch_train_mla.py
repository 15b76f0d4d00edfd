"""MLA training in the port against the JAX package on the CPU, on
``smoke(deepseek-v2-lite-16b)`` (kv_lora_rank 32, qk_nope 16, qk_rope 8,
v_head 16, 4 heads; 4 experts top-2 plus shared ones) in float32, the same
parameters on both sides (the port's seeded init, carried to the reference
through ``interop.train_state_to_reference``):

  * ``MLAAttention.forward_train`` against the reference's ``mla_attention``
    with no cache (the non-absorbed form), and its gradients to x and every
    weight against ``jax.grad`` of the same functional: float32 sums in
    another order, 2e-6 of the largest entry (``tests/test_torch_mla.py``'s
    float32 bound);
  * every gradient leaf of ``forward_train`` + cross-entropy + the MoE aux
    loss against ``jax.value_and_grad``, and three ``train_step``s (AdamW;
    Adafactor, whose factored moments cover the
    3-D ``w_uk``/``w_uv [r, h, k]``) against the reference's jitted step,
    with ``tests/test_torch_train_step.py``'s constants and reasons, and the
    optimizer state's leaves shaped as the reference's;
  * the three remat policies against each other, bit for bit;
  * ``python -m repro_torch.launch.train --arch deepseek-v2-lite-16b --smoke
    --device cpu``: the loss falls.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.configs import smoke as ref_smoke  # noqa: E402
from repro.configs.base import RunConfig as RefRunConfig  # noqa: E402
from repro.models import attention as RA  # noqa: E402
from repro.models import model as RM  # noqa: E402
from repro.models.layers import cross_entropy as ref_cross_entropy  # noqa: E402
from repro.train import step as RS  # noqa: E402
from repro_torch.configs import get_config, smoke  # noqa: E402
from repro_torch.configs.base import RunConfig  # noqa: E402
from repro_torch.interop import train_state_to_reference  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.models.attention import MLAAttention, mla_specs  # noqa: E402
from repro_torch.train import step as S  # noqa: E402
from repro_torch.tree import leaves_with_path  # noqa: E402

ARCH = "deepseek-v2-lite-16b"
GRAD_TOL = 1e-4
LOSS_TOL = 1e-5
NORM_TOL = 1e-4
LAYER_TOL = 2e-6


def _batch(cfg, seed=0, B=2, S_=24):
    rng = np.random.default_rng(seed)
    return {
        "tokens": rng.integers(0, cfg.vocab_size, (B, S_)).astype(np.int32),
        "labels": rng.integers(0, cfg.vocab_size, (B, S_)).astype(np.int32),
    }


def _pair(**run_kw):
    cfg = smoke(get_config(ARCH))
    run = RunConfig(compute_dtype="float32", **run_kw)
    state = S.init_train_state(cfg, run, 0, device="cpu")
    return cfg, run, state, ref_smoke(ref_get_config(ARCH))


def _gap(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.mark.parametrize("impl", ["kernel", "ref"])
def test_mla_forward_train_matches_reference(impl):
    """One layer, B 2 x S 13, float32 weights drawn by the reference's init
    rules; the output and the gradients of ``sum(out * w)``."""
    cfg, rcfg = smoke(get_config(ARCH)), ref_smoke(ref_get_config(ARCH))
    rng = np.random.default_rng(3)
    p = {}
    for name, spec in mla_specs(cfg).items():
        z = rng.standard_normal(spec.shape)
        if spec.init == "ones":  # kv_norm: near 1, not exactly
            p[name] = (1 + 0.1 * z).astype(np.float32)
        else:
            p[name] = (z / np.sqrt(spec.shape[-2])).astype(np.float32)
    B, S_ = 2, 13
    x = rng.standard_normal((B, S_, cfg.d_model)).astype(np.float32)
    w = rng.standard_normal((B, S_, cfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(S_, dtype=np.int32), (B, S_))

    mod = MLAAttention(cfg, torch.float32)
    with torch.no_grad():
        for name, val in p.items():
            getattr(mod, name).copy_(torch.from_numpy(val))
    for prm in mod.parameters():
        prm.requires_grad_(True)
    xt = torch.from_numpy(x).requires_grad_(True)
    out = mod.forward_train(xt, torch.from_numpy(pos.copy()), impl=impl)
    (out * torch.from_numpy(w)).sum().backward()

    def ref_fn(pj, xj):
        o, cache = RA.mla_attention(rcfg, pj, xj, jnp.asarray(pos))
        assert cache is None
        return jnp.sum(o * jnp.asarray(w)), o

    pj = {k: jnp.asarray(v) for k, v in p.items()}
    (_, want), (gp, gx) = jax.value_and_grad(ref_fn, argnums=(0, 1), has_aux=True)(
        pj, jnp.asarray(x)
    )
    assert out.shape == (B, S_, cfg.d_model)
    assert _gap(out.detach().numpy(), want) <= LAYER_TOL
    assert _gap(xt.grad.numpy(), gx) <= LAYER_TOL
    for name in p:
        assert _gap(getattr(mod, name).grad.numpy(), gp[name]) <= LAYER_TOL, name


def test_mla_gradients_match_jax_grad():
    cfg, run, state, rcfg = _pair(remat_policy="none")
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
    assert float(aux) > 0
    want = dict(leaves_with_path(jax.tree_util.tree_map(np.asarray, want)))
    got = dict(leaves_with_path(grads))
    assert sorted(got) == sorted(want)
    assert any("w_uk" in path for path in got) and any("kv_norm" in path for path in got)
    for path, g in got.items():
        scale = np.abs(want[path]).max()
        assert scale > 0, path
        np.testing.assert_allclose(
            g.numpy(), want[path], rtol=0, atol=GRAD_TOL * scale, err_msg=path
        )


@pytest.mark.parametrize(
    "run_kw",
    [{}, {"optimizer": "adafactor"}],
    ids=["adamw", "adafactor"],
)
def test_mla_three_train_steps_match_reference(run_kw):
    run_kw = dict(learning_rate=1e-3, warmup_steps=1, remat_policy="full", **run_kw)
    cfg, run, state, rcfg = _pair(**run_kw)
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
    # the optimizer's state carries over leaf for leaf, the 3-D MLA leaves' too
    ours = dict(leaves_with_path(train_state_to_reference(state)["opt"]))
    theirs = dict(leaves_with_path(jax.tree_util.tree_map(np.asarray, rstate["opt"])))
    assert sorted(ours) == sorted(theirs)
    for path, x in ours.items():
        assert x.shape == theirs[path].shape, path


def test_mla_remat_policies_give_the_same_values():
    batch = _batch(smoke(get_config(ARCH)))
    out = {}
    for policy in ("none", "minimal", "full"):
        cfg, run, state, _ = _pair(remat_policy=policy)
        grads, metrics = S.make_grad_fn(cfg, run)(state, batch)
        out[policy] = (float(metrics["loss"]), [g.clone() for _, g in leaves_with_path(grads)])
    for policy in ("minimal", "full"):
        assert out[policy][0] == out["none"][0]
        assert all(torch.equal(a, b) for a, b in zip(out[policy][1], out["none"][1]))


def test_mla_launcher_lowers_the_loss(capsys):
    launch_train.main(["--arch", ARCH, "--smoke", "--device", "cpu", "--steps", "30"])
    line = capsys.readouterr().out.strip().splitlines()[-1]
    fields = dict(f.split("=", 1) for f in line.split() if "=" in f)
    assert fields["arch"] == f"{ARCH}-smoke" and fields["steps"] == "30"
    assert float(fields["loss[-1]"]) < float(fields["loss[0]"])
