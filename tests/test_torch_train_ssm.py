"""Training an SSM stack (mamba2-1.3b: SSD, tied embeddings) in the port
against the JAX package on the CPU, float32 compute, the same parameters on
both sides (the port's seeded init, carried to the reference through
``interop.train_state_to_reference``), with ``A_log`` and ``dt_bias`` drawn
off their init constants so that their gradients take part:

  * every gradient leaf of ``forward_train`` + cross-entropy against
    ``jax.value_and_grad`` of the reference run in float64 (x64 turned on
    only inside the test), within 2e-4 of the leaf's largest entry
    (``tests/test_torch_train_dense.py``'s bound: the port's float32 against
    the float64 function);
  * three AdamW ``train_step``s against the reference's jitted step: losses
    within 1e-5, the norms within 1e-4, every parameter within 1e-3 after
    the two updates (``tests/test_torch_train_step.py``'s constants);
  * the three remat policies against each other, bit for bit;
  * the SSD's masked exponent: with ``dt`` large enough that a chunk's decay
    passes ~88, ``exp`` of the segment sums above the diagonal overflows
    float32.  The port's forward stays what it was (bit for bit against the
    unmasked form's values) and its gradients stay finite, within 1e-4 of
    each gradient's largest entry of float64 autograd of the masked form
    (a plain quadratic form written here); the reference's gradients are
    NaN there (ROADMAP Queue 3, JAX-reference faults) and are held to the
    port's wherever they are finite;
  * ``python -m repro_torch.launch.train --arch mamba2-1.3b --smoke
    --device cpu``: the loss falls.
"""

from unittest import mock

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.configs import smoke as ref_smoke  # noqa: E402
from repro.configs.base import RunConfig as RefRunConfig  # noqa: E402
from repro.models import model as RM  # noqa: E402
from repro.models import ssm as RS_ssm  # noqa: E402
from repro.models.layers import cross_entropy as ref_cross_entropy  # noqa: E402
from repro.train import step as RS  # noqa: E402
from repro_torch.configs import get_config, smoke  # noqa: E402
from repro_torch.configs.base import RunConfig  # noqa: E402
from repro_torch.interop import train_state_to_reference  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.models import ssm  # noqa: E402
from repro_torch.train import step as S  # noqa: E402
from repro_torch.tree import leaves_with_path  # noqa: E402

ARCH = "mamba2-1.3b"
GRAD_TOL = 2e-4  # of a leaf's largest entry, against the float64 reference
LOSS_TOL = 1e-5
NORM_TOL = 1e-4
OVERFLOW_GRAD_TOL = 1e-4  # of a gradient's largest entry, against float64


def _batch(cfg, seed=0, B=2, S_=64):
    rng = np.random.default_rng(seed)
    return {
        "tokens": rng.integers(0, cfg.vocab_size, (B, S_)).astype(np.int32),
        "labels": rng.integers(0, cfg.vocab_size, (B, S_)).astype(np.int32),
    }


def _pair(**run_kw):
    """A port train state of smoke(mamba2) (float32 compute) with ``A_log``
    and ``dt_bias`` drawn off their constants, and the reference's config."""
    cfg = smoke(get_config(ARCH))
    run = RunConfig(compute_dtype="float32", **run_kw)
    state = S.init_train_state(cfg, run, 0, device="cpu")
    rng = np.random.default_rng(5)
    with torch.no_grad():
        for k in ("A_log", "dt_bias"):
            leaf = state.params["layers"]["ssm"][k]
            leaf.copy_(torch.from_numpy(rng.normal(size=leaf.shape).astype(np.float32) * 0.5))
    return cfg, run, state, ref_smoke(ref_get_config(ARCH))


def test_gradients_match_jax_grad():
    cfg, run, state, rcfg = _pair(remat_policy="none")
    tree = train_state_to_reference(state)["params"]
    batch = _batch(cfg)

    def loss_fn(p):
        tokens = {"tokens": jnp.asarray(batch["tokens"])}
        logits, _ = RM.forward_train(
            rcfg, p, tokens, compute_dtype=jnp.float64, remat_policy="none"
        )
        return ref_cross_entropy(logits, jnp.asarray(batch["labels"]), rcfg.vocab_size)

    with jax.enable_x64(True):
        params = jax.tree_util.tree_map(lambda x: jnp.asarray(x, jnp.float64), tree)
        loss, want = jax.value_and_grad(loss_fn)(params)
        loss, want = float(loss), jax.tree_util.tree_map(np.asarray, want)
    grads, metrics = S.make_grad_fn(cfg, run)(state, batch)
    np.testing.assert_allclose(float(metrics["loss"]), loss, rtol=LOSS_TOL)
    assert float(metrics["aux_loss"]) == 0.0
    want = dict(leaves_with_path(want))
    got = dict(leaves_with_path(grads))
    assert sorted(got) == sorted(want) and "['lm_head']" not in got
    assert any("A_log" in path for path in got) and any("conv_x" in path for path in got)
    for path, g in got.items():
        scale = np.abs(want[path]).max()
        assert scale > 0, path
        np.testing.assert_allclose(
            g.numpy(), want[path], rtol=0, atol=GRAD_TOL * scale, err_msg=path
        )


def test_three_adamw_steps_match_reference():
    run_kw = dict(learning_rate=1e-3, warmup_steps=1, remat_policy="full")
    cfg, run, state, rcfg = _pair(**run_kw)
    rrun = RefRunConfig(compute_dtype="float32", **run_kw)
    rstate = jax.tree_util.tree_map(jnp.asarray, train_state_to_reference(state))
    ref_step = jax.jit(RS.make_train_step(rcfg, rrun, total_steps=3))
    step = S.make_train_step(cfg, run, total_steps=3)
    for i in range(3):
        batch = _batch(cfg, seed=i)
        rstate, rm = ref_step(rstate, jax.tree_util.tree_map(jnp.asarray, batch))
        state, m = step(state, batch)
        tols = {"loss": LOSS_TOL, "lr": 1e-6, "grad_norm": NORM_TOL, "param_norm": NORM_TOL}
        for key, tol in tols.items():
            np.testing.assert_allclose(
                float(m[key]), float(rm[key]), rtol=tol, atol=1e-9, err_msg=f"step {i} {key}"
            )
    assert int(state.step) == int(rstate["step"]) == 3
    want = dict(leaves_with_path(jax.tree_util.tree_map(np.asarray, rstate["params"])))
    for path, x in leaves_with_path(train_state_to_reference(state)["params"]):
        np.testing.assert_allclose(x, want[path], rtol=0, atol=1e-3, err_msg=path)


def test_remat_policies_give_the_same_values():
    out = {}
    for policy in ("none", "minimal", "full"):
        cfg, run, state, _ = _pair(remat_policy=policy)
        grads, metrics = S.make_grad_fn(cfg, run)(state, _batch(cfg))
        out[policy] = (float(metrics["loss"]), [g.clone() for _, g in leaves_with_path(grads)])
    for policy in ("minimal", "full"):
        assert out[policy][0] == out["none"][0]
        assert all(torch.equal(a, b) for a, b in zip(out[policy][1], out["none"][1]))


def _overflow_inputs(seed=0, b=2, s=64, h=4, p=8, g=1, n=16):
    """SSD inputs whose per-step decay is 3..5 (``dt`` large), so that a
    32-token chunk's cumulative decay reaches ~130: ``exp`` of the segment
    sums above the diagonal overflows float32 there."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, s, h, p))
    a_log = -rng.uniform(3.0, 5.0, size=(b, s, h))
    B = rng.normal(size=(b, s, g, n)) * 0.5
    C = rng.normal(size=(b, s, g, n)) * 0.5
    w = rng.normal(size=(b, s, h, p))  # the output's cotangent
    return x, a_log, B, C, w


def _quadratic_masked(x, a_log, B, C):
    """The SSD function as one masked quadratic form over the whole
    sequence (float64): ``y_t = sum_{s <= t} (C_t . B_s) exp(la_t - la_s) x_s``
    with ``-inf`` above the diagonal before the exponent."""
    la = torch.cumsum(a_log, dim=1)  # [b, s, h]
    seg = la[:, :, None, :] - la[:, None, :, :]  # [b, t, s, h]
    mask = torch.ones(seg.shape[1:3], dtype=torch.bool).tril()[None, :, :, None]
    decay = torch.exp(seg.masked_fill(~mask, -torch.inf))
    G = torch.einsum("btgn,bsgn->bts", C, B)
    return torch.einsum("bts,btsh,bshp->bthp", G, decay, x)


def test_ssd_gradients_stay_finite_where_the_triangle_overflows():
    x, a_log, B, C, w = _overflow_inputs()
    la = np.cumsum(a_log[:, :32], axis=1)
    assert (la[:, 0] - la[:, -1]).max() > 88  # exp overflows above the diagonal
    f32 = [torch.tensor(t, dtype=torch.float32, requires_grad=True) for t in (x, a_log, B, C)]
    y, _ = ssm.ssd_chunked(*f32, 32)
    (y * torch.tensor(w, dtype=torch.float32)).sum().backward()
    got = [t.grad for t in f32]
    assert all(torch.isfinite(g).all() for g in got)

    # the forward is the unmasked form's, value for value (exp(seg) where kept)
    with torch.no_grad():
        y_unmasked = _unmasked_ssd(*[t.detach() for t in f32], 32)
    assert torch.equal(y, y_unmasked)

    f64 = [torch.tensor(t, dtype=torch.float64, requires_grad=True) for t in (x, a_log, B, C)]
    y64 = _quadratic_masked(*f64)
    np.testing.assert_allclose(y.detach().numpy(), y64.detach().numpy(), rtol=0, atol=1e-5)
    (y64 * torch.tensor(w)).sum().backward()
    for name, g, t in zip(("x", "a_log", "B", "C"), got, f64):
        want = t.grad.numpy()
        np.testing.assert_allclose(
            g.numpy(), want, rtol=0, atol=OVERFLOW_GRAD_TOL * np.abs(want).max(), err_msg=name
        )

    # the reference exponentiates the unmasked segment sums: its gradients
    # are NaN there; where they are finite they are the port's
    def ref_loss(*args):
        y, _ = RS_ssm.ssd_chunked(*args, 32)
        return (y * jnp.asarray(w, jnp.float32)).sum()

    ref = jax.grad(ref_loss, argnums=(0, 1, 2, 3))(
        *(jnp.asarray(t, jnp.float32) for t in (x, a_log, B, C))
    )
    ref = [np.asarray(r) for r in ref]
    assert any(np.isnan(r).any() for r in ref)
    for name, g, r in zip(("x", "a_log", "B", "C"), got, ref):
        ok = np.isfinite(r)
        scale = np.abs(g.numpy()).max()
        np.testing.assert_allclose(
            g.numpy()[ok], r[ok], rtol=0, atol=OVERFLOW_GRAD_TOL * scale, err_msg=name
        )


def _unmasked_ssd(x, a_log, B, C, chunk):
    """``ssd_chunked`` with the reference's unmasked exponent (forward
    only): the ``-inf`` fill before ``exp`` left out."""
    real = torch.Tensor.masked_fill

    def keep(t, mask, value):
        return t if value == -torch.inf else real(t, mask, value)

    with mock.patch.object(torch.Tensor, "masked_fill", keep):
        return ssm.ssd_chunked(x, a_log, B, C, chunk)[0]


def test_launcher_trains_mamba2(capsys):
    launch_train.main(["--arch", ARCH, "--smoke", "--device", "cpu", "--steps", "30"])
    line = capsys.readouterr().out.strip().splitlines()[-1]
    fields = dict(f.split("=", 1) for f in line.split() if "=" in f)
    assert fields["arch"] == f"{ARCH}-smoke" and fields["steps"] == "30"
    assert float(fields["loss[-1]"]) < float(fields["loss[0]"])
