"""Training the encoder-decoder stack (whisper-base) in the port against the
JAX package on the CPU, at ``smoke(whisper-base, encoder_seq_len=100)``
(two encoder and two decoder layers over 100 frames: the flash kernel's
last key tile ragged), the same parameters on both sides (the port's seeded
init, carried to the reference through ``interop.train_state_to_reference``)
and the same frames in the batch, drawn with numpy from a seed:

  * ``forward_train``'s logits against the reference's, float32 within 5e-4
    and bfloat16 within 0.5 (``tests/test_torch_encdec.py``'s reasons);
  * every gradient leaf of ``forward_train`` + cross-entropy (encoder,
    cross-attention and decoder leaves) against ``jax.value_and_grad`` of
    the reference run in float64 (x64 only inside the test), within 5e-4
    of the leaf's largest entry;
  * three AdamW ``train_step``s (the first at LR 0) against the reference's
    jitted step: losses within 1e-5, the parameter norms within 1e-4, the
    gradient norms within 5e-4, every parameter within 1e-3 after the two
    updates;

The float32 bounds were set after a first run, against float32's own
error at this size (measured against the reference in float64): the
reference's own float32 logits are 1.56e-4 from its float64 ones (of order
4), the port's 1.10e-4, and the two float32 runs 2.2e-4 apart; the
reference's own float32 gradients are up to 2.0e-4 of a leaf's largest
entry from float64 (``embed``), the port's up to 2.2e-4
(``attn_norm.bias``); the third step's gradient norms (~32) 1.1e-4 apart.
Twice the dense stacks' bounds (``tests/test_torch_train_dense.py``)
covers both sides' float32 error with a margin.
  * the remat policies give the same values bit for bit (each encoder
    layer is checkpointed on its own under any policy);
  * the cost model's counts at full size against the reference's
    encoder-decoder terms;
  * the launcher refuses whisper: the token pipeline yields no frames.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.analysis import costs as R  # noqa: E402
from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.configs import smoke as ref_smoke  # noqa: E402
from repro.configs.base import SHAPES_BY_NAME as REF_SHAPES  # noqa: E402
from repro.configs.base import RunConfig as RefRunConfig  # noqa: E402
from repro.models import model as RM  # noqa: E402
from repro.models.layers import cross_entropy as ref_cross_entropy  # noqa: E402
from repro.train import step as RS  # noqa: E402
from repro_torch.analysis import costs as C  # noqa: E402
from repro_torch.configs import get_config, smoke  # noqa: E402
from repro_torch.configs.base import SHAPES_BY_NAME, RunConfig  # noqa: E402
from repro_torch.interop import train_state_to_reference  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.train import step as S  # noqa: E402
from repro_torch.tree import leaves_with_path  # noqa: E402

ARCH = "whisper-base"
ENC = 100
TOL = {"float32": 5e-4, "bfloat16": 0.5}
GRAD_TOL = 5e-4  # of a leaf's largest entry, against the float64 reference
LOSS_TOL = 1e-5
NORM_TOL = 1e-4
GRAD_NORM_TOL = 5e-4


def _batch(cfg, seed=0, B=2, S_=24):
    rng = np.random.default_rng(seed)
    return {
        "tokens": rng.integers(0, cfg.vocab_size, (B, S_)).astype(np.int32),
        "labels": rng.integers(0, cfg.vocab_size, (B, S_)).astype(np.int32),
        "frames": rng.normal(size=(B, cfg.encoder_seq_len, cfg.d_model)).astype(np.float32),
    }


def _pair(compute_dtype="float32", **run_kw):
    cfg = smoke(get_config(ARCH), encoder_seq_len=ENC)
    run = RunConfig(compute_dtype=compute_dtype, **run_kw)
    state = S.init_train_state(cfg, run, 0, device="cpu")
    return cfg, run, state, ref_smoke(ref_get_config(ARCH), encoder_seq_len=ENC)


def _np(x):
    return np.asarray(x, np.float32) if not torch.is_tensor(x) else x.detach().float().numpy()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_train_matches_reference(dtype, record_property):
    cfg, run, state, rcfg = _pair(dtype, remat_policy="none")
    params = jax.tree_util.tree_map(jnp.asarray, train_state_to_reference(state)["params"])
    batch = _batch(cfg)
    want, _ = jax.jit(
        lambda p, b: RM.forward_train(
            rcfg, p, b, compute_dtype=getattr(jnp, dtype), remat_policy="none"
        )
    )(params, {k: jnp.asarray(batch[k]) for k in ("tokens", "frames")})
    with torch.no_grad():
        got, aux = M.forward_train(
            state.model,
            torch.from_numpy(batch["tokens"]),
            frames=torch.from_numpy(batch["frames"]),
            remat_policy="none",
        )
    assert got.shape == (2, 24, cfg.padded_vocab) and float(aux) == 0.0
    gap = float(np.abs(_np(got) - _np(want)).max())
    record_property("max_abs_logit_gap", gap)
    assert gap <= TOL[dtype]
    with pytest.raises(ValueError, match="needs frames"):
        M.forward_train(state.model, torch.from_numpy(batch["tokens"]))


def test_gradients_match_jax_grad():
    cfg, run, state, rcfg = _pair(remat_policy="full")
    tree = train_state_to_reference(state)["params"]
    batch = _batch(cfg)

    def loss_fn(p):
        inputs = {"tokens": jnp.asarray(batch["tokens"]), "frames": jnp.asarray(batch["frames"])}
        logits, _ = RM.forward_train(
            rcfg, p, inputs, compute_dtype=jnp.float64, remat_policy="none"
        )
        return ref_cross_entropy(logits, jnp.asarray(batch["labels"]), rcfg.vocab_size)

    with jax.enable_x64(True):
        params = jax.tree_util.tree_map(lambda x: jnp.asarray(x, jnp.float64), tree)
        loss, want = jax.value_and_grad(loss_fn)(params)
        loss, want = float(loss), jax.tree_util.tree_map(np.asarray, want)
    grads, metrics = S.make_grad_fn(cfg, run)(state, batch)
    np.testing.assert_allclose(float(metrics["loss"]), loss, rtol=LOSS_TOL)
    want = dict(leaves_with_path(want))
    got = dict(leaves_with_path(grads))
    assert sorted(got) == sorted(want)
    assert got["['encoder']['layers']['attn']['wq']"].shape == (2, 64, 4, 16)
    assert got["['layers']['cross']['wk']"].shape == (2, 64, 4, 16)
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
        tols = {"loss": LOSS_TOL, "lr": 1e-6, "grad_norm": GRAD_NORM_TOL, "param_norm": NORM_TOL}
        for key, tol in tols.items():
            np.testing.assert_allclose(
                float(m[key]), float(rm[key]), rtol=tol, atol=1e-9, err_msg=f"step {i} {key}"
            )
    assert int(state.step) == int(rstate["step"]) == 3
    want = dict(leaves_with_path(jax.tree_util.tree_map(np.asarray, rstate["params"])))
    ours = train_state_to_reference(state)
    for path, x in leaves_with_path(ours["params"]):
        np.testing.assert_allclose(x, want[path], rtol=0, atol=1e-3, err_msg=path)
    theirs = dict(leaves_with_path(jax.tree_util.tree_map(np.asarray, rstate["opt"])))
    assert sorted(p for p, _ in leaves_with_path(ours["opt"])) == sorted(theirs)


def test_remat_policies_give_the_same_values():
    batch = _batch(_pair()[0])
    out = {}
    for policy in ("none", "minimal", "full"):
        cfg, run, state, _ = _pair(remat_policy=policy)
        grads, metrics = S.make_grad_fn(cfg, run)(state, batch)
        out[policy] = (float(metrics["loss"]), [g.clone() for _, g in leaves_with_path(grads)])
    for policy in ("minimal", "full"):
        assert out[policy][0] == out["none"][0]
        assert all(torch.equal(a, b) for a, b in zip(out[policy][1], out["none"][1]))


@pytest.mark.parametrize("kind,B,S,cache_len", [("train", 8, 4096, 0), ("decode", 8, 1, 448)])
def test_cost_counts_match_reference_at_full_size(kind, B, S, cache_len):
    """The encoder-decoder terms at whisper-base's full size: the encoder's
    attention over 1500 frames and FFN outside decode, cross-attention in
    every decoder layer; parameters, active parameters and step FLOPs."""
    cfg, rcfg = get_config(ARCH), ref_get_config(ARCH)
    assert C.active_params(cfg) == R.active_params(rcfg) == cfg.num_params()
    for triangular in (False, True):
        got = C.forward_flops(cfg, B, S, kind=kind, cache_len=cache_len, triangular=triangular)
        want = R.forward_flops(rcfg, B, S, kind=kind, cache_len=cache_len, triangular=triangular)
        assert got == want > 0
    shape, rshape = SHAPES_BY_NAME["train_4k"], REF_SHAPES["train_4k"]
    assert C.step_flops(cfg, shape) == R.step_flops(rcfg, rshape)
    # the encoder's 6 layers over 1500 frames count outside decode only
    enc = 6 * (C._attn_flops(cfg, 1, 1500, 1500) + C._ffn_flops(cfg, 1, 1500))
    prefill = C.forward_flops(cfg, 1, 64, kind="prefill")
    assert prefill - enc == C.forward_flops(cfg, 1, 64, kind="decode", cache_len=64)


def test_launcher_refuses_whisper(capsys):
    with pytest.raises(SystemExit):
        launch_train.main(["--arch", ARCH, "--smoke", "--device", "cpu", "--steps", "2"])
    assert "frames" in capsys.readouterr().err
