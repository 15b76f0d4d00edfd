"""The port's configs, norms, rotary embeddings, masks, MLP and init against
the JAX package on the same numpy inputs (float32, within 1e-6 unless said)."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.configs import smoke as ref_smoke  # noqa: E402
from repro.models import attention as ref_attn  # noqa: E402
from repro.models import layers as ref_layers  # noqa: E402
from repro.models import mlp as ref_mlp  # noqa: E402
from repro_torch.configs import get_config, list_archs, smoke  # noqa: E402
from repro_torch.configs.base import ModelConfig  # noqa: E402
from repro_torch.models import layers, mlp  # noqa: E402
from repro_torch.models.attention import mask_bias  # noqa: E402
from repro_torch.models.model import forward_train, init_params  # noqa: E402

ARCH = "stablelm-1.6b"


def _np(x):
    return np.asarray(x, np.float32)


@pytest.mark.parametrize("overrides", [{}, {"num_kv_heads": 2}])
def test_configs_match_reference(overrides):
    ref = ref_get_config(ARCH)
    assert dataclasses.asdict(get_config(ARCH)) == dataclasses.asdict(ref)
    assert get_config(ARCH).num_params() == ref.num_params()
    got = smoke(get_config(ARCH), **overrides)
    assert dataclasses.asdict(got) == dataclasses.asdict(ref_smoke(ref, **overrides))
    assert got == ModelConfig(**dataclasses.asdict(ref_smoke(ref, **overrides)))


@pytest.mark.parametrize(
    "arch",
    [
        "deepseek-v2-lite-16b",
        "whisper-base",
        "mamba2-1.3b",
        "h2o-danube-1.8b",
        "jamba-1.5-large-398b",
    ],
)
def test_later_slices_raise(arch):
    """No config of the reference is refused any more: each is in the
    registry, equal to the reference's, and builds a training model
    (float32 parameters with gradients); the SSM, hybrid and
    encoder-decoder stacks' training forwards run and backpropagate
    (whisper's from frames of its smoke encoder length)."""
    assert list_archs() == [
        ARCH,
        "olmoe-1b-7b",
        "deepseek-v2-lite-16b",
        "deepseek-7b",
        "chameleon-34b",
        "stablelm-3b",
        "h2o-danube-1.8b",
        "mamba2-1.3b",
        "jamba-1.5-large-398b",
        "whisper-base",
    ]
    cfg = ModelConfig(**dataclasses.asdict(ref_get_config(arch)))
    assert get_config(arch) == cfg
    model = init_params(smoke(cfg), device="cpu", param_dtype=torch.float32)
    assert all(p.requires_grad and p.dtype == torch.float32 for p in model.parameters())
    if cfg.ssm_state_dim or cfg.is_encoder_decoder:  # served and trained
        kw = {}
        if cfg.is_encoder_decoder:
            kw["frames"] = torch.ones(1, smoke(cfg).encoder_seq_len, smoke(cfg).d_model)
        logits, aux = forward_train(model, torch.zeros(1, 32, dtype=torch.int64), **kw)
        assert logits.shape == (1, 32, smoke(cfg).padded_vocab)
        (logits.float().square().mean() + aux).backward()
        assert all(p.grad is not None and torch.isfinite(p.grad).all() for p in model.parameters())


@pytest.mark.parametrize("shape", [(3, 64), (2, 5, 2048)])
def test_norms_match_reference(shape):
    rng = np.random.default_rng(1)
    x = rng.normal(size=shape).astype(np.float32) * 3 + 0.5
    scale = rng.normal(size=shape[-1:]).astype(np.float32)
    bias = rng.normal(size=shape[-1:]).astype(np.float32)
    t = torch.from_numpy
    got = layers.layernorm(t(x), t(scale), t(bias))
    want = ref_layers.layernorm(jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias))
    np.testing.assert_allclose(got.numpy(), _np(want), rtol=1e-6, atol=1e-6)
    got = layers.rmsnorm(t(x), t(scale))
    want = ref_layers.rmsnorm(jnp.asarray(x), jnp.asarray(scale))
    np.testing.assert_allclose(got.numpy(), _np(want), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("fraction,head_dim", [(1.0, 16), (0.25, 64), (0.25, 16), (0.5, 10)])
def test_rope_matches_reference(fraction, head_dim):
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, 9, 3, head_dim)).astype(np.float32)
    pos = rng.integers(0, 2048, (2, 9))
    got = layers.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), fraction=fraction)
    want = ref_layers.apply_rope(jnp.asarray(x), jnp.asarray(pos), fraction=fraction)
    np.testing.assert_allclose(got.numpy(), _np(want), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("causal,window", [(True, 0), (False, 0), (True, 4)])
def test_mask_bias_matches_reference(causal, window):
    rng = np.random.default_rng(3)
    q = rng.integers(0, 12, (2, 5))
    kv = rng.integers(-1, 12, (2, 12))
    got = mask_bias(torch.from_numpy(q), torch.from_numpy(kv), causal=causal, window=window)
    want = ref_attn._mask_bias(jnp.asarray(q), jnp.asarray(kv), causal=causal, window=window)
    np.testing.assert_array_equal(got.numpy(), _np(want))


@pytest.mark.parametrize("mlp_type", ["swiglu", "gelu"])
def test_mlp_matches_reference(mlp_type):
    cfg = smoke(get_config(ARCH), mlp_type=mlp_type)
    rng = np.random.default_rng(4)
    params = {
        k: rng.normal(size=s.shape).astype(np.float32) / 4
        for k, s in mlp.mlp_specs(cfg, cfg.d_ff).items()
    }
    x = rng.normal(size=(2, 7, cfg.d_model)).astype(np.float32)
    m = mlp.MLP(cfg, cfg.d_ff, torch.float32)
    for k, v in params.items():
        getattr(m, k).data.copy_(torch.from_numpy(v))
    got = m(torch.from_numpy(x))
    ref_cfg = ref_smoke(ref_get_config(ARCH), mlp_type=mlp_type)
    want = ref_mlp.mlp(ref_cfg, {k: jnp.asarray(v) for k, v in params.items()}, jnp.asarray(x))
    np.testing.assert_allclose(got.detach().numpy(), _np(want), rtol=1e-5, atol=1e-5)


def test_init_follows_reference_rules_and_is_stable():
    cfg = smoke(get_config(ARCH))
    a = init_params(cfg, 0, device="cpu", compute_dtype=torch.float32).state_tree()
    b = init_params(cfg, 0, device="cpu", compute_dtype=torch.float32).state_tree()
    c = init_params(cfg, 1, device="cpu", compute_dtype=torch.float32).state_tree()
    np.testing.assert_array_equal(a["layers"]["attn"]["wq"], b["layers"]["attn"]["wq"])
    assert not np.array_equal(a["layers"]["attn"]["wq"], c["layers"]["attn"]["wq"])
    # fan_in reads the second-to-last dim, as the reference's init does
    wq = a["layers"]["attn"]["wq"]  # [L, d, h, k]
    assert abs(wq.std() - wq.shape[-2] ** -0.5) < 0.05 * wq.shape[-2] ** -0.5
    assert abs(a["embed"].std() - 0.02) < 0.002
    np.testing.assert_array_equal(a["layers"]["attn_norm"]["scale"], 1.0)
    np.testing.assert_array_equal(a["final_norm"]["bias"], 0.0)
