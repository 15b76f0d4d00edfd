"""The port's hybrid stack (jamba-1.5-large-398b) against the JAX package on
the CPU: the training forward's logits and aux loss at one and two
super-blocks, float32 and bfloat16, with the weights, pairs and tolerances
of ``tests/test_torch_hybrid.py`` (its docstring gives them and their
reasons)."""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.models import model as RM  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from test_torch_hybrid import BF16_OWN_GAP, BLOCKS, DTYPES, TOL, _np, _pair  # noqa: E402


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("blocks", list(BLOCKS), ids=list(BLOCKS))
def test_forward_train_matches_reference(blocks, dtype, record_property):
    cfg, model, rcfg, params = _pair(BLOCKS[blocks], dtype)
    jdt = DTYPES[dtype][1]
    tokens = np.random.default_rng(3).integers(0, cfg.vocab_size, (2, 64))
    want, want_aux = jax.jit(
        functools.partial(RM.forward_train, rcfg, compute_dtype=jdt, remat_policy="none")
    )(params, {"tokens": jnp.asarray(tokens, jnp.int32)})
    with torch.no_grad():
        got, aux = M.forward_train(model, torch.from_numpy(tokens), remat_policy="none")
    gap = float(np.abs(_np(got) - _np(want)).max())
    record_property("max_abs_logit_gap", gap)
    if dtype == "bfloat16":  # held to the float32 function as the reference's bf16 run is
        want32, _ = jax.jit(
            functools.partial(
                RM.forward_train, rcfg, compute_dtype=jnp.float32, remat_policy="none"
            )
        )(params, {"tokens": jnp.asarray(tokens, jnp.int32)})
        own = float(np.abs(_np(want) - _np(want32)).max())
        bound = max(TOL[dtype], BF16_OWN_GAP * own)
        assert float(np.abs(_np(got) - _np(want32)).max()) <= bound, (gap, own)
        np.testing.assert_allclose(float(aux), float(want_aux), rtol=1e-2)
        return
    np.testing.assert_allclose(_np(got), _np(want), rtol=0, atol=TOL[dtype])
    np.testing.assert_allclose(float(aux), float(want_aux), rtol=1e-5)
