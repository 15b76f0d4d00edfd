"""The port's MoE layer against the JAX package on the same numpy inputs:
``fractal_permute``, routing with its capacity slots (``route`` against the
reference's ``_route``), the tie rule of its top-k, and ``moe_ffn``.

Expert choices and slots are integers and must equal the reference's bit for
bit; routing weights and the aux loss within 1e-6 (float32 softmax and sums
in another order).  ``moe_ffn`` within 1e-5 in float32; in bfloat16 within
0.05 on outputs of magnitude up to ~4, where one bf16 step is 0.0156: XLA
fuses the SiLU, its product and the weighted gathers where PyTorch rounds
between them (measured: at most 0.031, two steps, with the same routing on
both sides).
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.configs import smoke as ref_smoke  # noqa: E402
from repro.core.address import fractal_permute as ref_fractal_permute  # noqa: E402
from repro.models import moe as ref_moe  # noqa: E402
from repro_torch.configs import get_config, smoke  # noqa: E402
from repro_torch.core.address import fractal_permute  # noqa: E402
from repro_torch.data import (  # noqa: E402
    MOE_WHITENING_CAPACITY_FACTOR,
    moe_reference,
    moe_whitening_inputs,
    moe_whitening_record,
    unpack_decisions,
)
from repro_torch.models import moe  # noqa: E402

ARCH = "olmoe-1b-7b"
TOL_FFN = {"float32": 1e-5, "bfloat16": 0.05}
DTYPES = {"float32": (torch.float32, jnp.float32), "bfloat16": (torch.bfloat16, jnp.bfloat16)}
#: the reference's functions compiled once per shape (op by op, each of their
#: many small ops compiles on its own)
ref_route = jax.jit(ref_moe._route, static_argnums=0, static_argnames="whiten")
ref_moe_ffn = jax.jit(ref_moe.moe_ffn, static_argnums=0, static_argnames="whiten")


def _cfgs(full: bool, **overrides):
    """(port cfg, reference cfg): olmoe-1b-7b at full routing width (64
    experts, top-8) or its smoke reduction (4 experts, top-2)."""
    if full:
        return (
            dataclasses.replace(get_config(ARCH), **overrides),
            dataclasses.replace(ref_get_config(ARCH), **overrides),
        )
    return smoke(get_config(ARCH), **overrides), ref_smoke(ref_get_config(ARCH), **overrides)


def _route_both(cfg, ref_cfg, x, router, whiten):
    got = moe.route(cfg, torch.from_numpy(x), torch.from_numpy(router), whiten=whiten)
    want = ref_route(ref_cfg, jnp.asarray(x), jnp.asarray(router), whiten=whiten)
    return [t.numpy() for t in got], [np.asarray(a) for a in want]


def _assert_route_equal(got, want):
    np.testing.assert_array_equal(got[1], want[1], err_msg="top_e")
    np.testing.assert_array_equal(got[2], want[2], err_msg="slot")
    np.testing.assert_allclose(got[0], want[0], rtol=0, atol=1e-6, err_msg="top_w")
    np.testing.assert_allclose(got[3], want[3], rtol=0, atol=1e-6, err_msg="aux")


@pytest.mark.parametrize("n", [1, 7, 8, 64, 1000, 8192])
def test_fractal_permute_matches_reference(n):
    for seed in (0, 1, 5):
        got = fractal_permute(n, seed)
        np.testing.assert_array_equal(got, ref_fractal_permute(n, seed), err_msg=f"seed {seed}")
        np.testing.assert_array_equal(np.sort(got), np.arange(n))


def test_expert_capacity_matches_reference():
    for full in (True, False):
        for cf in (0.5, 1.25, 2.0):
            cfg, ref_cfg = _cfgs(full, moe_capacity_factor=cf)
            for s in (1, 7, 128, 517, 1024):
                assert moe.expert_capacity(cfg, s) == ref_moe.expert_capacity(ref_cfg, s)


@pytest.mark.parametrize("whiten", [True, False], ids=["fractal", "tail_drop"])
@pytest.mark.parametrize(
    "full,capacity_factor,shape",
    [
        (False, 1.25, (3, 37, 64)),
        (False, 0.5, (2, 64, 64)),
        (True, 1.25, (2, 96, 64)),
        (True, 0.5, (4, 512, 64)),
        (True, 1.25, (8, 1, 64)),  # a decode step: 8 groups of one token
    ],
    ids=["smoke", "smoke-drops", "full", "full-drops", "decode"],
)
def test_route_matches_reference(full, capacity_factor, shape, whiten):
    cfg, ref_cfg = _cfgs(full, moe_capacity_factor=capacity_factor)
    rng = np.random.default_rng(shape[1] + int(10 * capacity_factor))
    x = rng.normal(size=shape).astype(np.float32)
    router = rng.normal(size=(shape[2], cfg.moe_num_experts)).astype(np.float32)
    got, want = _route_both(cfg, ref_cfg, x, router, whiten)
    _assert_route_equal(got, want)
    C = moe.expert_capacity(cfg, shape[1])
    if capacity_factor < 1:
        assert (got[2] == C).any(), "the case was meant to drop"


@pytest.mark.parametrize("whiten", [True, False], ids=["fractal", "tail_drop"])
def test_route_on_the_benchmark_inputs(whiten):
    """The ``moe_whitening`` benchmark's inputs: equal to the reference, to
    its capture (what ``chip_smoke.py`` holds the card to) and its asserts."""
    cfg, ref_cfg = _cfgs(True, moe_capacity_factor=MOE_WHITENING_CAPACITY_FACTOR)
    x, router = moe_whitening_inputs()
    got, want = _route_both(cfg, ref_cfg, x, router, whiten)
    _assert_route_equal(got, want)
    capture = moe_reference()
    C = capture["capacity"]
    assert C == moe.expert_capacity(cfg, x.shape[1])
    rec = moe_whitening_record(got[1], got[2], C)
    want_rec = capture["fractal" if whiten else "tail_drop"]
    assert rec == want_rec
    np.testing.assert_array_equal(unpack_decisions(want_rec["slot"]), want[2])
    frac = rec["fraction_of_drops_in_last_quarter"]
    assert frac < 0.35 if whiten else frac > 0.4


@pytest.mark.parametrize("full", [False, True], ids=["smoke", "full"])
def test_route_ties_take_the_lower_expert(full):
    """Two pairs of router columns duplicated, so those experts' logits and
    probabilities are equal: the reference's top-k (``jax.lax.top_k``) puts
    the lower index first, and so must the port."""
    cfg, ref_cfg = _cfgs(full, moe_capacity_factor=0.5)
    E = cfg.moe_num_experts
    rng = np.random.default_rng(21)
    x = rng.normal(size=(2, 256, 64)).astype(np.float32)
    router = rng.normal(size=(64, E)).astype(np.float32)
    pairs = [(0, 1), (E - 2, E - 1)]
    for lo, hi in pairs:
        router[:, hi] = router[:, lo]
    logits = torch.from_numpy(x) @ torch.from_numpy(router)
    for lo, hi in pairs:
        assert torch.equal(logits[..., lo], logits[..., hi])  # the premise: exact ties
    for whiten in (True, False):
        got, want = _route_both(cfg, ref_cfg, x, router, whiten)
        _assert_route_equal(got, want)
    top_e = got[1]
    ties = 0
    for lo, hi in pairs:
        both = (top_e == lo).any(-1) & (top_e == hi).any(-1)
        ties += int(both.sum())
        pos = lambda e: np.argmax(top_e == e, axis=-1)  # noqa: E731
        assert (pos(lo)[both] < pos(hi)[both]).all()
        # only one of a tied pair at the top-k's edge: it is the lower one
        assert not ((top_e == hi).any(-1) & ~(top_e == lo).any(-1)).any()
    assert ties > 0, "no token had both experts of a tied pair in its top-k"


@pytest.mark.parametrize("capacity_factor", [0.5, 1.25])
def test_every_expert_stays_within_capacity(capacity_factor):
    cfg, _ = _cfgs(True, moe_capacity_factor=capacity_factor)
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.normal(size=(3, 200, 64)).astype(np.float32))
    router = torch.from_numpy(rng.normal(size=(64, 64)).astype(np.float32))
    C = moe.expert_capacity(cfg, 200)
    for whiten in (True, False):
        _, top_e, slot, _ = moe.route(cfg, x, router, whiten=whiten)
        for b in range(3):
            kept = slot[b] < C
            pairs = top_e[b][kept] * (C + 1) + slot[b][kept]
            assert pairs.unique().numel() == pairs.numel()  # one (token, k) per slot
            counts = torch.bincount(top_e[b][kept], minlength=64)
            assert int(counts.max()) <= C
            # an expert drops only once its C slots are full
            full = torch.bincount(top_e[b].flatten(), minlength=64) > C
            assert (counts[full] == C).all()
            assert (full[top_e[b]] | (slot[b] < C)).all()


def _ffn_params(cfg, rng):
    p = {}
    for name, spec in moe.moe_specs(cfg).items():
        fan_in = spec.shape[-2]
        p[name] = (rng.normal(size=spec.shape) / np.sqrt(fan_in)).astype(np.float32)
    return p


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize(
    "full,overrides",
    [
        (False, {}),
        (False, {"moe_capacity_factor": 0.5}),
        (False, {"moe_num_shared": 1}),
        (True, {"d_model": 64, "moe_d_ff": 32, "moe_capacity_factor": 0.5}),
    ],
    ids=["smoke", "smoke-drops", "shared", "full-routing-drops"],
)
def test_moe_ffn_matches_reference(full, overrides, dtype):
    cfg, ref_cfg = _cfgs(full, **overrides)
    rng = np.random.default_rng(5)
    p = _ffn_params(cfg, rng)
    x = rng.normal(size=(3, 40, cfg.d_model)).astype(np.float32)
    td, jdt = DTYPES[dtype]
    for whiten in (True, False):
        got, aux = moe.moe_ffn(
            cfg,
            {k: torch.from_numpy(v).to(td) for k, v in p.items()},
            torch.from_numpy(x).to(td),
            whiten=whiten,
        )
        want, want_aux = ref_moe_ffn(
            ref_cfg,
            {k: jnp.asarray(v) for k, v in p.items()},
            jnp.asarray(x).astype(jdt),
            whiten=whiten,
        )
        assert got.dtype == td and aux.dtype == torch.float32
        np.testing.assert_allclose(
            got.float().numpy(), np.asarray(want, np.float32), rtol=0, atol=TOL_FFN[dtype]
        )
        np.testing.assert_allclose(float(aux), float(want_aux), rtol=0, atol=1e-6)


def test_moe_module_and_fractal_memo():
    """The layer module runs ``moe_ffn`` on its own parameters, and the
    whitening permutation is made once per size and device."""
    cfg, _ = _cfgs(False)
    rng = np.random.default_rng(8)
    p = _ffn_params(cfg, rng)
    m = moe.MoE(cfg, torch.float32)
    for k, v in p.items():
        getattr(m, k).data.copy_(torch.from_numpy(v))
    x = torch.from_numpy(rng.normal(size=(2, 9, cfg.d_model)).astype(np.float32))
    want, _ = moe.moe_ffn(cfg, {k: torch.from_numpy(v) for k, v in p.items()}, x)
    assert torch.equal(m(x), want)
    a = moe._fractal_perm(18, torch.device("cpu"))
    assert a is moe._fractal_perm(18, torch.device("cpu"))
    np.testing.assert_array_equal(a.numpy(), fractal_permute(18, seed=1))
