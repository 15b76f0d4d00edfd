"""The port's bank arbiter against the reference's, grant for grant.

The plain PyTorch version (what the wrapper runs on CPU tensors) is held
against the reference's ``segment_min`` version and its Pallas kernel in
interpret mode, exactly.  The CUDA kernel itself runs only on the card:
``tests/test_torch_card.py`` and ``chip_smoke.py`` hold it against the plain
version there.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core.qos import arbitration_priority_key
from repro.core.simulator import SimParams as JSimParams
from repro.core.simulator import _age_cap
from repro.kernels.bank_arbiter.ops import bank_arbiter_winners as jwinners
from repro.kernels.bank_arbiter.ref import bank_arbiter_ref as jref
from repro_torch.kernels import LAUNCHES
from repro_torch.kernels.bank_arbiter import ops
from repro_torch.kernels.bank_arbiter.ops import bank_arbiter_winners
from repro_torch.kernels.bank_arbiter.ref import (
    KEY_FILLER,
    bank_arbiter_ref,
    bank_arbiter_split_ref,
    split_of_slot,
)

torch.set_num_threads(1)


def _inputs(rng, B, S, NB, X):
    age_cap = _age_cap(JSimParams(), X)
    level = rng.integers(0, 8, (B, S))
    age = rng.integers(0, min(age_cap + 1, 4096), (B, S))
    rr = rng.integers(0, X, (B, S))
    key = arbitration_priority_key(level, age, rr, age_cap=age_cap, num_masters=X)
    bank = rng.integers(0, NB, (B, S))
    elig = rng.random((B, S)) < 0.4
    return key.astype(np.int32), bank.astype(np.int32), elig


def _port(key, bank, elig, NB, bank_dtype=torch.int16):
    key, bank, elig = torch.from_numpy(key), torch.from_numpy(bank), torch.from_numpy(elig)
    return bank_arbiter_winners(key, bank.to(bank_dtype), elig, num_banks=NB).numpy()


@pytest.mark.parametrize("S,NB,X", [(64, 16, 4), (256, 256, 8), (2048, 256, 16), (300, 130, 8)])
def test_plain_matches_reference_and_pallas(S, NB, X, rng):
    for _ in range(3):
        key, bank, elig = _inputs(rng, 1, S, NB, X)
        got = _port(key, bank, elig, NB)
        assert got.dtype == np.int32 and got.shape == (1, NB)
        args = (jnp.asarray(key[0]), jnp.asarray(bank[0]), jnp.asarray(elig[0]))
        np.testing.assert_array_equal(got[0], np.asarray(jref(*args, num_banks=NB)))
        pallas = jwinners(*args, num_banks=NB, backend="pallas")
        np.testing.assert_array_equal(got[0], np.asarray(pallas))
        np.testing.assert_array_equal(_port(key, bank, elig, NB, torch.int32), got)


def test_no_eligible_slot_gives_sentinel():
    S, NB = 32, 8
    zeros = np.zeros((2, S), np.int32)
    got = _port(zeros, zeros, np.zeros((2, S), bool), NB)
    np.testing.assert_array_equal(got, np.full((2, NB), S))


def test_filler_key_still_wins_over_no_slot():
    """An eligible slot whose key equals KEY_FILLER beats the init value."""
    key = np.full((1, 4), KEY_FILLER, np.int32)
    bank = np.array([[1, 0, 1, 0]], np.int32)
    elig = np.array([[False, True, True, True]])
    np.testing.assert_array_equal(_port(key, bank, elig, 3), [[1, 2, 4]])
    want = jref(jnp.asarray(key[0]), jnp.asarray(bank[0]), jnp.asarray(elig[0]), num_banks=3)
    np.testing.assert_array_equal(np.asarray(want), [1, 2, 4])


def test_batched_lanes_match_vmapped_reference(rng):
    B, S, NB, X = 4, 128, 32, 4
    key, bank, elig = _inputs(rng, B, S, NB, X)
    want = jax.vmap(lambda k, b, e: jref(k, b, e, num_banks=NB))(
        jnp.asarray(key), jnp.asarray(bank), jnp.asarray(elig)
    )
    np.testing.assert_array_equal(_port(key, bank, elig, NB), np.asarray(want))


def test_hypothesis_parity():
    pytest.importorskip("hypothesis", reason="property tests need hypothesis")
    from hypothesis import given, settings
    from hypothesis import strategies as st

    S_PAD, NB_PAD = 200, 64

    @settings(max_examples=40, deadline=None)
    @given(
        data=st.data(),
        B=st.integers(min_value=1, max_value=3),
        S=st.integers(min_value=1, max_value=200),
        NB=st.integers(min_value=1, max_value=64),
    )
    def prop(data, B, S, NB):
        def draw(elem):
            return data.draw(st.lists(elem, min_size=B * S, max_size=B * S))

        key = np.array(draw(st.integers(0, 2**29)), np.int32).reshape(B, S)
        bank = np.array(draw(st.integers(0, NB - 1)), np.int32).reshape(B, S)
        elig = np.array(draw(st.booleans()), bool).reshape(B, S)
        got = _port(key, bank, elig, NB)
        # the reference runs at one padded shape (padding is ineligible), so
        # it compiles once; its sentinel is then the padded slot count
        pad = ((0, 0), (0, S_PAD - S))
        padded = (jnp.asarray(np.pad(a, pad)) for a in (key, bank, elig))
        want = np.asarray(jax.vmap(lambda k, b, e: jref(k, b, e, num_banks=NB_PAD))(*padded))
        want = want[:, :NB]
        np.testing.assert_array_equal(got, np.where(want == S_PAD, S, want))
        for b in range(B):
            # the contract itself: the eligible min-key slot, lowest id on ties
            for nb in range(NB):
                slots = np.nonzero(elig[b] & (bank[b] == nb))[0]
                best = S if len(slots) == 0 else slots[np.argmin(key[b][slots])]
                assert got[b, nb] == best

    prop()


def test_cpu_tensors_take_the_plain_path_and_count_no_launch(rng):
    key, bank, elig = _inputs(rng, 2, 256, 16, 4)
    before = LAUNCHES["bank_arbiter"]
    got = _port(key, bank, elig, 16)
    assert LAUNCHES["bank_arbiter"] == before
    want = bank_arbiter_ref(
        torch.from_numpy(key), torch.from_numpy(bank), torch.from_numpy(elig), num_banks=16
    )
    np.testing.assert_array_equal(got, want.numpy())


def test_wrapper_checks_reject_bad_inputs():
    key = torch.zeros((1, 8), dtype=torch.int32)
    bank = torch.zeros((1, 8), dtype=torch.int16)
    elig = torch.zeros((1, 8), dtype=torch.bool)
    with pytest.raises(ValueError, match="shape"):
        ops._check(key, bank[:, :4], elig, 4)
    with pytest.raises(TypeError, match="key must be int32"):
        ops._check(key.long(), bank, elig, 4)
    with pytest.raises(TypeError, match="elig must be bool"):
        ops._check(key, bank, elig.to(torch.uint8), 4)
    with pytest.raises(ValueError, match="CUDA device"):
        ops._check(key, bank, elig, 4)



# ------------------------------------------------- the kernel's decomposition


def _split_inputs(rng, B, S, NB, mode):
    """Keys as the simulator packs them, or from ``[0, 4)`` (ties), or up to
    and including ``KEY_FILLER`` (filler keys that must still win)."""
    if mode == "packed":
        key, bank, elig = _inputs(rng, B, S, NB, 16)
        return key, bank, elig
    hi = 4 if mode == "ties" else KEY_FILLER + 1
    key = rng.integers(0, hi, (B, S)).astype(np.int32)
    return key, rng.integers(0, NB, (B, S)).astype(np.int32), rng.random((B, S)) < 0.6


@pytest.mark.parametrize("splits", [1, 2, 4, 8])
@pytest.mark.parametrize(
    "B,S,NB",
    [
        (1, 8192, 256),  # the simulator's main path
        (3, 8193, 256),  # ragged lanes
        (2, 5, 16),  # fewer slots than CTAs
        (2, 64, 16),  # shares of 16 slots: some CTAs get none
        (2, 300, 130),  # banks not divisible by the split count
        (2, 512, 1),  # one bank
    ],
)
def test_split_ref_matches_plain_and_reference(splits, B, S, NB, rng):
    """Per-CTA minima of packed ``(key << 32) | slot`` values merged by bank
    equal both plain versions and the JAX reference, grant for grant."""
    for mode in ("packed", "ties", "filler"):
        key, bank, elig = _split_inputs(rng, B, S, NB, mode)
        t = [torch.from_numpy(a) for a in (key, bank, elig)]
        got = bank_arbiter_split_ref(t[0], t[1].to(torch.int16), t[2], num_banks=NB, splits=splits)
        assert got.dtype == torch.int32 and got.shape == (B, NB)
        np.testing.assert_array_equal(got, bank_arbiter_ref(*t, num_banks=NB), err_msg=mode)
        want = jax.vmap(lambda k, b, e: jref(k, b, e, num_banks=NB))(
            jnp.asarray(key), jnp.asarray(bank), jnp.asarray(elig)
        )
        np.testing.assert_array_equal(got.numpy(), np.asarray(want), err_msg=mode)


@pytest.mark.parametrize("splits", [1, 2, 4, 8])
@pytest.mark.parametrize("S", [1, 5, 16, 64, 300, 8192, 8193])
def test_split_of_slot_covers_each_lane_in_order(splits, S):
    """Every slot belongs to one CTA, shares are contiguous, start at
    multiples of 16 and hold at most ``ceil(S / splits)`` rounded up to 16."""
    idx = split_of_slot(S, splits)
    assert idx.shape == (S,) and int(idx.min()) == 0 and int(idx.max()) < splits
    assert bool((idx.diff() >= 0).all()) and bool((idx.diff() <= 1).all())
    starts = torch.nonzero(idx.diff()).flatten() + 1
    assert bool((starts % 16 == 0).all())
    per = -(-S // splits)
    assert int(torch.bincount(idx).max()) <= -(-per // 16) * 16


@pytest.mark.parametrize(
    "B,S,want",
    [
        (1, 8192, (8, 512, 1024)),  # the main path: 8 CTAs of the one lane
        (64, 8192, (4, 512, 2048)),  # a sweep: 256 CTAs cover 132 SMs
        (132, 8192, (1, 512, 4096)),  # the lanes alone fill the card
        (1000, 8192, (1, 512, 4096)),
        (1, 64, (1, 32, 64)),  # too few slots to spread
        (1, 1024, (2, 256, 512)),
        (3, 8193, (8, 512, 1040)),
        (1, 100_000, (8, 512, 4096)),  # several tiles per CTA
        (2, 0, (1, 32, 16)),
    ],
)
def test_launch_shape_picks_cluster_threads_and_tile(B, S, want):
    assert ops.launch_shape(B, S, 132) == want


def test_launch_shape_forced_cluster_and_refusal():
    assert ops.launch_shape(1, 64, 132, cluster=8) == (8, 32, 16)
    assert ops.launch_shape(64, 8192, 132, cluster=1) == (1, 512, 4096)
    with pytest.raises(ValueError, match="CTAs per lane"):
        ops.launch_shape(1, 8192, 132, cluster=3)
    with pytest.raises(ValueError, match="CTAs per lane"):
        ops.launch_shape(1, 8192, 132, cluster=16)
