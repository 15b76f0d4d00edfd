"""The port's numpy address map against the reference's, exactly.

Every beat of a small geometry and 10k random beats of the paper geometry,
for both slice policies, 1/2/4 slices and all three banking modes.
"""

import numpy as np
import pytest

pytest.importorskip("torch")

from repro.core import address as jaddr
from repro.core.simulator import SimParams as JSimParams
from repro.core.simulator import bank_of as jbank_of
from repro_torch.core import address as taddr
from repro_torch.core.simulator import SimParams, bank_of

SMALL = dict(total_bytes=2**16)  # 2048 beats per slice


def _geoms(policy, num_slices, **kw):
    return (
        jaddr.MemoryGeometry(num_slices=num_slices, slice_policy=policy, **kw),
        taddr.MemoryGeometry(num_slices=num_slices, slice_policy=policy, **kw),
    )


@pytest.mark.parametrize("banking", ["paper", "linear", "no_fractal"])
@pytest.mark.parametrize("num_slices", [1, 2, 4])
@pytest.mark.parametrize("policy", ["hash", "region"])
def test_bank_of_matches_reference(policy, num_slices, banking):
    jg, tg = _geoms(policy, num_slices, **SMALL)
    every = np.arange(tg.beats_total, dtype=np.int32)
    want = jbank_of(every, JSimParams(geom=jg, banking=banking))
    got = bank_of(every, SimParams(geom=tg, banking=banking))
    assert got.dtype == want.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    assert 0 <= got.min() and got.max() < tg.num_banks

    jg, tg = _geoms(policy, num_slices)
    beats = np.random.default_rng(num_slices).integers(0, tg.beats_total, 10_000).astype(np.int32)
    np.testing.assert_array_equal(
        bank_of(beats, SimParams(geom=tg, banking=banking)),
        jbank_of(beats, JSimParams(geom=jg, banking=banking)),
    )


@pytest.mark.parametrize("num_slices", [1, 2, 4])
@pytest.mark.parametrize("policy", ["hash", "region"])
def test_address_helpers_match_reference(policy, num_slices):
    jg, tg = _geoms(policy, num_slices)
    beats = np.random.default_rng(7).integers(0, tg.beats_total, 10_000)
    for a, b in zip(jaddr.slice_of_beat(beats, jg), taddr.slice_of_beat(beats, tg)):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(jaddr.map_beat(beats, jg), taddr.map_beat(beats, tg)):
        np.testing.assert_array_equal(a, b)
    banks = taddr.flat_bank_id(beats, tg)
    np.testing.assert_array_equal(taddr.slice_of_bank(banks, tg), jaddr.slice_of_bank(banks, jg))
    np.testing.assert_array_equal(taddr.sub_bank_id(beats, tg), jaddr.sub_bank_id(beats, jg))
    for X in (1, 7, 16, 32):
        home = taddr.master_home_slices(X, tg)
        np.testing.assert_array_equal(home, jaddr.master_home_slices(X, jg))
        np.testing.assert_array_equal(
            taddr.slice_hops(beats[:X], home, tg), jaddr.slice_hops(beats[:X], home, jg)
        )


def test_geometry_validation_matches_reference():
    g = taddr.MemoryGeometry()
    assert (g.num_banks, g.beats_total, g.banks_per_slice) == (256, 2**20, 256)
    with pytest.raises(ValueError, match="num_slices"):
        taddr.MemoryGeometry(num_slices=0)
    with pytest.raises(ValueError, match="slice_policy"):
        taddr.MemoryGeometry(slice_policy="modulo")
    with pytest.raises(ValueError, match="slice_granule"):
        taddr.MemoryGeometry(slice_granule=3)
