"""Tests of the port that need a CUDA card (the kernels have no CPU mode).

Each test takes the ``card`` fixture, which skips where
``torch.cuda.is_available()`` is false, as on a CPU-only machine.  The file
imports neither JAX nor the reference package, so it runs on the card's
machine as it is:

    python -m pytest -q tests/test_torch_card.py
"""

import json
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core.simulator import SimParams, simulate, stepped_cycles
from repro_torch.core.traffic import random_uniform
from repro_torch.data import GOLDEN_KEYS, golden_cases
from repro_torch.kernels import LAUNCHES, reset_launches
from repro_torch.kernels.bank_arbiter.ops import bank_arbiter_winners
from repro_torch.kernels.bank_arbiter.ref import bank_arbiter_ref

GOLDEN = Path(__file__).parent / "data" / "golden_single_slice.json"


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.parametrize(
    "B,S,NB,bank_dtype",
    [
        (1, 8192, 256, torch.int16),
        (4, 8192, 256, torch.int16),
        (3, 8193, 256, torch.int32),
        (2, 300, 130, torch.int16),
        (2, 4096, 1, torch.int16),
    ],
)
def test_bank_arbiter_kernel_matches_plain(card, B, S, NB, bank_dtype):
    rng = np.random.default_rng(S + NB)
    for elig_p, key_hi in ((0.4, 2**29), (0.9, 4), (0.0, 2**29), (0.5, 2**30 + 1)):
        key = torch.tensor(rng.integers(0, key_hi, (B, S)), dtype=torch.int32, device=card)
        bank = torch.tensor(rng.integers(0, NB, (B, S)), dtype=bank_dtype, device=card)
        elig = torch.tensor(rng.random((B, S)) < elig_p, device=card)
        before = LAUNCHES["bank_arbiter"]
        got = bank_arbiter_winners(key, bank, elig, num_banks=NB)
        torch.cuda.synchronize()
        assert LAUNCHES["bank_arbiter"] == before + 1
        assert torch.equal(got, bank_arbiter_ref(key, bank, elig, num_banks=NB))


def test_wrapper_rejects_too_many_banks(card):
    z = torch.zeros((1, 8), dtype=torch.int32, device=card)
    with pytest.raises(ValueError, match="shared memory"):
        bank_arbiter_winners(z, z, z > 0, num_banks=10_000)


@pytest.mark.parametrize("case", range(3))
def test_golden_cases_on_card(card, case):
    name, trace, prm = golden_cases()[case]
    want = json.loads(GOLDEN.read_text())["cases"][name]
    got = simulate(trace, prm)
    for k in GOLDEN_KEYS:
        assert np.asarray(got[k]).tolist() == want[k], (name, k)


def test_main_path_launches_kernel_once_per_cycle(card):
    trace = random_uniform(4, 16, burst=16, seed=5)
    prm = SimParams(max_cycles=2000)
    reset_launches()
    got = simulate(trace, prm)
    assert LAUNCHES["bank_arbiter"] == stepped_cycles(got["drained_cycle"], prm) > 0
    ref = simulate(trace, SimParams(max_cycles=2000, arbiter="ref"))
    for k in got:
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
