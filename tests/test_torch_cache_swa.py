"""The contiguous cache of a sliding-window stack (``smoke(h2o-danube-1.8b)``,
window 16) against the reference's rolling cache: a two-window prompt
rolled into a window-sized cache (only its last window persists, each row
at its position mod the window), then decode steps that cross the buffer's
wrap, with ``pos`` a scalar and a ``[B]`` vector; a short prompt whose
decode wraps; a cache longer than the window (the kernel masks the rows
before the window's start); the cache form against the pool form, which
keeps every row in position order (the rolling buffer's ring order changes
only the order of summation: within 1e-5); the prompt the reference's
rolling prefill refuses.  Tolerances as ``test_torch_cache.py``."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.models import model as M  # noqa: E402
from test_torch_cache import POOL_TOL, check_pair, pool_logits, run_pair  # noqa: E402
from test_torch_model import _pair  # noqa: E402

ARCH = "h2o-danube-1.8b"
WINDOW = 16


@pytest.mark.parametrize(
    "S,T,pos0,steps",
    [
        (32, WINDOW, None, 20),  # two windows rolled in; slots 0 .. 15, then 0 .. 3 again
        (32, WINDOW, [32, 29], 6),  # per-row positions, row 1 rewinding into the last window
        (8, WINDOW, None, 12),  # a short prompt; decode wraps at position 16
        (32, 48, None, 6),  # a cache past the window: the kernel's window masks
    ],
    ids=["two-windows", "per-row", "short-wraps", "longer-cache"],
)
def test_windowed_cache_matches_reference(S, T, pos0, steps):
    check_pair(run_pair(ARCH, S=S, T=T, pos0=pos0, steps=steps))


def test_windowed_cache_bf16():
    check_pair(run_pair(ARCH, dtype="bfloat16", S=32, T=WINDOW, steps=18), "bfloat16")


def test_rolling_cache_matches_pool_form():
    out, _, _, model, toks, inputs = run_pair(ARCH, S=32, T=WINDOW, steps=20)
    for i, (got, want) in enumerate(zip([o[0] for o in out], pool_logits(model, toks, inputs))):
        np.testing.assert_allclose(got, want, rtol=0, atol=POOL_TOL, err_msg=f"call {i}")


def test_rolling_prefill_takes_whole_windows():
    *_, cfg, model = _pair(ARCH, {}, "float32")
    cache = M.init_cache(cfg, 1, WINDOW, torch.float32, device="cpu")
    with pytest.raises(ValueError, match="whole number of windows"):
        M.prefill_cache(model, torch.zeros((1, 24), dtype=torch.int64), cache)
    assert M.cache_length(cfg, 24) == WINDOW and M.cache_length(cfg, 12) == 12
