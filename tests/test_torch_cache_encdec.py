"""Whisper's contiguous cache (``smoke(whisper-base, encoder_seq_len=100)``)
against the reference's: the decoder's self-attention K/V and ``pos``
beside the cross K/V ``ck``/``cv [L, B, 100, G, D]`` that prefill writes
from the encoder's output, and decode steps whose cross-attention runs on
the paged kernel over those rows (blocks of 4: 100 is no multiple of 16).
Float32 bounds are 2x the dense files' (2e-4 on the logits, 5e-5 of a
leaf's largest entry on the cache), as ``test_torch_encdec.py`` explains:
at this size the reference's own float32 logits are 1.56e-4 from its
float64 ones."""

import pytest

torch = pytest.importorskip("torch")

from test_torch_cache import check_pair, run_pair  # noqa: E402

ARCH = "whisper-base"
OVERRIDES = {"encoder_seq_len": 100}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_encdec_cache_matches_reference(dtype):
    res = run_pair(ARCH, overrides=OVERRIDES, dtype=dtype, frames=True, pos0=[8, 6], steps=4)
    check_pair(res, dtype, tol=2e-4 if dtype == "float32" else None, cache_tol=5e-5)
