"""The port's streaming P² accumulators against the reference's, exactly.

The reference runs ``p2_update`` inside its compiled cycle loop, where the
compiler fuses each multiply that feeds an add into one rounding; the tests
call it through ``jax.jit`` so it rounds as it does there.  Heights and
marker positions must equal it bit for bit (the stated tolerance for the P²
float keys is 0: no case needs more).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import percentile as jp2
from repro_torch.core import percentile as tp2

torch.set_num_threads(1)

G, NQ = 16, len(tp2.STREAM_PCTS)
jit_update = jax.jit(jp2.p2_update)


def _draw(rng, kind, m):
    if kind == "gamma":
        return rng.gamma(2.0, 100.0, m).astype(np.float32)
    if kind == "ints":  # simulator latencies: small integers, many ties
        return rng.integers(1, 400, m).astype(np.float32)
    return np.exp(rng.normal(4.0, 1.5, m)).astype(np.float32)  # heavy tail


@pytest.mark.parametrize("kind", ["gamma", "ints", "lognormal"])
@pytest.mark.parametrize("lanes", [1, 3])
def test_p2_update_matches_reference_over_call_sequences(kind, lanes):
    """80 calls of 48 observations each, masked at random (so 0..48 count),
    into 16 groups; ``lanes`` independent lanes in one port call against one
    reference state each.  Every group crosses from the init regime (fewer
    than 5 observations) into the steady one."""
    rng = np.random.default_rng(lanes * 7 + len(kind))
    want = [jp2.p2_init(G, NQ) for _ in range(lanes)]
    th, tn, tc = tp2.p2_init(lanes, G, NQ)
    for _ in range(80):
        m = 48
        vals = np.stack([_draw(rng, kind, m) for _ in range(lanes)])
        gid = rng.integers(0, G, (lanes, m)).astype(np.int32)
        mask = rng.random((lanes, m)) < rng.random()
        for b in range(lanes):
            want[b] = jit_update(*want[b], jnp.asarray(vals[b]), jnp.asarray(gid[b]), mask[b])
        th, tn, tc = tp2.p2_update(
            th, tn, tc, torch.from_numpy(vals), torch.from_numpy(gid), torch.from_numpy(mask)
        )
    for b in range(lanes):
        for got, ref in zip((th[b], tn[b], tc[b]), want[b]):
            assert got.numpy().dtype == np.asarray(ref).dtype
            np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert (tc >= 5).all()


def test_p2_all_false_mask_is_bitexact_noop():
    rng = np.random.default_rng(3)
    h, n, c = tp2.p2_init(2, G, NQ)
    for _ in range(30):
        vals = torch.from_numpy(_draw(rng, "gamma", 40).reshape(2, 20))
        gid = torch.from_numpy(rng.integers(0, G, (2, 20)).astype(np.int32))
        h, n, c = tp2.p2_update(h, n, c, vals, gid, torch.ones((2, 20), dtype=torch.bool))
    vals = torch.from_numpy(_draw(rng, "gamma", 40).reshape(2, 20))
    off = torch.zeros((2, 20), dtype=torch.bool)
    h2, n2, c2 = tp2.p2_update(h, n, c, vals, gid, off)
    for a, b in ((h, h2), (n, n2), (c, c2)):
        assert torch.equal(a, b)


def test_p2_host_readout_and_merge_match_reference():
    """``p2_quantiles`` and ``p2_merge_quantile`` (numpy copies) on the same
    states, steady and init-regime groups alike, and the merged estimate
    over lanes."""
    rng = np.random.default_rng(5)
    lanes = 4
    th, tn, tc = tp2.p2_init(lanes, G, NQ)
    for _ in range(25):
        vals = torch.from_numpy(np.stack([_draw(rng, "ints", 12) for _ in range(lanes)]))
        gid = torch.from_numpy(rng.integers(0, G, (lanes, 12)).astype(np.int32))
        mask = torch.from_numpy(rng.random((lanes, 12)) < 0.3)
        th, tn, tc = tp2.p2_update(th, tn, tc, vals, gid, mask)
    h, n, c = th.numpy(), tn.numpy(), tc.numpy()
    for b in range(lanes):
        np.testing.assert_array_equal(
            tp2.p2_quantiles(h[b], n[b], c[b]), jp2.p2_quantiles(h[b], n[b], c[b])
        )
    for g in range(G):
        for qi, q in enumerate(tp2.STREAM_PCTS):
            args = (h[:, g, qi], n[:, g, qi], c[:, g], q / 100.0)
            got, want = tp2.p2_merge_quantile(*args), jp2.p2_merge_quantile(*args)
            assert got == want or (np.isnan(got) and np.isnan(want))
    assert tp2.STREAM_PCTS == jp2.STREAM_PCTS
    np.testing.assert_array_equal(
        tp2.p2_desired_fracs([0.5, 0.99]), jp2.p2_desired_fracs([0.5, 0.99])
    )


def test_p2_rank_band_counterexample_matches_reference():
    """The shrunk counterexample of the reference's rank-band property
    (``tests/test_streaming.py::test_p2_property_hypothesis``): 40 values,
    all 1.0 but 3.0 at index 36 and 2.0 at index 38, one value per call, into
    one group.  The reference's p50 estimate, 1.0052632, lies outside the
    band its module documents; the port is held to the reference's outputs
    bit for bit here, not to the band."""
    vals = np.ones(40, np.float32)
    vals[36], vals[38] = 3.0, 2.0
    want = jp2.p2_init(1, NQ)
    th, tn, tc = tp2.p2_init(1, 1, NQ)
    one = np.zeros(1, np.int32)
    for v in vals:
        want = jit_update(*want, jnp.asarray(v[None]), jnp.asarray(one), jnp.ones(1, bool))
        th, tn, tc = tp2.p2_update(
            th, tn, tc, torch.tensor([[v]]), torch.zeros((1, 1), dtype=torch.int32),
            torch.ones((1, 1), dtype=torch.bool),
        )
    for got, ref in zip((th[0], tn[0], tc[0]), want):
        assert got.numpy().dtype == np.asarray(ref).dtype
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    est = tp2.p2_quantiles(th[0].numpy(), tn[0].numpy(), tc[0].numpy())
    np.testing.assert_array_equal(est, jp2.p2_quantiles(*(np.asarray(a) for a in want)))
    assert est[0, tp2.STREAM_PCTS.index(50)] == np.float32(1.0052632)
