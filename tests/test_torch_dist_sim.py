"""``simulate_batch(shard=True)`` split across 2 gloo ranks of one host,
mirroring the reference's sharded-batch test (``tests/test_slices.py``,
two forced host devices): the sharded batch equals the unsharded one bit
for bit, at B 4, at B 3 (padded up to the rank multiple and sliced back)
and chunked (chunks of 2 shared by the ranks), and both equal the
reference's ``simulate_batch``; ``batch_sharding`` splits only a batch the
world divides, and is None with no process group."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import simulator as ref_sim  # noqa: E402
from repro_torch.core import simulator as sim  # noqa: E402
from torch_dist import run_ranks  # noqa: E402

X, N = 4, 16

BODY = """
import numpy as np
from repro_torch.core.simulator import SimParams, Trace, batch_sharding, simulate_batch


def traces():
    rng = np.random.default_rng(0)
    return [
        Trace(np.zeros((4, 16), np.int32), np.full((4, 16), 8, np.int32),
              rng.integers(0, 2**18, (4, 16)).astype(np.int32))
        for _ in range(4)
    ]


def main(rank, world, tmp):
    ts, prms = traces(), [SimParams(max_cycles=800)] * 4
    out = {
        "sharding_4": batch_sharding(4, device="cpu") is not None,
        "sharding_3": batch_sharding(3, device="cpu") is None,
        "s4": simulate_batch(ts, prms, shard=True, device="cpu"),
        "u4": simulate_batch(ts, prms, shard=False, device="cpu"),
        "s3": simulate_batch(ts[:3], prms[:3], shard=True, device="cpu"),
        "u3": simulate_batch(ts[:3], prms[:3], shard=False, device="cpu"),
        "c4": simulate_batch(ts, prms, shard=True, chunk=2, device="cpu"),
        "c3": simulate_batch(ts[:3], prms[:3], shard=True, chunk=2, device="cpu"),
        "shared": simulate_batch(ts[:1], prms, shard=True, device="cpu"),
        "shared_u": simulate_batch(ts[:1], prms, shard=False, device="cpu"),
    }
    # every rank holds the whole batch after the gather
    gathered = [None] * world
    batches = {k: v for k, v in out.items() if isinstance(v, dict)}
    torch.distributed.all_gather_object(gathered, batches)
    out["ranks_agree"] = all(
        np.array_equal(g[k][m], out[k][m]) for g in gathered for k in g for m in g[k]
    )
    return out
"""


def _traces():
    rng = np.random.default_rng(0)
    return [
        ref_sim.Trace(
            np.zeros((X, N), np.int32),
            np.full((X, N), 8, np.int32),
            rng.integers(0, 2**18, (X, N)).astype(np.int32),
        )
        for _ in range(4)
    ]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return run_ranks(2, BODY, tmp_path_factory.mktemp("sim2"), timeout=240)


@pytest.fixture(scope="module")
def reference():
    ts, prms = _traces(), [ref_sim.SimParams(max_cycles=800)] * 4
    return {
        4: ref_sim.simulate_batch(ts, prms, shard=False),
        3: ref_sim.simulate_batch(ts[:3], prms[:3], shard=False),
        "shared": ref_sim.simulate_batch(ts[:1], prms, shard=False),
    }


def test_batch_sharding_splits_only_divisible_batches(ranks):
    assert ranks["sharding_4"] and ranks["sharding_3"]
    assert sim.batch_sharding(4, device="cpu") is None  # no process group here


@pytest.mark.parametrize(
    "got,want,B",
    [("s4", "u4", 4), ("s3", "u3", 3), ("c4", "u4", 4), ("c3", "u3", 3), ("shared", "shared_u", 4)],
    ids=["B4", "B3-padded", "chunked", "chunked-padded", "shared-trace"],
)
def test_sharded_batch_equals_unsharded_and_reference(ranks, reference, got, want, B):
    s, u = ranks[got], ranks[want]
    ref = reference["shared" if got == "shared" else B]
    assert set(s) == set(u)
    for k in s:
        assert np.asarray(s[k]).shape[0] == B, k
        np.testing.assert_array_equal(s[k], u[k], err_msg=k)
        if k in ref:
            np.testing.assert_array_equal(s[k], np.asarray(ref[k]), err_msg=k)
    assert set(ref) <= set(s)


def test_every_rank_holds_the_whole_batch(ranks):
    assert ranks["ranks_agree"]


def test_several_cuda_devices_without_a_group_raise(monkeypatch):
    monkeypatch.setattr(sim, "_resolve_device", lambda device=None: torch.device("cuda"))
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    ts = [sim.Trace(*(np.asarray(a) for a in (t.is_write, t.burst, t.addr))) for t in _traces()]
    with pytest.raises(NotImplementedError, match="process group"):
        sim.simulate_batch(ts, [sim.SimParams(max_cycles=800)] * 4)
