"""Tests of the port that need a CUDA card (the kernels have no CPU mode).

Each test takes the ``card`` fixture, which skips where
``torch.cuda.is_available()`` is false, as on a CPU-only machine.  The file
imports neither JAX nor the reference package, so it runs on the card's
machine as it is:

    python -m pytest -q tests/test_torch_card.py
"""

import json
from dataclasses import replace
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import simulator as tsim
from repro_torch.core.simulator import SCHEDULE_PIPELINE, SimParams, simulate, simulate_batch
from repro_torch.core.traffic import random_bursty, random_uniform
from repro_torch.data import GOLDEN_KEYS, golden_batch, golden_cases
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
        (64, 8192, 256, torch.int16),  # a sweep's lanes
        (2, 8192, 130, torch.int32),  # banks not divisible by the cluster size
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


@pytest.fixture
def arb_inputs(card):
    """``chip_smoke.arb_inputs``: arbitration inputs on the card, keys packed
    as the simulator packs them (the tests run from the repository root)."""
    from chip_smoke import arb_inputs

    return arb_inputs


@pytest.mark.parametrize("cluster", [1, 2, 4, 8])
@pytest.mark.parametrize(
    "B,S,NB",
    [(1, 8192, 256), (3, 8193, 130), (1, 64, 16), (2, 5, 4)],  # S=64, 5: CTAs with no slots
)
def test_bank_arbiter_every_cluster_size(arb_inputs, cluster, B, S, NB):
    rng = np.random.default_rng(cluster * S + NB)
    for bank_dtype, key_hi in ((torch.int16, None), (torch.int32, 4)):
        key, bank, elig = arb_inputs(rng, B, S, NB, 32, bank_dtype=bank_dtype, key_hi=key_hi)
        got = bank_arbiter_winners(key, bank, elig, num_banks=NB, _cluster=cluster)
        torch.cuda.synchronize()
        assert torch.equal(got, bank_arbiter_ref(key, bank, elig, num_banks=NB))


@pytest.mark.parametrize("offsets", [(1, 1, 1), (3, 5, 7), (0, 2, 13)])
def test_bank_arbiter_storage_offset_views(card, offsets):
    """Views whose data start past a 16-byte boundary, each array by another
    amount, over ragged lanes (S = 8193): the kernel's scalar head and tail
    and its scalar loads where a vector would be misaligned."""
    B, S, NB = 3, 8193, 256
    rng = np.random.default_rng(sum(offsets))
    flat = [
        torch.tensor(rng.integers(0, 2**29, B * S + 16), dtype=torch.int32, device=card),
        torch.tensor(rng.integers(0, NB, B * S + 16), dtype=torch.int16, device=card),
        torch.tensor(rng.random(B * S + 16) < 0.4, device=card),
    ]
    key, bank, elig = (t[o : o + B * S].view(B, S) for t, o in zip(flat, offsets))
    assert key.storage_offset() == offsets[0] and key.is_contiguous()
    want = bank_arbiter_ref(key, bank, elig, num_banks=NB)
    for cluster in (None, 1, 2, 4, 8):
        got = bank_arbiter_winners(key, bank, elig, num_banks=NB, _cluster=cluster)
        torch.cuda.synchronize()
        assert torch.equal(got, want), cluster


def test_bank_arbiter_cuda_graph_replay(arb_inputs):
    """One call captured in a CUDA graph, replayed on new inputs copied into
    its static tensors, equals the plain version each time."""
    B, S, NB = 1, 8192, 256
    rng = np.random.default_rng(11)
    static = arb_inputs(rng, B, S, NB, 32)
    bank_arbiter_winners(*static, num_banks=NB)  # build and load before capture
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = bank_arbiter_winners(*static, num_banks=NB)
    for _ in range(3):
        fresh = arb_inputs(rng, B, S, NB, 32)
        for dst, src in zip(static, fresh):
            dst.copy_(src)
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, bank_arbiter_ref(*fresh, num_banks=NB))


def test_bank_arbiter_repeats_bit_for_bit(arb_inputs):
    rng = np.random.default_rng(12)
    for B in (1, 64):
        key, bank, elig = arb_inputs(rng, B, 8192, 256, 32, key_hi=8, elig_p=0.9)
        first = bank_arbiter_winners(key, bank, elig, num_banks=256)
        assert torch.equal(first, bank_arbiter_winners(key, bank, elig, num_banks=256))


@pytest.mark.parametrize("cluster", [1, 2, 4, 8])
def test_bank_arbiter_large_shared_memory(arb_inputs, cluster):
    """Launches that opt into more than 48 KB of dynamic shared memory: the
    fewest banks that cross 48 KB at this cluster size and bank width, and
    the most banks the wrapper takes, over ragged lanes."""
    from repro_torch.kernels.bank_arbiter import ops

    B, S = 3, 8193
    rng = np.random.default_rng(cluster)
    _, _, tile = ops.launch_shape(B, S, ops._num_sms(torch.device("cuda")), cluster)
    smem = ops._lib()["smem_bytes"]
    for bank_dtype, width in ((torch.int16, 2), (torch.int32, 4)):
        banks = range(1, ops.MAX_BANKS + 1)
        above = next(nb for nb in banks if smem(nb, cluster, tile, width) > 48 * 1024)
        for NB in (above, ops.MAX_BANKS):
            key, bank, elig = arb_inputs(rng, B, S, NB, 32, bank_dtype=bank_dtype)
            got = bank_arbiter_winners(key, bank, elig, num_banks=NB, _cluster=cluster)
            torch.cuda.synchronize()
            assert torch.equal(got, bank_arbiter_ref(key, bank, elig, num_banks=NB)), NB


def test_bank_arbiter_floor_launch_counts_nothing(card):
    from repro_torch.kernels.bank_arbiter.ops import floor_launch

    before = LAUNCHES["bank_arbiter"]
    floor_launch(1, 8192, num_banks=256, device=card)
    torch.cuda.synchronize()
    assert LAUNCHES["bank_arbiter"] == before


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
    tsim.reset_driver_counts()
    got = simulate(trace, prm)
    assert LAUNCHES["bank_arbiter"] == tsim.DRIVER_COUNTS["cycles"] > 0
    ref = simulate(trace, SimParams(max_cycles=2000, arbiter="ref"))
    for k in got:
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)


def test_golden_batch_and_schedule_goldens_on_card(card):
    """The golden ``"batch"`` entry through ``simulate_batch``, and the three
    golden cases through the schedule pipeline, bit for bit."""
    golden = json.loads(GOLDEN.read_text())
    traces, prms = golden_batch()
    got = simulate_batch(traces, prms)
    for k in GOLDEN_KEYS:
        assert np.asarray(got[k]).tolist() == golden["batch"][k], k
    for name, trace, prm in golden_cases():
        got = simulate(trace, replace(prm, stages=SCHEDULE_PIPELINE))
        for k in GOLDEN_KEYS:
            assert np.asarray(got[k]).tolist() == golden["cases"][name][k], (name, k)


@pytest.mark.parametrize("collect", ["exact", "stream"])
def test_schedule_batch_on_card_equals_cpu(card, collect):
    """Lanes whose clocks diverge under the time skip, in chunks of 2 with a
    padded last chunk: the card equals the CPU path on every key, the
    kernel launches once per cycle body for every lane, and ``arbiter="ref"``
    gives the same on the card."""
    traces = [random_bursty(4, 6, burst=8, gap=150 + 40 * i, seed=i) for i in range(3)]
    prms = [
        SimParams(max_cycles=2500, stages=SCHEDULE_PIPELINE, collect=collect, outstanding=o)
        for o in (2, 4, 8)
    ]
    reset_launches()
    tsim.reset_driver_counts()
    got = simulate_batch(traces, prms, chunk=2)
    assert LAUNCHES["bank_arbiter"] == tsim.DRIVER_COUNTS["cycles"] > 0
    assert (got["skipped_cycles"] > 0).all()
    want = simulate_batch(traces, prms, chunk=2, device="cpu")
    ref = simulate_batch(traces, [replace(p, arbiter="ref") for p in prms], chunk=2)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        np.testing.assert_array_equal(ref[k], want[k], err_msg=k)


# ---------------------------------------------------------------- serving kernels


def _randn(gen, shape, dtype):
    return torch.randn(shape, generator=gen, device="cuda").to(dtype)


def _tables(gen, B, width, NB, used):
    perm = torch.randperm(NB, generator=gen, device="cuda")
    tbl = torch.full((B, width), -1, dtype=torch.int32, device="cuda")
    k = 0
    for b, n in enumerate(used):
        tbl[b, :n] = perm[k : k + n].int()
        k += n
    return tbl


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5), (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize(
    "B,S,T,H,G,D,causal,window",
    [
        (1, 256, 256, 4, 2, 64, True, 0),
        (1, 512, 512, 2, 2, 128, True, 0),
        (1, 256, 600, 4, 4, 64, False, 0),  # ragged T, every key live
        (1, 256, 256, 2, 1, 64, True, 64),
        (2, 77, 77, 8, 2, 16, True, 0),
        (1, 517, 517, 32, 32, 64, True, 0),
        (1, 1, 1, 4, 4, 64, True, 0),
        (1, 15, 15, 4, 4, 64, True, 0),
        (1, 2048, 2048, 4, 1, 64, True, 0),  # GQA 4:1
        (1, 100, 333, 8, 1, 32, False, 0),  # ragged T, GQA 8:1
        (1, 300, 300, 32, 4, 64, True, 64),
        (2, 200, 200, 16, 4, 128, True, 0),
        (1, 1024, 1024, 16, 16, 128, True, 0),  # olmoe-1b-7b's longest prompt
    ],
)
def test_flash_attention_kernel_matches_plain(card, B, S, T, H, G, D, causal, window, dtype, tol):
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref

    gen = torch.Generator(device="cuda").manual_seed(S + T)
    q = _randn(gen, (B, S, H, D), dtype)
    k, v = _randn(gen, (B, T, G, D), dtype), _randn(gen, (B, T, G, D), dtype)
    before = LAUNCHES["flash_attention"]
    got = flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert LAUNCHES["flash_attention"] == before + 1
    want = flash_attention_ref(q, k, v, causal=causal, window=window)
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5), (torch.bfloat16, 3e-2)])
@pytest.mark.parametrize(
    "B,H,G,D,NB,bs,mb",
    [
        (2, 8, 2, 64, 16, 16, 4),
        (3, 4, 1, 128, 32, 8, 6),
        (2, 16, 4, 64, 64, 32, 3),
        (8, 32, 32, 64, 512, 16, 32),
        (3, 16, 2, 64, 64, 16, 8),  # 8 query heads per group
        (4, 16, 2, 16, 64, 16, 8),  # head dim 16
        (8, 16, 16, 128, 512, 16, 128),  # olmoe-1b-7b's decode: one head per group, D = 128
    ],
)
def test_paged_attention_kernel_matches_plain(card, B, H, G, D, NB, bs, mb, dtype, tol):
    """Ragged lengths, an empty request (length 0, no block) and a strided
    layer view of an all-layer pool."""
    from repro_torch.kernels.paged_attention.ops import paged_attention
    from repro_torch.kernels.paged_attention.ref import paged_attention_ref

    gen = torch.Generator(device="cuda").manual_seed(B * H + NB)
    pool = _randn(gen, (NB, bs, 3, 2, G, D), dtype)
    kp, vp = pool[:, :, 1, 0], pool[:, :, 1, 1]
    lens = torch.randint(1, mb * bs + 1, (B,), generator=gen, device="cuda")
    lens[B - 1] = 0
    tbl = _tables(gen, B, mb, NB, [-(-int(n) // bs) for n in lens.tolist()])
    q = _randn(gen, (B, H, D), dtype)
    got = paged_attention(q, kp, vp, tbl, lens.int())
    torch.cuda.synchronize()
    want = paged_attention_ref(q, kp, vp, tbl, lens.int())
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)
    assert (got[B - 1] == 0).all()


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5), (torch.bfloat16, 3e-2)])
@pytest.mark.parametrize("bs,D", [(16, 64), (8, 16), (32, 128)])
def test_paged_attention_kernel_edge_lengths(card, bs, D, dtype, tol):
    """Lengths of 1, exactly one split, two splits, the table's end, past the
    table's end (clamped) and 0; 8 query heads per group."""
    from repro_torch.kernels.paged_attention.ops import blocks_per_split, paged_attention
    from repro_torch.kernels.paged_attention.ref import paged_attention_ref

    span = blocks_per_split(bs) * bs
    mb = 3 * span // bs + 1
    lens = [1, span, 2 * span, mb * bs, mb * bs + 9, 0]
    B, H, G, NB = len(lens), 16, 2, len(lens) * mb
    gen = torch.Generator(device="cuda").manual_seed(bs + D)
    kp, vp = _randn(gen, (NB, bs, G, D), dtype), _randn(gen, (NB, bs, G, D), dtype)
    tbl = _tables(gen, B, mb, NB, [min(-(-n // bs), mb) for n in lens])
    q = _randn(gen, (B, H, D), dtype)
    ln = torch.tensor(lens, dtype=torch.int32, device="cuda")
    before = (LAUNCHES["paged_attention"], LAUNCHES["paged_attention_merge"])
    got = paged_attention(q, kp, vp, tbl, ln)
    torch.cuda.synchronize()
    assert (LAUNCHES["paged_attention"], LAUNCHES["paged_attention_merge"]) == (
        before[0] + 1,
        before[1] + 1,
    )
    want = paged_attention_ref(q, kp, vp, tbl, ln)
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)
    assert (got[B - 1] == 0).all()


def test_attention_kernels_repeat_bit_for_bit(card):
    """Two calls of each redesigned kernel on the same inputs give the same
    bits (the paged merge sums its splits in a fixed order, no atomics)."""
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.paged_attention.ops import paged_attention

    gen = torch.Generator(device="cuda").manual_seed(3)
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v = (_randn(gen, (1, 1024, 32, 64), dtype) for _ in range(3))
        assert torch.equal(flash_attention(q, k, v), flash_attention(q, k, v))
        pool = _randn(gen, (512, 16, 2, 2, 32, 64), dtype)
        kp, vp = pool[:, :, 1, 0], pool[:, :, 1, 1]
        lens = [585, 1061, 0, 700]
        tbl = _tables(gen, 4, 128, 512, [-(-n // 16) for n in lens])
        ln = torch.tensor(lens, dtype=torch.int32, device="cuda")
        q = _randn(gen, (4, 32, 64), dtype)
        assert torch.equal(paged_attention(q, kp, vp, tbl, ln), paged_attention(q, kp, vp, tbl, ln))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.int32])
@pytest.mark.parametrize(
    "B,nblk,NB,bs,W",
    [(2, 4, 32, 16, 128), (3, 2, 16, 8, 256), (1, 8, 64, 32, 64), (2, 3, 16, 3, 5)],
)
def test_banked_copy_kernel_matches_plain(card, B, nblk, NB, bs, W, dtype):
    from repro_torch.kernels.banked_copy.ops import banked_copy
    from repro_torch.kernels.banked_copy.ref import banked_copy_ref

    gen = torch.Generator(device="cuda").manual_seed(B * nblk + W)
    if dtype == torch.int32:
        pool = torch.randint(0, 100, (NB, bs, W), generator=gen, device="cuda").int()
        new = torch.randint(0, 100, (B, nblk, bs, W), generator=gen, device="cuda").int()
    else:
        pool, new = _randn(gen, (NB, bs, W), dtype), _randn(gen, (B, nblk, bs, W), dtype)
    tbl = _tables(gen, B, nblk, NB, [nblk - (b % 2) for b in range(B)])
    got = banked_copy(pool.clone(), new, tbl)
    torch.cuda.synchronize()
    assert torch.equal(got, banked_copy_ref(pool, new, tbl))


def test_short_serving_run_launches_as_predicted(card):
    """A reduced stablelm-1.6b (head dim 32) served on the card: launch counts
    as the traffic-only run predicts them, and the same tokens as the plain
    attention path (float32 compute and KV, where no near-tie is in reach)."""
    _serve_reduced(head_dim=32)


def test_short_serving_run_at_head_dim_16(card):
    """The reduced configs' own head dim of 16 decodes through the kernels."""
    _serve_reduced(head_dim=16)


def test_short_moe_serving_run_at_head_dim_128(card):
    """A reduced olmoe-1b-7b (MoE on every layer, QK-norm) at its own head
    dim of 128, one KV head per query head, through the kernels."""
    _serve_reduced(head_dim=128, arch="olmoe-1b-7b")


def _serve_reduced(head_dim, arch="stablelm-1.6b"):
    from repro_torch.configs import get_config, smoke
    from repro_torch.launch import serve
    from repro_torch.models import model as M

    cfg = smoke(get_config(arch), head_dim=head_dim)
    spec = serve.SMOKE
    prompts = serve.make_prompts(cfg, spec, seed=1)
    plan, _ = serve.new_engine(None, None, spec, prompts)
    plan.run()
    model = M.init_params(cfg, 0, compute_dtype=torch.float32, kv_dtype=torch.float32)
    tokens = {}
    for impl in ("kernel", "ref"):
        model.impl = impl
        reset_launches()
        eng, reqs = serve.new_engine(cfg, model, spec, prompts)
        eng.run()
        tokens[impl] = [r.out_tokens for r in reqs]
        launches = dict(LAUNCHES)
        if impl == "kernel":
            L = cfg.num_layers
            assert launches["flash_attention"] == L * plan.stats.admissions
            assert launches["banked_copy"] == plan.stats.admissions
            assert launches["paged_attention"] == L * plan.stats.decode_steps
            assert launches["paged_attention_merge"] == L * plan.stats.decode_steps
            assert eng.steps == plan.steps and all(r.done for r in reqs)
        else:
            assert sum(launches.values()) == 0
    assert tokens["kernel"] == tokens["ref"]
