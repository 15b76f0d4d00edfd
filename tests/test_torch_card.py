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
        (1, 1024, 1024, 32, 32, 80, True, 0),  # stablelm-3b's longest prompt, D = 80
        (1, 1, 1, 4, 4, 80, True, 0),  # S = 1 at D = 80
        (1, 100, 333, 8, 1, 80, False, 0),  # ragged T, GQA 8:1, D = 80
        (1, 300, 300, 8, 2, 80, True, 64),  # window, D = 80
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
        (8, 32, 32, 80, 512, 16, 128),  # stablelm-3b's decode: one head per group, D = 80
        (3, 8, 4, 80, 64, 16, 8),  # D = 80, 2 heads per group
        (3, 8, 2, 80, 64, 16, 8),  # D = 80, 4 heads per group
        (3, 16, 2, 80, 64, 16, 8),  # D = 80, 8 heads per group
        (4, 64, 8, 128, 256, 16, 16),  # chameleon-34b's 8 heads per group at D = 128
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
@pytest.mark.parametrize("bs,D", [(16, 64), (8, 16), (32, 128), (16, 80)])
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


def test_short_serving_run_at_head_dim_80(card):
    """A reduced stablelm-3b at its own head dim of 80 (20 rotary dims)
    through the kernels' D = 80 instantiations."""
    _serve_reduced(head_dim=80, arch="stablelm-3b")


def test_head_dim_80_kernels_repeat_bit_for_bit(card):
    """Two calls of flash (with and without lse), the backward and paged
    at stablelm-3b's heads (32 of 80) give the same bits, bf16 and float32."""
    from repro_torch.kernels.flash_attention.ops import (
        flash_attention,
        flash_attention_bwd,
        flash_attention_fwd,
    )
    from repro_torch.kernels.paged_attention.ops import paged_attention

    gen = torch.Generator(device="cuda").manual_seed(80)
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v = (_randn(gen, (1, 777, 32, 80), dtype) for _ in range(3))
        assert torch.equal(flash_attention(q, k, v), flash_attention(q, k, v))
        first, second = flash_attention_fwd(q, k, v), flash_attention_fwd(q, k, v)
        assert all(torch.equal(a, b) for a, b in zip(first, second))
        assert torch.equal(first[0], flash_attention(q, k, v))
        dout = _randn(gen, (1, 777, 32, 80), dtype)
        one, two = (flash_attention_bwd(q, k, v, *first, dout) for _ in range(2))
        assert all(torch.equal(a, b) for a, b in zip(one, two))
        pool = _randn(gen, (512, 16, 2, 2, 32, 80), dtype)
        kp, vp = pool[:, :, 1, 0], pool[:, :, 1, 1]
        lens = [585, 1061, 0, 700]
        tbl = _tables(gen, 4, 128, 512, [-(-n // 16) for n in lens])
        ln = torch.tensor(lens, dtype=torch.int32, device="cuda")
        q = _randn(gen, (4, 32, 80), dtype)
        assert torch.equal(paged_attention(q, kp, vp, tbl, ln), paged_attention(q, kp, vp, tbl, ln))


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


# ---------------------------------------------------------------------------
# Training: the flash forward's log-sum-exp and the flash backward kernel
# ---------------------------------------------------------------------------

#: bounds of the backward kernel against its plain version, as the largest
#: abs difference over the largest abs entry of each of dQ, dK, dV: both
#: compute in float32 and differ in summation order (float32), and by one
#: rounding of each output to bfloat16 (bf16 inputs: 2^-8 of an entry); the
#: bf16 kernel also rounds P and dS to bf16 before the products they feed
#: (``tests/test_torch_flash_bwd.py`` bounds those roundings by 5e-3)
BWD_REL_TOL = {torch.float32: 1e-4, torch.bfloat16: 1e-2}

BWD_CASES = [
    (1, 256, 256, 4, 2, 64, True, 0),  # GQA 2:1
    (2, 77, 77, 8, 2, 16, True, 0),  # ragged S, D = 16
    (1, 100, 333, 8, 1, 32, False, 0),  # ragged T, GQA 8:1, no mask
    (1, 300, 300, 4, 4, 64, True, 64),  # window
    (2, 200, 200, 16, 4, 128, True, 0),  # D = 128, GQA 4:1
    (1, 517, 517, 32, 32, 64, True, 0),  # stablelm-1.6b's heads, ragged S
    (1, 1024, 1024, 16, 16, 128, True, 0),  # olmoe-1b-7b's heads
    (2, 600, 600, 8, 2, 128, True, 128),  # window at D = 128, GQA 4:1
    (1, 400, 400, 4, 2, 32, False, 100),  # window without the causal mask
    (2, 1000, 1000, 16, 4, 128, True, 0),  # D = 128, GQA 4:1, S not a multiple of 64
    (1, 300, 500, 8, 2, 64, True, 0),  # causal, T > S
    (1, 500, 300, 8, 2, 64, True, 0),  # causal, T < S
    (1, 517, 517, 32, 32, 80, True, 0),  # stablelm-3b's heads, D = 80, ragged S
    (2, 300, 300, 8, 2, 80, True, 64),  # window at D = 80, GQA 4:1
    (1, 100, 333, 8, 1, 80, False, 0),  # ragged T at D = 80, no mask
    (1, 300, 500, 8, 8, 80, True, 0),  # causal, T > S, D = 80
]


def _bwd_inputs(gen, B, S, T, H, G, D, causal, window, dtype):
    from repro_torch.kernels.flash_attention.ops import flash_attention_fwd

    q = _randn(gen, (B, S, H, D), dtype)
    k, v = _randn(gen, (B, T, G, D), dtype), _randn(gen, (B, T, G, D), dtype)
    out, lse = flash_attention_fwd(q, k, v, causal=causal, window=window)
    dout = _randn(gen, (B, S, H, D), dtype)
    return q, k, v, out, lse, dout


def _rel_err(got, want) -> float:
    want = want.double()
    return float((got.double() - want).abs().max() / want.abs().max().clamp_min(1e-30))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,T,H,G,D,causal,window", BWD_CASES)
def test_flash_bwd_kernel_matches_plain(card, B, S, T, H, G, D, causal, window, dtype):
    from repro_torch.kernels.flash_attention.ops import flash_attention_bwd
    from repro_torch.kernels.flash_attention.ref import flash_attention_bwd_ref

    gen = torch.Generator(device="cuda").manual_seed(S + T + D)
    args = _bwd_inputs(gen, B, S, T, H, G, D, causal, window, dtype)
    before = LAUNCHES["flash_attention_bwd"]
    got = flash_attention_bwd(*args, causal=causal, window=window)
    torch.cuda.synchronize()
    assert LAUNCHES["flash_attention_bwd"] == before + 1
    want = flash_attention_bwd_ref(*args, causal=causal, window=window)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        assert a.dtype == dtype and a.shape == b.shape
        assert _rel_err(a, b) <= BWD_REL_TOL[dtype], name


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 1e-3)])
@pytest.mark.parametrize("B,S,T,H,G,D,causal,window", BWD_CASES)
def test_flash_fwd_lse_matches_plain(card, B, S, T, H, G, D, causal, window, dtype, tol):
    """The log-sum-exp the forward writes, against the plain blockwise
    forward's; the output equals the serving call's (no lse) bit for bit."""
    from repro_torch.kernels.flash_attention.ops import flash_attention, flash_attention_fwd
    from repro_torch.kernels.flash_attention.ref import flash_attention_fwd_ref

    gen = torch.Generator(device="cuda").manual_seed(S + T)
    q = _randn(gen, (B, S, H, D), dtype)
    k, v = _randn(gen, (B, T, G, D), dtype), _randn(gen, (B, T, G, D), dtype)
    out, lse = flash_attention_fwd(q, k, v, causal=causal, window=window)
    _, want = flash_attention_fwd_ref(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert lse.shape == (B, H, S) and lse.dtype == torch.float32
    assert float((lse - want).abs().max()) <= tol
    assert torch.equal(out, flash_attention(q, k, v, causal=causal, window=window))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_fwd_lse_of_rows_without_keys(card, dtype):
    """No key at all (T = 0): out 0 and lse -inf, on both routes."""
    from repro_torch.kernels.flash_attention.ops import flash_attention_fwd

    q = torch.randn(1, 5, 4, 64, device="cuda").to(dtype)
    k = torch.empty(1, 0, 2, 64, device="cuda", dtype=dtype)
    out, lse = flash_attention_fwd(q, k, k, causal=False)
    torch.cuda.synchronize()
    assert bool((out == 0).all()) and bool(torch.isneginf(lse).all())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_bwd_kernel_repeats_bit_for_bit(card, dtype):
    from repro_torch.kernels.flash_attention.ops import flash_attention_bwd

    gen = torch.Generator(device="cuda").manual_seed(3)
    args = _bwd_inputs(gen, 2, 600, 600, 8, 2, 64, True, 0, dtype)
    first = flash_attention_bwd(*args)
    second = flash_attention_bwd(*args)
    assert all(torch.equal(a, b) for a, b in zip(first, second))


def test_flash_bwd_wrapper_refuses(card):
    from repro_torch.kernels.flash_attention.ops import flash_attention_bwd

    gen = torch.Generator(device="cuda").manual_seed(4)
    q, k, v, out, lse, dout = _bwd_inputs(gen, 1, 64, 64, 4, 2, 64, True, 0, torch.bfloat16)
    with pytest.raises(ValueError):
        flash_attention_bwd(q, k, v, out, lse, dout[:, :32])  # dout's shape
    with pytest.raises(ValueError):
        flash_attention_bwd(q, k, v, out, lse, dout.float())  # dout's dtype
    with pytest.raises(ValueError):
        flash_attention_bwd(q, k, v, out, lse[:, :2], dout)  # lse's shape
    with pytest.raises(ValueError):
        flash_attention_bwd(q, k, v, out, lse.cpu(), dout)  # lse's device
    with pytest.raises(ValueError):
        flash_attention_bwd(q, k, v, out.transpose(1, 2).contiguous().transpose(1, 2), lse, dout)
    with pytest.raises(TypeError):
        flash_attention_bwd(q.half(), k.half(), v.half(), out.half(), lse, dout.half())
    buf = torch.empty(dout.numel() + 8, device="cuda", dtype=dout.dtype)
    with pytest.raises(ValueError):  # dout 2 bytes past a 16-byte boundary (TMA)
        flash_attention_bwd(q, k, v, out, lse, buf[1 : 1 + dout.numel()].view_as(dout))
    q48 = torch.zeros(1, 8, 4, 48, device="cuda", dtype=torch.bfloat16)
    k48 = torch.zeros(1, 8, 2, 48, device="cuda", dtype=torch.bfloat16)
    with pytest.raises(ValueError):  # a head dim the kernel is not built for
        flash_attention_bwd(q48, k48, k48, q48, lse[..., :8].contiguous(), q48)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_train_autograd_on_card(card, dtype):
    """The autograd Function launches the forward and the backward kernel
    once each and agrees with the plain Function's gradients."""
    from repro_torch.kernels.flash_attention.ops import flash_attention_train
    from repro_torch.kernels.flash_attention.ref import flash_attention_train_ref

    gen = torch.Generator(device="cuda").manual_seed(5)
    base = [_randn(gen, s, dtype) for s in ((2, 130, 8, 64), (2, 130, 4, 64), (2, 130, 4, 64))]
    dout = _randn(gen, (2, 130, 8, 64), dtype)
    grads = {}
    for name, fn in (("kernel", flash_attention_train), ("ref", flash_attention_train_ref)):
        xs = [x.clone().requires_grad_(True) for x in base]
        reset_launches()
        fn(*xs, causal=True).backward(dout)
        torch.cuda.synchronize()
        launched = (LAUNCHES["flash_attention"], LAUNCHES["flash_attention_bwd"])
        assert launched == ((1, 1) if name == "kernel" else (0, 0))
        grads[name] = [x.grad for x in xs]
    for a, b in zip(grads["kernel"], grads["ref"]):
        assert _rel_err(a, b) <= BWD_REL_TOL[dtype]


def test_short_training_run_through_the_kernels(card):
    """Three AdamW steps of smoke(stablelm-1.6b) with its head dim at 64 on
    the card, float32 compute: the kernels launch once per layer each way
    (twice forward under full remat) and the losses equal the plain path's
    within 1e-4."""
    from repro_torch.configs import get_config, smoke
    from repro_torch.configs.base import RunConfig
    from repro_torch.data.pipeline import TokenPipeline
    from repro_torch.train import step as S

    cfg = smoke(get_config("stablelm-1.6b"), head_dim=64)
    losses = {}
    for impl in ("pallas", "jnp"):
        run = RunConfig(compute_dtype="float32", attn_impl=impl, learning_rate=1e-3, warmup_steps=1)
        state = S.init_train_state(cfg, run, 0)
        fn = S.make_train_step(cfg, run, total_steps=3)
        pipe = TokenPipeline(cfg.vocab_size, batch=2, seq_len=64)
        reset_launches()
        losses[impl] = [float(fn(state, next(pipe))[1]["loss"]) for _ in range(3)]
        want = (3 * 2 * cfg.num_layers, 3 * cfg.num_layers) if impl == "pallas" else (0, 0)
        assert (LAUNCHES["flash_attention"], LAUNCHES["flash_attention_bwd"]) == want
    np.testing.assert_allclose(losses["pallas"], losses["jnp"], rtol=0, atol=1e-4)


def test_short_training_run_at_head_dim_80(card):
    """Three AdamW steps of smoke(stablelm-3b) at its own head dim of 80
    on the card, float32 compute: launches as above and the losses equal
    the plain path's within 1e-4."""
    from repro_torch.configs import get_config, smoke
    from repro_torch.configs.base import RunConfig
    from repro_torch.data.pipeline import TokenPipeline
    from repro_torch.train import step as S

    cfg = smoke(get_config("stablelm-3b"), head_dim=80)
    losses = {}
    for impl in ("pallas", "jnp"):
        run = RunConfig(compute_dtype="float32", attn_impl=impl, learning_rate=1e-3, warmup_steps=1)
        state = S.init_train_state(cfg, run, 0)
        fn = S.make_train_step(cfg, run, total_steps=3)
        pipe = TokenPipeline(cfg.vocab_size, batch=2, seq_len=100)
        reset_launches()
        losses[impl] = [float(fn(state, next(pipe))[1]["loss"]) for _ in range(3)]
        want = (3 * 2 * cfg.num_layers, 3 * cfg.num_layers) if impl == "pallas" else (0, 0)
        assert (LAUNCHES["flash_attention"], LAUNCHES["flash_attention_bwd"]) == want
    np.testing.assert_allclose(losses["pallas"], losses["jnp"], rtol=0, atol=1e-4)


# ---------------------------------------------------------------------------
# MLA serving (deepseek-v2): flash at QK width 192 / V width 128, the latent
# paged call over rows of 576, banked_copy at the 27 x 576-wide pool row
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5), (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize(
    "B,S,T,H,G,causal",
    [
        (1, 128, 128, 16, 16, True),  # deepseek-v2-lite-16b's shortest prompts
        (1, 517, 517, 16, 16, True),  # ragged S
        (1, 1024, 1024, 16, 16, True),  # its longest prompt
        (2, 77, 77, 4, 2, True),  # GQA 2:1, a partial tile
        (1, 100, 333, 8, 1, False),  # ragged T, GQA 8:1, no mask
        (1, 1, 1, 16, 16, True),
    ],
)
def test_flash_attention_mla_widths_match_plain(card, B, S, T, H, G, causal, dtype, tol):
    """q/k heads of 192 and v heads of 128 at the caller's scale, 192^-0.5."""
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref

    gen = torch.Generator(device="cuda").manual_seed(S + T + 7)
    q = _randn(gen, (B, S, H, 192), dtype)
    k, v = _randn(gen, (B, T, G, 192), dtype), _randn(gen, (B, T, G, 128), dtype)
    before = LAUNCHES["flash_attention"]
    got = flash_attention(q, k, v, causal=causal, scale=192**-0.5)
    torch.cuda.synchronize()
    assert LAUNCHES["flash_attention"] == before + 1 and got.shape == (B, S, H, 128)
    want = flash_attention_ref(q, k, v, causal=causal, scale=192**-0.5)
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)
    assert torch.equal(got, flash_attention(q, k, v, causal=causal, scale=192**-0.5))


def test_flash_attention_mla_widths_train_and_other_widths_refuse(card):
    """(192, 128) takes the lse and the backward; (128, 64) and (192, 192)
    raise in the forward, the forward with lse and the backward."""
    from repro_torch.kernels.flash_attention.ops import (
        flash_attention,
        flash_attention_bwd,
        flash_attention_fwd,
    )

    q = torch.zeros(1, 64, 16, 192, device="cuda", dtype=torch.bfloat16)
    k, v = q.clone(), torch.zeros(1, 64, 16, 128, device="cuda", dtype=torch.bfloat16)
    before = (LAUNCHES["flash_attention"], LAUNCHES["flash_attention_bwd"])
    out, lse = flash_attention_fwd(q, k, v)
    dq, dk, dv = flash_attention_bwd(q, k, v, out, lse, out.clone())
    torch.cuda.synchronize()
    assert (LAUNCHES["flash_attention"], LAUNCHES["flash_attention_bwd"]) == (
        before[0] + 1,
        before[1] + 1,
    )
    assert out.shape == dv.shape == v.shape and dq.shape == dk.shape == q.shape
    q128, k128, v64 = (t.contiguous() for t in (q[..., :128], k[..., :128], v[..., :64]))
    for qq, kk, vv in ((q128, k128, v64), (q, k, q)):  # pairs the kernels are not built for
        with pytest.raises(ValueError):
            flash_attention(qq, kk, vv)
        with pytest.raises(ValueError):
            flash_attention_fwd(qq, kk, vv)
        o = torch.zeros(*qq.shape[:3], vv.shape[3], device="cuda", dtype=qq.dtype)
        with pytest.raises(ValueError):
            flash_attention_bwd(qq, kk, vv, o, lse, o)


#: MLA training (deepseek-v2: 16 heads, q/k 192, v 128, one KV group a
#: head): the forward with lse and the backward against the plain versions
MLA_TRAIN_CASES = [
    (2, 4096, 4096, 16, 16, True),  # the training path's shape (train_4k, batch cut to 2)
    (1, 517, 517, 16, 16, True),  # ragged S
    (1, 300, 500, 8, 8, True),  # causal, T > S
    (1, 500, 300, 8, 8, True),  # causal, T < S
    (1, 200, 333, 4, 2, False),  # no mask, ragged T, GQA 2:1
]


def _mla_train_inputs(gen, B, S, T, H, G, dtype):
    q = _randn(gen, (B, S, H, 192), dtype)
    k, v = _randn(gen, (B, T, G, 192), dtype), _randn(gen, (B, T, G, 128), dtype)
    return q, k, v, _randn(gen, (B, S, H, 128), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,T,H,G,causal", MLA_TRAIN_CASES)
def test_flash_mla_widths_train_match_plain(card, B, S, T, H, G, causal, dtype):
    """The forward's output and lse and dQ, dK, dV at (192, 128), scale
    192^-0.5: one launch each; two backward calls bit for bit."""
    from repro_torch.kernels.flash_attention.ops import flash_attention_bwd, flash_attention_fwd
    from repro_torch.kernels.flash_attention.ref import (
        flash_attention_bwd_ref,
        flash_attention_fwd_ref,
    )

    gen = torch.Generator(device="cuda").manual_seed(S + 3 * T)
    q, k, v, dout = _mla_train_inputs(gen, B, S, T, H, G, dtype)
    kw = dict(causal=causal, scale=192**-0.5)
    reset_launches()
    out, lse = flash_attention_fwd(q, k, v, **kw)
    got = flash_attention_bwd(q, k, v, out, lse, dout, **kw)
    torch.cuda.synchronize()
    assert (LAUNCHES["flash_attention"], LAUNCHES["flash_attention_bwd"]) == (1, 1)
    out_ref, lse_ref = flash_attention_fwd_ref(q, k, v, **kw)
    assert out.shape == (B, S, H, 128) and lse.shape == (B, H, S)
    assert _rel_err(out, out_ref) <= BWD_REL_TOL[dtype]
    assert float((lse - lse_ref).abs().max()) <= (1e-4 if dtype == torch.float32 else 1e-3)
    want = flash_attention_bwd_ref(q, k, v, out, lse, dout, **kw)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        assert a.dtype == dtype and a.shape == b.shape
        assert _rel_err(a, b) <= BWD_REL_TOL[dtype], name
    again = flash_attention_bwd(q, k, v, out, lse, dout, **kw)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


def test_short_mla_training_run_through_the_kernels(card):
    """Three AdamW steps of a 2-layer stack at deepseek-v2-lite-16b's
    attention widths (16 heads, kv_lora_rank 512, qk 128 + 64, v 128; d 256,
    4 experts) on the card, float32 compute: 2 forward and 1 backward launch
    per layer and step (full remat), losses equal to the plain path's
    within 1e-4."""
    from repro_torch.configs import get_config, smoke
    from repro_torch.configs.base import RunConfig
    from repro_torch.data.pipeline import TokenPipeline
    from repro_torch.train import step as S

    cfg = smoke(
        get_config("deepseek-v2-lite-16b"),
        num_heads=16,
        num_kv_heads=16,
        d_model=256,
        kv_lora_rank=512,
        qk_nope_dim=128,
        qk_rope_dim=64,
        v_head_dim=128,
    )
    losses = {}
    for impl in ("pallas", "jnp"):
        run = RunConfig(compute_dtype="float32", attn_impl=impl, learning_rate=1e-3, warmup_steps=1)
        state = S.init_train_state(cfg, run, 0)
        fn = S.make_train_step(cfg, run, total_steps=3)
        pipe = TokenPipeline(cfg.vocab_size, batch=2, seq_len=256)
        reset_launches()
        losses[impl] = [float(fn(state, next(pipe))[1]["loss"]) for _ in range(3)]
        want = (3 * 2 * cfg.num_layers, 3 * cfg.num_layers) if impl == "pallas" else (0, 0)
        assert (LAUNCHES["flash_attention"], LAUNCHES["flash_attention_bwd"]) == want
    assert all(np.isfinite(losses["pallas"]))
    np.testing.assert_allclose(losses["pallas"], losses["jnp"], rtol=0, atol=1e-4)


def _latent_inputs(gen, dtype, lens, *, bs=16, mb=None, layers=3):
    """q ``[B, 16, 576]`` and a strided layer view of an all-layer latent pool
    (``[NB, bs, L, 576]``), tables of distinct blocks, int32 lengths."""
    mb = mb or max(-(-n // bs) for n in lens) + 1
    NB = len(lens) * mb + 3
    pool = _randn(gen, (NB, bs, layers, 576), dtype)
    kv = pool[:, :, 1, None]  # [NB, bs, 1, 576]
    tbl = _tables(gen, len(lens), mb, NB, [min(-(-n // bs), mb) for n in lens])
    q = _randn(gen, (len(lens), 16, 576), dtype) * 0.3
    return q, kv, tbl, torch.tensor(lens, dtype=torch.int32, device="cuda")


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5), (torch.bfloat16, 3e-2)])
@pytest.mark.parametrize(
    "lens,bs,mb",
    [
        ([585, 1061, 0, 700, 1024, 128, 845, 990], 16, None),  # the serving path's, one idle slot
        ([1, 64, 65, 128, 200, 0], 16, None),  # one row, a split exactly, one past, a ragged block
        ([37, 9, 0, 64], 8, None),
        ([300, 1, 129], 128, None),  # one 128-row block per split: two batches in a split
        # bf16: 16 CTAs a request, chunks of ceil(length / 16) in stages of 32 rows:
        # 3 stages (1100: 69 a CTA), 2 full stages (1024), exactly one stage (512),
        # one past it (528: 33), one short of it (496: 31), CTAs with no token (17)
        ([1100, 1024, 512, 528, 496, 17, 0, 33], 16, None),
        ([2048], 16, 128),  # one request at the serving table's full width
        ([16384], 16, 1024),  # the longest table the call takes: 32 stages a CTA
        ([0, 0, 0], 16, None),  # every slot idle
    ],
)
def test_paged_latent_call_matches_plain(card, lens, bs, mb, dtype, tol):
    """The latent call (16 heads, K rows of 576, V their first 512 columns)
    against the plain version; idle slots get 0; launches count under the
    paged names (bf16: one launch, the merge inside it; float32: the split
    and the merge); two calls agree bit for bit."""
    from repro_torch.kernels.paged_attention.ops import paged_attention
    from repro_torch.kernels.paged_attention.ref import paged_attention_ref

    gen = torch.Generator(device="cuda").manual_seed(len(lens) * bs)
    q, kv, tbl, ln = _latent_inputs(gen, dtype, lens, bs=bs, mb=mb)
    before = (LAUNCHES["paged_attention"], LAUNCHES["paged_attention_merge"])
    got = paged_attention(q, kv, kv[..., :512], tbl, ln, scale=192**-0.5)
    torch.cuda.synchronize()
    after = (LAUNCHES["paged_attention"], LAUNCHES["paged_attention_merge"])
    merges = int(dtype == torch.float32)
    assert after == (before[0] + 1, before[1] + merges) and got.shape == (len(lens), 16, 512)
    want = paged_attention_ref(q, kv, kv[..., :512], tbl, ln, scale=192**-0.5)
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)
    for b, n in enumerate(lens):
        if n == 0:
            assert (got[b] == 0).all()
    assert torch.equal(got, paged_attention(q, kv, kv[..., :512], tbl, ln, scale=192**-0.5))


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5), (torch.bfloat16, 3e-2)])
def test_paged_latent_call_masks_unused_blocks(card, dtype, tol):
    """-1 table entries inside the length: at a request's start, in its
    middle and at its last block; a request whose every block is -1 gets 0."""
    from repro_torch.kernels.paged_attention.ops import paged_attention
    from repro_torch.kernels.paged_attention.ref import paged_attention_ref

    gen = torch.Generator(device="cuda").manual_seed(13)
    lens = [700, 300, 1000, 40]
    q, kv, tbl, ln = _latent_inputs(gen, dtype, lens, bs=16)
    tbl[0, 0] = -1
    tbl[1, 5:9] = -1
    tbl[2, 62] = -1  # the last block of 1000 tokens
    tbl[3, :3] = -1
    got = paged_attention(q, kv, kv[..., :512], tbl, ln, scale=192**-0.5)
    torch.cuda.synchronize()
    want = paged_attention_ref(q, kv, kv[..., :512], tbl, ln, scale=192**-0.5)
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)
    assert (got[3] == 0).all()


def test_paged_latent_call_refuses(card):
    from repro_torch.kernels.paged_attention.ops import paged_attention

    gen = torch.Generator(device="cuda").manual_seed(9)
    q, kv, tbl, ln = _latent_inputs(gen, torch.bfloat16, [40, 9])
    with pytest.raises(ValueError):  # V not a view of K's first columns
        paged_attention(q, kv, kv[..., :512].clone(), tbl, ln)
    with pytest.raises(ValueError):  # another head count
        paged_attention(q[:, :8].contiguous(), kv, kv[..., :512], tbl, ln)
    with pytest.raises(ValueError):  # another V width
        paged_attention(q, kv, kv[..., :256], tbl, ln)
    wide = torch.full((2, 1025), -1, dtype=torch.int32, device="cuda")
    with pytest.raises(ValueError):  # a block table past the 1024 entries it stages
        paged_attention(q, kv, kv[..., :512], wide, ln)


def test_banked_copy_at_the_mla_pool_row(card):
    """A 64-block burst into deepseek-v2-lite-16b's pool rows: W = 27 x 576 =
    15552 bf16, a 16-row tile of 497,664 bytes."""
    from repro_torch.kernels.banked_copy.ops import banked_copy
    from repro_torch.kernels.banked_copy.ref import banked_copy_ref

    gen = torch.Generator(device="cuda").manual_seed(11)
    W, bs, NB, nblk = 27 * 576, 16, 160, 64
    pool = _randn(gen, (NB, bs, W), torch.bfloat16)
    new = _randn(gen, (1, nblk, bs, W), torch.bfloat16)
    tbl = _tables(gen, 1, nblk, NB, [nblk - 1])  # ends with a -1 entry
    got = banked_copy(pool.clone(), new, tbl)
    torch.cuda.synchronize()
    assert torch.equal(got, banked_copy_ref(pool, new, tbl))


def test_short_mla_serving_run(card):
    """deepseek-v2-lite-16b's attention widths (16 heads, kv_lora_rank 512,
    qk 128 + 64, v 128) on a narrow 2-layer stack with 4 experts, served on
    the card: launches as the traffic-only run predicts, and the same tokens
    as the plain attention path (float32 compute and KV)."""
    from repro_torch.configs import get_config, smoke
    from repro_torch.launch import serve
    from repro_torch.models import model as M

    cfg = smoke(
        get_config("deepseek-v2-lite-16b"),
        num_heads=16,
        num_kv_heads=16,
        d_model=256,
        kv_lora_rank=512,
        qk_nope_dim=128,
        qk_rope_dim=64,
        v_head_dim=128,
    )
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
        if impl == "kernel":
            L = cfg.num_layers
            assert LAUNCHES["flash_attention"] == L * plan.stats.admissions
            assert LAUNCHES["banked_copy"] == plan.stats.admissions
            assert LAUNCHES["paged_attention"] == L * plan.stats.decode_steps
            assert LAUNCHES["paged_attention_merge"] == L * plan.stats.decode_steps
        else:
            assert sum(LAUNCHES.values()) == 0
    assert tokens["kernel"] == tokens["ref"]


# ---------------------------------------------------------------------------
# Sliding windows (h2o-danube-1.8b): the paged kernel masks the rows before
# ``length - window``, skips the splits wholly before it and merges from the
# first live one; the flash forward and backward at the window of 4096
# ---------------------------------------------------------------------------

#: lengths against a window of 4096 over 256-token splits (16 blocks of 16):
#: the start inside split 16 (16 dead splits), on a split boundary (17 dead),
#: inside split 19 (more than 16 dead), inside split 0, short of the window,
#: and an idle slot
WINDOW_LENS = [8224, 8448, 9000, 4097, 100, 0]


def _window_case(gen, m, D, dtype, lens=WINDOW_LENS, G=2, bs=16, mb=600):
    used = [-(-n // bs) for n in lens]
    NB = sum(used) + 7
    kp, vp = (_randn(gen, (NB, bs, G, D), dtype) for _ in range(2))
    tbl = _tables(gen, len(lens), mb, NB, used)
    q = _randn(gen, (len(lens), G * m, D), dtype)
    return q, kp, vp, tbl, torch.tensor(lens, dtype=torch.int32, device="cuda")


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5), (torch.bfloat16, 3e-2)])
@pytest.mark.parametrize("D", [64, 80, 128])
@pytest.mark.parametrize("m", [1, 4, 8])
def test_paged_window_matches_plain(card, m, D, dtype, tol):
    from repro_torch.kernels.paged_attention.ops import paged_attention
    from repro_torch.kernels.paged_attention.ref import paged_attention_ref

    gen = torch.Generator(device="cuda").manual_seed(m * D)
    args = _window_case(gen, m, D, dtype)
    for window in (1, 16, 1000, 4096):  # a row, a block, no block multiple, h2o-danube's
        before = (LAUNCHES["paged_attention"], LAUNCHES["paged_attention_merge"])
        got = paged_attention(*args, window=window)
        torch.cuda.synchronize()
        after = (LAUNCHES["paged_attention"], LAUNCHES["paged_attention_merge"])
        assert after == (before[0] + 1, before[1] + 1)  # one split and one merge a call
        want = paged_attention_ref(*args, window=window)
        assert float((got.double() - want.double()).abs().max()) <= tol, window
        assert bool((got[-1] == 0).all())  # the idle slot
        assert torch.equal(got, paged_attention(*args, window=window))  # bit for bit


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_paged_window_at_or_past_the_length_is_a_no_op(card, dtype):
    """A window equal to a request's length or past it changes no bit, and
    one shorter than a context changes the output (the mask is live)."""
    from repro_torch.kernels.paged_attention.ops import paged_attention

    gen = torch.Generator(device="cuda").manual_seed(5)
    lens = [3000, 2999, 1, 4500, 0]
    q, kp, vp, tbl, ln = _window_case(gen, 4, 80, dtype, lens=lens, G=8)
    plain = paged_attention(q, kp, vp, tbl, ln)
    at = paged_attention(q, kp, vp, tbl, ln, window=3000)
    past = paged_attention(q, kp, vp, tbl, ln, window=20000)
    assert torch.equal(past, plain)
    assert all(torch.equal(at[b], plain[b]) for b in range(3))  # lengths <= 3000
    assert not torch.allclose(at[3].float(), plain[3].float(), atol=1e-3)  # 4500 > 3000


def test_paged_window_on_the_h2o_danube_pool(card):
    """h2o-danube's decode call: 8 slots, 32 query heads over 8 groups at 80,
    a layer's strided views of a 24-layer pool, the WINDOW mix's lengths at
    mid-decode, a 520-block table (33 splits), one slot idle."""
    from repro_torch.kernels.paged_attention.ops import paged_attention
    from repro_torch.kernels.paged_attention.ref import paged_attention_ref

    gen = torch.Generator(device="cuda").manual_seed(24)
    lens = [8208, 8208, 8208, 0, 4081, 4096, 4100, 4112]
    for dtype, tol in ((torch.float32, 2e-5), (torch.bfloat16, 3e-2)):
        pool = _randn(gen, (4224, 16, 24, 2, 8, 80), dtype)
        kp, vp = pool[:, :, 7, 0], pool[:, :, 7, 1]
        tbl = _tables(gen, 8, 520, 4224, [-(-n // 16) for n in lens])
        ln = torch.tensor(lens, dtype=torch.int32, device="cuda")
        q = _randn(gen, (8, 32, 80), dtype)
        got = paged_attention(q, kp, vp, tbl, ln, window=4096)
        want = paged_attention_ref(q, kp, vp, tbl, ln, window=4096)
        assert float((got.double() - want.double()).abs().max()) <= tol
        assert bool((got[3] == 0).all())
        assert not torch.allclose(got[0].float(), paged_attention(q, kp, vp, tbl, ln)[0].float())
        del pool, kp, vp


def test_paged_window_refusals(card):
    from repro_torch.kernels.paged_attention.ops import paged_attention

    gen = torch.Generator(device="cuda").manual_seed(1)
    q, kp, vp, tbl, ln = _window_case(gen, 1, 64, torch.bfloat16, lens=[10, 0], mb=4)
    with pytest.raises(ValueError, match="window"):
        paged_attention(q, kp, vp, tbl, ln, window=-1)
    kv = _randn(gen, (8, 16, 1, 576), torch.bfloat16)
    tbl = _tables(gen, 2, 4, 8, [1, 0])
    ql = _randn(gen, (2, 16, 576), torch.bfloat16)
    with pytest.raises(ValueError, match="latent call takes no window"):
        paged_attention(ql, kv, kv[..., :512], tbl, ln, window=16)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_window_4096_at_h2o_danube_heads(card, dtype):
    """The prefill flash (with and without lse) and the backward at
    h2o-danube's heads (32 over 8 groups at 80), S = 8192, window 4096."""
    from repro_torch.kernels.flash_attention.ops import (
        flash_attention,
        flash_attention_bwd,
        flash_attention_fwd,
    )
    from repro_torch.kernels.flash_attention.ref import (
        flash_attention_bwd_ref,
        flash_attention_fwd_ref,
    )

    gen = torch.Generator(device="cuda").manual_seed(4096)
    q = _randn(gen, (1, 8192, 32, 80), dtype)
    k, v = (_randn(gen, (1, 8192, 8, 80), dtype) for _ in range(2))
    out, lse = flash_attention_fwd(q, k, v, window=4096)
    want, want_lse = flash_attention_fwd_ref(q, k, v, window=4096)
    tol = 1e-5 if dtype == torch.float32 else 1e-2
    assert _rel_err(out, want) <= tol
    assert float((lse - want_lse).abs().max()) <= (1e-4 if dtype == torch.float32 else 1e-3)
    assert torch.equal(flash_attention(q, k, v, window=4096), out)
    dout = _randn(gen, (1, 8192, 32, 80), dtype)
    got = flash_attention_bwd(q, k, v, out, lse, dout, window=4096)
    ref = flash_attention_bwd_ref(q, k, v, out, lse, dout, window=4096)
    for name, a, b in zip(("dq", "dk", "dv"), got, ref):
        assert _rel_err(a, b) <= BWD_REL_TOL[dtype], name
    again = flash_attention_bwd(q, k, v, out, lse, dout, window=4096)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


def test_short_serving_run_with_a_window(card):
    """smoke(h2o-danube-1.8b) (window 16, GQA 4:1) at head dim 80 on the
    card: launches as predicted and the plain path's tokens, float32; the
    SMOKE mix's decode crosses the window."""
    _serve_reduced(head_dim=80, arch="h2o-danube-1.8b")


def test_short_ssm_serving_run(card):
    """smoke(mamba2-1.3b) served on the card: no attention or banked_copy
    launch, the same tokens as on the CPU (float32)."""
    from repro_torch.configs import get_config, smoke
    from repro_torch.launch import serve
    from repro_torch.models import model as M

    cfg = smoke(get_config("mamba2-1.3b"))
    prompts = serve.make_prompts(cfg, serve.SMOKE, seed=1)
    tokens = {}
    for device in ("cuda", "cpu"):
        model = M.init_params(cfg, 0, device="cpu", compute_dtype=torch.float32)
        model = model.to(device)
        reset_launches()
        eng, reqs = serve.new_engine(cfg, model, serve.SMOKE, prompts)
        eng.run()
        assert sum(LAUNCHES.values()) == 0 and all(r.done for r in reqs)
        tokens[device] = [r.out_tokens for r in reqs]
    assert tokens["cuda"] == tokens["cpu"]


def test_short_training_run_with_a_window(card):
    """Three AdamW steps of smoke(h2o-danube-1.8b) at head dim 80 (window 16)
    over sequences of 100 tokens: launches as above, losses equal the plain
    path's within 1e-4 (float32)."""
    from repro_torch.configs import get_config, smoke
    from repro_torch.configs.base import RunConfig
    from repro_torch.data.pipeline import TokenPipeline
    from repro_torch.train import step as S

    cfg = smoke(get_config("h2o-danube-1.8b"), head_dim=80)
    losses = {}
    for impl in ("pallas", "jnp"):
        run = RunConfig(compute_dtype="float32", attn_impl=impl, learning_rate=1e-3, warmup_steps=1)
        state = S.init_train_state(cfg, run, 0)
        fn = S.make_train_step(cfg, run, total_steps=3)
        pipe = TokenPipeline(cfg.vocab_size, batch=2, seq_len=100)
        reset_launches()
        losses[impl] = [float(fn(state, next(pipe))[1]["loss"]) for _ in range(3)]
        want = (3 * 2 * cfg.num_layers, 3 * cfg.num_layers) if impl == "pallas" else (0, 0)
        assert (LAUNCHES["flash_attention"], LAUNCHES["flash_attention_bwd"]) == want
    np.testing.assert_allclose(losses["pallas"], losses["jnp"], rtol=0, atol=1e-4)
