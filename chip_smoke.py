#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA Hopper card.

    python3 chip_smoke.py

Run from the repository root on a machine with a CUDA card and ``nvcc``.
Phases, one JSON line each; any failure exits non-zero:

  1. build      compile every kernel of the port from ``src/repro_torch``
                (one ``nvcc`` per source, all started together)
  2. kernels    each kernel against its plain PyTorch version on the card:
                the arbiter grant for grant over a set of shapes, then
                flash attention, paged attention and banked_copy at the JAX
                tests' shapes, at the edges (S = 1, ragged T, GQA 8:1, head
                dims 16..128, lengths 0, 1, at a split and past the table)
                and at the serving path's shapes; flash and paged twice at
                the path's shapes, bit for bit
  3. golden     the three golden single-slice cases on the card, bit for bit
                against ``tests/data/golden_single_slice.json``
  4. fig4/table1  the paper's Fig. 4 sweep (X = 1..16) and Table I
                (outstanding 16 vs 1) at the prototype's full width with the
                paper's asserts; the X=16 point is the main path: its kernel
                launches are counted and must equal the cycles stepped, and it
                must equal ``arbiter="ref"`` key for key
  5. profile    device kernels, device busy time and idle share per cycle
                of the main path, from ``torch.profiler``
  6. timing     per-call device time of each kernel, its plain version and
                one PyTorch call computing the same function
  7. serving    the second main path: stablelm-1.6b at full width (random
                weights from a seed) through ``repro_torch.launch.serve``,
                16 requests of 128..1024 prompt tokens, 32 new tokens each,
                8 slots; pool isolation after every step; kernel launches
                equal to their prediction from a traffic-only run; the first
                wave teacher-forced through the plain attention versions, its
                logits held to the kernel run's, in bf16 and in float32 (the
                weights keep the reference's init with ``wq``/``wk`` scaled
                by 1/8: see ``_tempered``)
  8. serving_profile  device kernels, busy time and idle share per decode step
  9. llm_timing the three serving kernels' timing rows at the path's shapes
                (and flash at the short prompts, S = 128 and 517)
then the kernels line, the card's name and power limit, and as the last line
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from dataclasses import replace
from pathlib import Path

ROOT = Path(__file__).resolve().parent

#: H100 SXM device memory rate (NVIDIA data sheet), bytes per second
HBM_BYTES_PER_S = 3.35e12
#: H100 SXM non-tensor-core float32 rate, used as the int32 ALU peak
ALU_OPS_PER_S = 67e12
#: H100 SXM dense bf16 tensor-core rate (NVIDIA data sheet)
BF16_OPS_PER_S = 989e12
#: the kernels of the serving path, in the order of the kernels line
LLM_KERNELS = ("banked_copy", "paged_attention", "flash_attention")


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {msg}")


def time_ms(fn, iters: int, warmup: int = 20) -> float:
    """Mean time per call in ms of ``iters`` back-to-back calls of ``fn()``
    between two CUDA events; where the host cannot enqueue faster than the
    device runs, this is the host's time per call."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def device_kernels(fn):
    """Run ``fn()`` under ``torch.profiler``; returns ``(device kernel
    events, host seconds)``.  The list is empty where the profiler records no
    device activity."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    return [e for e in prof.events() if e.device_type == DeviceType.CUDA], wall


def device_ms(fn, iters: int):
    """Mean device time of ``fn()`` in ms from the profiler's kernel events,
    or None where the profiler records no device time."""
    fn()
    kernels, _ = device_kernels(lambda: [fn() for _ in range(iters)])
    busy_us = sum(e.time_range.elapsed_us() for e in kernels)
    return busy_us / iters / 1e3 if busy_us > 0 else None


def arb_inputs(rng, B, S, NB, X, *, elig_p=0.4, bank_dtype=None, key_hi=None):
    """Random arbitration inputs on the card: keys packed as the simulator
    packs them (or drawn from ``[0, key_hi)`` to force ties)."""
    import numpy as np
    import torch

    from repro_torch.core.qos import arbitration_priority_key
    from repro_torch.core.simulator import SimParams, _age_cap

    age_cap = _age_cap(SimParams(), X)
    if key_hi is None:
        level = rng.integers(0, 8, (B, S))
        age = rng.integers(0, min(age_cap + 1, 4096), (B, S))
        rr = rng.integers(0, X, (B, S))
        key = arbitration_priority_key(level, age, rr, age_cap=age_cap, num_masters=X)
    else:
        key = rng.integers(0, key_hi, (B, S))
    bank = rng.integers(0, NB, (B, S))
    elig = rng.random((B, S)) < elig_p
    return (
        torch.tensor(np.asarray(key), dtype=torch.int32, device="cuda"),
        torch.tensor(bank, dtype=bank_dtype or torch.int16, device="cuda"),
        torch.tensor(elig, device="cuda"),
    )


def phase_build() -> None:
    from repro_torch.kernels import _build

    t0 = time.perf_counter()
    paths = _build.build(["bank_arbiter", *LLM_KERNELS])
    emit("build", seconds=time.perf_counter() - t0, libraries={k: str(v) for k, v in paths.items()})


def phase_kernels() -> int:
    """The kernel against its plain version on the card; returns the largest
    absolute difference seen (0 when every grant agrees)."""
    import numpy as np
    import torch

    from repro_torch.kernels.bank_arbiter.ops import bank_arbiter_winners
    from repro_torch.kernels.bank_arbiter.ref import bank_arbiter_ref

    rng = np.random.default_rng(0)
    cases = [
        # (name, B, S, NB, X, options)
        ("sim_core_64x16", 1, 64, 16, 4, {}),
        ("sim_core_256x256", 1, 256, 256, 8, {}),
        ("sim_core_2048x256", 1, 2048, 256, 16, {}),
        ("sim_core_300x130", 1, 300, 130, 8, {}),
        ("paper_8192x256", 1, 8192, 256, 32, {}),
        ("paper_int32_banks", 1, 8192, 256, 32, {"bank_dtype": torch.int32}),
        ("batch4", 4, 8192, 256, 32, {}),
        ("ragged_S", 3, 8193, 256, 32, {}),
        ("one_bank", 2, 4096, 1, 16, {}),
        ("ties", 2, 8192, 256, 32, {"key_hi": 4, "elig_p": 0.9}),
        ("no_eligible", 2, 8192, 256, 32, {"elig_p": 0.0}),
        ("filler_keys", 1, 2048, 64, 8, {"key_hi": 2**30 + 1, "elig_p": 0.5}),
    ]
    worst, rows = 0, []
    for name, B, S, NB, X, opts in cases:
        key, bank, elig = arb_inputs(rng, B, S, NB, X, **opts)
        got = bank_arbiter_winners(key, bank, elig, num_banks=NB)
        torch.cuda.synchronize()
        want = bank_arbiter_ref(key, bank, elig, num_banks=NB)
        torch.cuda.synchronize()
        err = int((got.long() - want.long()).abs().max())
        worst = max(worst, err)
        rows.append(dict(case=name, B=B, S=S, NB=NB, max_abs_err=err))
        check(got.dtype == torch.int32 and got.shape == (B, NB), f"{name}: shape/dtype")
        check(err == 0, f"{name}: kernel disagrees with the plain version")
        if opts.get("elig_p") == 0.0:
            check(bool((got == S).all()), f"{name}: no-winner sentinel")
    emit("kernels", cases=rows, max_abs_err=worst)
    return worst


def phase_golden() -> None:
    import numpy as np

    from repro_torch.core.simulator import simulate, stepped_cycles
    from repro_torch.data import GOLDEN_KEYS, golden_cases

    golden = json.loads((ROOT / "tests" / "data" / "golden_single_slice.json").read_text())
    rows = []
    for name, trace, prm in golden_cases():
        t0 = time.perf_counter()
        out = simulate(trace, prm)
        wall = time.perf_counter() - t0
        bad = [k for k in GOLDEN_KEYS if np.asarray(out[k]).tolist() != golden["cases"][name][k]]
        check(not bad, f"golden {name}: keys differ {bad}")
        stepped = stepped_cycles(out["drained_cycle"], prm)
        rows.append(
            dict(
                case=name,
                drained_cycle=int(out["drained_cycle"]),
                stepped_cycles=stepped,
                wall_s=wall,
                cycles_per_s=stepped / wall,
            )
        )
    emit("golden", cases=rows)


def phase_full_width() -> dict:
    """Fig. 4 and Table I at the prototype's width; returns the main path's
    (fig4 X=16) launch count and cycle numbers."""
    import numpy as np

    from repro_torch.core.simulator import SimParams, Trace, simulate, stepped_cycles
    from repro_torch.core.traffic import random_uniform
    from repro_torch.kernels import LAUNCHES, reset_launches

    num_txns, counts = 300, (1, 2, 4, 8, 16)
    rows, runs = {}, {}
    for X in counts:
        trace = random_uniform(X, num_txns, burst=16, full_duplex=True)
        prm = SimParams(max_cycles=int(num_txns * 16 * 1.3) + 2000)
        if X == counts[-1]:
            reset_launches()
        t0 = time.perf_counter()
        m = simulate(trace, prm)
        wall = time.perf_counter() - t0
        launches = LAUNCHES["bank_arbiter"]
        stepped = stepped_cycles(m["drained_cycle"], prm)
        runs[X] = dict(
            trace=trace, prm=prm, out=m, wall_s=wall, stepped=stepped, launches=launches
        )
        rows[X] = {
            "read_throughput": float(m["read_throughput"][:X].mean()),
            "write_throughput": float(m["write_throughput"][X:].mean()),
            "read_lat": float(m["read_lat_avg"][:X].mean()),
            "write_lat": float(m["write_lat_avg"][X:].mean()),
            "drained_cycle": int(m["drained_cycle"]),
            "stepped_cycles": stepped,
            "wall_s": wall,
            "cycles_per_s": stepped / wall,
        }
    first, last = rows[counts[0]], rows[counts[-1]]
    # paper: ~96 % read / ~99 % write, droop <= ~0.5 pp across the sweep
    check(last["read_throughput"] > 0.93, "fig4: X=16 read throughput")
    check(last["write_throughput"] > 0.97, "fig4: X=16 write throughput")
    check(abs(first["read_throughput"] - last["read_throughput"]) < 0.02, "fig4: droop")
    main = runs[counts[-1]]
    check(
        main["launches"] == main["stepped"],
        f"fig4 X=16: {main['launches']} kernel launches for {main['stepped']} cycles stepped",
    )
    emit("fig4_throughput", rows={str(k): v for k, v in rows.items()}, launches=main["launches"])

    rng = np.random.default_rng(0)
    t_rows = {}
    for o in (16, 1):
        tr = Trace(
            np.zeros((16, 256), np.int32),
            np.full((16, 256), 16, np.int32),
            rng.integers(0, 2**20 - 16, (16, 256)).astype(np.int32),
        )
        prm = SimParams(outstanding=o, max_cycles=256 * 20 + 4000)
        t0 = time.perf_counter()
        m = simulate(tr, prm)
        wall = time.perf_counter() - t0
        stepped = stepped_cycles(m["drained_cycle"], prm)
        t_rows[o] = {
            "read_lat": float(m["read_lat_avg"].mean()),
            "read_throughput": float(m["read_throughput"].mean()),
            "stepped_cycles": stepped,
            "wall_s": wall,
            "cycles_per_s": stepped / wall,
        }
    # paper: 222 vs 36 cycles (about 6x); the same regime is required
    check(25 <= t_rows[1]["read_lat"] <= 45, "table1: 1-outstanding read latency")
    check(t_rows[16]["read_lat"] / t_rows[1]["read_lat"] > 4.5, "table1: latency ratio")
    emit("table1_outstanding", rows={str(k): v for k, v in t_rows.items()})

    t0 = time.perf_counter()
    ref = simulate(main["trace"], replace(main["prm"], arbiter="ref"))
    wall = time.perf_counter() - t0
    bad = [
        k
        for k in main["out"]
        if not (np.array_equal(ref[k], main["out"][k]) and ref[k].dtype == main["out"][k].dtype)
    ]
    check(not bad, f"fig4 X=16: kernel and ref arbiters differ on {bad}")
    emit(
        "fig4_x16_vs_ref",
        keys=len(ref),
        kernel_wall_s=main["wall_s"],
        ref_wall_s=wall,
        stepped_cycles=main["stepped"],
    )
    return main


def phase_profile(main: dict) -> None:
    """Where a cycle's time goes on the main path: device kernels per cycle,
    device busy time per cycle against the unprofiled host time per cycle
    (from the main run), and the arbiter kernel's share of the device time."""
    from repro_torch.core.simulator import simulate

    cycles = 96
    prm = replace(main["prm"], max_cycles=cycles, early_exit=False)
    simulate(main["trace"], prm)
    kernels, wall = device_kernels(lambda: simulate(main["trace"], prm))
    busy_us = sum(e.time_range.elapsed_us() for e in kernels)
    arb_us = [e.time_range.elapsed_us() for e in kernels if "bank_arbiter" in e.name]
    host_us_per_cycle = main["wall_s"] / main["stepped"] * 1e6
    emit(
        "profile",
        cycles=cycles,
        device_kernels_per_cycle=len(kernels) / cycles,
        device_busy_us_per_cycle=busy_us / cycles,
        host_us_per_cycle_unprofiled=host_us_per_cycle,
        device_idle_share=1 - busy_us / cycles / host_us_per_cycle if busy_us else None,
        arbiter_launches=len(arb_us),
        arbiter_device_us_mean=sum(arb_us) / len(arb_us) if arb_us else None,
        arbiter_share_of_device_time=sum(arb_us) / busy_us if busy_us else None,
        profiled_wall_s=wall,
    )


def phase_timing(launches: int, max_abs_err: int) -> dict:
    """Times at the main path's shape (B=1, S=32*256, NB=256): device time
    per call from the profiler (``ms``; CUDA events over back-to-back calls
    where the profiler records nothing) and the per-call time of
    back-to-back calls between CUDA events, which includes the host's
    launch overhead."""
    import numpy as np
    import torch

    from repro_torch.kernels.bank_arbiter.ops import bank_arbiter_winners
    from repro_torch.kernels.bank_arbiter.ref import KEY_FILLER, bank_arbiter_ref

    B, S, NB, X = 1, 8192, 256, 32
    key, bank, elig = arb_inputs(np.random.default_rng(1), B, S, NB, X)
    # yardstick: one library call on the packed (key << 32 | slot) int64
    slots = torch.arange(S, device="cuda", dtype=torch.int64)
    packed = torch.where(elig, (key.long() << 32) | slots, (KEY_FILLER << 32) | S)
    seg = torch.where(elig, bank.long(), NB)
    init = torch.full((B, NB + 1), (KEY_FILLER << 32) | S, dtype=torch.int64, device="cuda")
    lib_win = (init.scatter_reduce(1, seg, packed, "amin")[:, :NB] & 0xFFFFFFFF).int()
    check(
        torch.equal(lib_win, bank_arbiter_ref(key, bank, elig, num_banks=NB)),
        "scatter_reduce yardstick disagrees",
    )
    fns = {
        "kernel": lambda: bank_arbiter_winners(key, bank, elig, num_banks=NB),
        "plain": lambda: bank_arbiter_ref(key, bank, elig, num_banks=NB),
        "library": lambda: init.scatter_reduce(1, seg, packed, "amin"),
    }
    call_ms = {k: time_ms(fn, 2000) for k, fn in fns.items()}
    dev_ms = {k: device_ms(fn, 200) for k, fn in fns.items()}
    ms = {k: dev_ms[k] if dev_ms[k] is not None else call_ms[k] for k in fns}
    nbytes = S * (key.element_size() + bank.element_size() + elig.element_size()) + NB * 4
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = 3 * S / ALU_OPS_PER_S * 1e3  # a test, a pack and an atomic per slot
    emit(
        "timing",
        shape=dict(B=B, S=S, NB=NB),
        device_us={k: None if v is None else v * 1e3 for k, v in dev_ms.items()},
        call_us={k: v * 1e3 for k, v in call_ms.items()},
        bytes=nbytes,
        bound_us=max(bytes_ms, ops_ms) * 1e3,
    )
    return {
        "name": "bank_arbiter",
        "route": "cuda",
        "source": "src/repro_torch/kernels/bank_arbiter/csrc/bank_arbiter.cu",
        "replaces": "src/repro/kernels/bank_arbiter/kernel.py:79",
        "launches": launches,
        "max_abs_err": max_abs_err,
        "ms": ms["kernel"],
        "plain_ms": ms["plain"],
        "bound_ms": max(bytes_ms, ops_ms),
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "library_ms": ms["library"],
        "call_ms": call_ms["kernel"],
    }


def _cuda_randn(gen, shape, dtype):
    import torch

    return torch.randn(shape, generator=gen, device="cuda", dtype=torch.float32).to(dtype)


def _unique_tables(gen, B, width, NB, used):
    """``[B, width]`` int32 tables: ``used[b]`` distinct pool blocks each, -1 after."""
    import torch

    perm = torch.randperm(NB, generator=gen, device="cuda")
    tbl = torch.full((B, width), -1, dtype=torch.int32, device="cuda")
    k = 0
    for b, n in enumerate(used):
        tbl[b, :n] = perm[k : k + n].int()
        k += n
    return tbl


def _max_err(got, want) -> float:
    return float((got.double() - want.double()).abs().max()) if got.numel() else 0.0


def phase_llm_kernels() -> dict:
    """Flash attention, paged attention and banked_copy against their plain
    versions on the card, then two calls of flash and paged at the path's
    shapes compared bit for bit; returns ``{name: largest abs difference}``.
    Tolerances are those of ``tests/test_kernels.py``: float32 2e-5, bf16
    2e-2 (flash) and 3e-2 (paged), banked_copy exact."""
    import torch

    from repro_torch.kernels.banked_copy.ops import banked_copy
    from repro_torch.kernels.banked_copy.ref import banked_copy_ref
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref
    from repro_torch.kernels.paged_attention.ops import blocks_per_split, paged_attention
    from repro_torch.kernels.paged_attention.ref import paged_attention_ref

    gen = torch.Generator(device="cuda").manual_seed(0)
    f32, bf16 = torch.float32, torch.bfloat16
    worst = {name: 0.0 for name in LLM_KERNELS}
    rows = []

    def record(kernel, case, err, tol):
        worst[kernel] = max(worst[kernel], err)
        rows.append(dict(kernel=kernel, case=case, max_abs_err=err, tol=tol))
        check(err <= tol, f"{kernel} {case}: kernel differs from its plain version by {err}")

    # flash: (case, B, S, T, H, G, D, causal, window, dtype); the JAX tests'
    # [BH, S, D] x [BG, T, D] cases in the port's [B, S, H, D] layout, then
    # the serving path's prefill shapes (stablelm-1.6b: H = G = 32, D = 64)
    flash_cases = [
        ("jax_4_2_256_causal", 1, 256, 256, 4, 2, 64, True, 0),
        ("jax_2_2_512_d128", 1, 512, 512, 2, 2, 128, True, 0),
        ("jax_4_4_256x512_full", 1, 256, 512, 4, 4, 64, False, 0),
        ("jax_2_1_256_window64", 1, 256, 256, 2, 1, 64, True, 64),
        ("ragged_T600_full", 1, 256, 600, 4, 2, 64, False, 0),
        ("gqa_batch2_S300", 2, 300, 300, 32, 8, 64, True, 0),
        ("path_S128", 1, 128, 128, 32, 32, 64, True, 0),
        ("path_S517", 1, 517, 517, 32, 32, 64, True, 0),
        ("path_S1024", 1, 1024, 1024, 32, 32, 64, True, 0),
        ("S1", 1, 1, 1, 4, 4, 64, True, 0),
        ("S15", 1, 15, 15, 4, 4, 64, True, 0),
        ("S2048_gqa4", 1, 2048, 2048, 4, 1, 64, True, 0),
        ("ragged_T333_gqa8_d32", 1, 100, 333, 8, 1, 32, False, 0),
        ("window64_gqa8", 1, 300, 300, 32, 4, 64, True, 64),
        ("d16", 2, 77, 77, 8, 2, 16, True, 0),
        ("batch2_gqa4_d128", 2, 200, 200, 16, 4, 128, True, 0),
    ]
    for name, B, S, T, H, G, D, causal, window in flash_cases:
        for dtype, tol in ((f32, 2e-5), (bf16, 2e-2)):
            q = _cuda_randn(gen, (B, S, H, D), dtype)
            k = _cuda_randn(gen, (B, T, G, D), dtype)
            v = _cuda_randn(gen, (B, T, G, D), dtype)
            got = flash_attention(q, k, v, causal=causal, window=window)
            torch.cuda.synchronize()
            want = flash_attention_ref(q, k, v, causal=causal, window=window)
            record("flash_attention", f"{name}_{str(dtype)[6:]}", _max_err(got, want), tol)

    # paged: the JAX tests' shapes, then the decode path's: 8 slots over
    # strided layer views of an all-layer pool, one slot idle (length 0)
    paged_cases = [
        ("jax_2_8_2_64", 2, 8, 2, 64, 16, 16, 4, False),
        ("jax_3_4_1_128", 3, 4, 1, 128, 32, 8, 6, False),
        ("jax_2_16_4_64", 2, 16, 4, 64, 64, 32, 3, False),
        ("heads8_3_16_2_64", 3, 16, 2, 64, 64, 16, 8, False),
        ("d16_4_16_2_16", 4, 16, 2, 16, 64, 16, 8, False),
        ("path_8x32x64_pool_view", 8, 32, 32, 64, 2048, 16, 128, True),
    ]
    for name, B, H, G, D, NB, bs, mb, path in paged_cases:
        for dtype, tol in ((f32, 2e-5), (bf16, 3e-2)):
            if path and dtype == f32:
                continue
            q = _cuda_randn(gen, (B, H, D), dtype)
            if path:
                pool = _cuda_randn(gen, (NB, bs, 24, 2, G, D), dtype)
                kp, vp = pool[:, :, 5, 0], pool[:, :, 5, 1]
                lens = torch.randint(128, 1057, (B,), generator=gen, device="cuda")
                lens[3] = 0
            else:
                kp = _cuda_randn(gen, (NB, bs, G, D), dtype)
                vp = _cuda_randn(gen, (NB, bs, G, D), dtype)
                lens = torch.randint(1, mb * bs + 1, (B,), generator=gen, device="cuda")
            used = [-(-int(n) // bs) for n in lens.tolist()]
            tbl = _unique_tables(gen, B, mb, NB, used)
            lens = lens.int()
            got = paged_attention(q, kp, vp, tbl, lens)
            torch.cuda.synchronize()
            want = paged_attention_ref(q, kp, vp, tbl, lens)
            record("paged_attention", f"{name}_{str(dtype)[6:]}", _max_err(got, want), tol)
            if path:
                check(bool((got[3] == 0).all()), f"paged {name}: idle slot not 0")
            del q, kp, vp

    # paged at the edges: lengths of 1, one split, two splits, the table's
    # end, past it (clamped) and 0, with 8 query heads per group
    for bs, D in ((16, 64), (8, 16), (32, 128)):
        span = blocks_per_split(bs) * bs
        mb = 3 * span // bs + 1
        lens = [1, span, 2 * span, mb * bs, mb * bs + 9, 0]
        B, H, G, NB = len(lens), 16, 2, len(lens) * mb
        for dtype, tol in ((f32, 2e-5), (bf16, 3e-2)):
            kp, vp = (_cuda_randn(gen, (NB, bs, G, D), dtype) for _ in range(2))
            tbl = _unique_tables(gen, B, mb, NB, [min(-(-n // bs), mb) for n in lens])
            q = _cuda_randn(gen, (B, H, D), dtype)
            ln = torch.tensor(lens, dtype=torch.int32, device="cuda")
            got = paged_attention(q, kp, vp, tbl, ln)
            torch.cuda.synchronize()
            want = paged_attention_ref(q, kp, vp, tbl, ln)
            err = _max_err(got, want)
            record("paged_attention", f"edge_lengths_bs{bs}_d{D}_{str(dtype)[6:]}", err, tol)
            check(bool((got[B - 1] == 0).all()), f"paged edge lengths bs={bs}: empty request not 0")

    # banked_copy: the JAX tests' shapes and dtypes, two unaligned tiles, and
    # the admission path's burst of 64 blocks into the 2048-block pool
    copy_cases = [
        ("jax_2_4_32_16_128", 2, 4, 32, 16, 128, (f32, bf16, torch.int32)),
        ("jax_3_2_16_8_256", 3, 2, 16, 8, 256, (f32, bf16, torch.int32)),
        ("jax_1_8_64_32_64", 1, 8, 64, 32, 64, (f32, bf16, torch.int32)),
        ("unaligned_3x5", 2, 3, 16, 3, 5, (f32, bf16)),
        ("path_64_blocks", 1, 64, 2048, 16, 24 * 2 * 32 * 64, (bf16,)),
    ]
    for name, B, nblk, NB, bs, W, dtypes in copy_cases:
        for dtype in dtypes:
            if dtype == torch.int32:
                pool = torch.randint(0, 100, (NB, bs, W), generator=gen, device="cuda").int()
                new = torch.randint(0, 100, (B, nblk, bs, W), generator=gen, device="cuda").int()
            else:
                pool = _cuda_randn(gen, (NB, bs, W), dtype)
                new = _cuda_randn(gen, (B, nblk, bs, W), dtype)
            used = [nblk - (b % 2) for b in range(B)]  # odd rows end with a -1 entry
            tbl = _unique_tables(gen, B, nblk, NB, used)
            got = banked_copy(pool.clone(), new, tbl)
            torch.cuda.synchronize()
            want = banked_copy_ref(pool, new, tbl)
            record("banked_copy", f"{name}_{str(dtype)[6:]}", float(not torch.equal(got, want)), 0)
            del pool, new, got, want

    # the redesigned kernels repeat to the bit at the path's shapes
    repeat = {}
    q, k, v = (_cuda_randn(gen, (1, 1024, 32, 64), bf16) for _ in range(3))
    repeat["flash_attention"] = torch.equal(flash_attention(q, k, v), flash_attention(q, k, v))
    pool = _cuda_randn(gen, (2048, 16, 2, 2, 32, 64), bf16)
    kp, vp = pool[:, :, 1, 0], pool[:, :, 1, 1]
    lens = [585, 1061, 0, 700, 1024, 128, 845, 990]
    tbl = _unique_tables(gen, 8, 128, 2048, [-(-n // 16) for n in lens])
    ln = torch.tensor(lens, dtype=torch.int32, device="cuda")
    q = _cuda_randn(gen, (8, 32, 64), bf16)
    repeat["paged_attention"] = torch.equal(
        paged_attention(q, kp, vp, tbl, ln), paged_attention(q, kp, vp, tbl, ln)
    )
    del pool, kp, vp
    check(all(repeat.values()), f"a kernel's second call differs from its first: {repeat}")
    emit("llm_kernels", cases=rows, max_abs_err=worst, repeats_bit_for_bit=repeat)
    return worst


def _serving_engine_cls():
    from repro_torch.serving.engine import ServingEngine

    class RecordingEngine(ServingEngine):
        """Keeps the logits behind every token of the requests in ``record``;
        with ``forced`` it takes those tokens in place of its own picks
        (teacher forcing)."""

        record: frozenset = frozenset()
        forced = None

        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            self.logits = {}

        def _pick(self, reqs, logits):
            picked = super()._pick(reqs, logits)
            for n, r in enumerate(reqs):
                if r.rid in self.record:
                    self.logits[(r.rid, len(r.out_tokens))] = logits[n].clone()
                if self.forced is not None:
                    picked[n] = self.forced[r.rid][len(r.out_tokens)]
            return picked

    return RecordingEngine


def _tempered(model):
    """``model`` with every layer's ``wq`` and ``wk`` scaled by 1/8 (exact in
    bf16): attention scores of std ~1, as in a trained model.  Under the
    reference's fan-in init they have std ~64 and the network is chaotic at
    any precision, so two paths that differ in the last bit of one sum give
    unrelated logits (PERF.md, Findings)."""
    import torch

    with torch.no_grad():
        for blk in model.layers:
            blk.attn.wq.mul_(0.125)
            blk.attn.wk.mul_(0.125)
    return model


def _logits_gap(a: dict, b: dict) -> dict:
    """Per-token max |a - b| over the logits rows of the same tokens (max,
    mean and median over tokens, the first token's, which comes from the
    prefill) and the share of tokens whose argmax agrees."""
    import torch

    keys = sorted(a)
    gaps = torch.stack([(a[k].float() - b[k].float()).abs().max() for k in keys]).cpu()
    agree = sum(int(torch.argmax(a[k]) == torch.argmax(b[k])) for k in keys)
    first = [g for k, g in zip(keys, gaps.tolist()) if k[1] == 0]
    return {
        "max": float(gaps.max()),
        "mean": float(gaps.mean()),
        "median": float(gaps.median()),
        "first_token_max": max(first),
        "argmax_agreement": agree / len(keys),
    }


def phase_serving() -> dict:
    """The serving main path at full width; returns what the later phases
    need (model, prompts, launch counts, host time per decode step)."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.launch import serve
    from repro_torch.models import model as M

    cfg, spec = get_config("stablelm-1.6b"), serve.FULL
    t0 = time.perf_counter()
    model = _tempered(M.init_params(cfg, 0))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    prompts = serve.make_prompts(cfg, spec, seed=0)
    engine_cls = _serving_engine_cls()

    # prediction: the traffic-only engine runs the same control flow
    plan, _ = serve.new_engine(None, None, spec, prompts)
    plan.run()
    L = cfg.num_layers
    want = {
        "flash_attention": L * plan.stats.admissions,
        "banked_copy": plan.stats.admissions,
        "paged_attention": L * plan.stats.decode_steps,
        "paged_attention_merge": L * plan.stats.decode_steps,
        "bank_arbiter": 0,
    }

    eng, reqs = serve.new_engine(cfg, model, spec, prompts, engine_cls=engine_cls)
    first_wave = reqs[: spec.max_batch]
    eng.record = frozenset(r.rid for r in first_wave)
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    while eng.queue or any(r is not None for r in eng.slot_req):
        eng.step()
        check(eng.pool.check_isolation(), f"pool isolation broken at step {eng.steps}")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: LAUNCHES[k] for k in want}
    summary = serve.summarize(eng, reqs, wall)
    check(launches == want, f"serving launches {launches}, predicted {want}")
    check(eng.steps == plan.steps, f"{eng.steps} engine steps, traffic-only run took {plan.steps}")
    check(
        all(r.done and len(r.out_tokens) == spec.max_new_tokens for r in reqs),
        "a request did not finish with its token count",
    )
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    kernel_logits = eng.logits
    forced = {r.rid: list(r.out_tokens) for r in first_wave}
    del eng

    # teacher forcing: the first wave again, fed the kernel run's tokens, on
    # the same batches, blocks and GEMM shapes, through the plain attention
    # path in bf16, and through kernels and plain path in float32
    def forced_run(m, impl):
        m.impl = impl
        reset_launches()
        tf, _ = serve.new_engine(cfg, m, spec, prompts[: spec.max_batch], engine_cls=engine_cls)
        tf.record, tf.forced = frozenset(forced), forced
        tf.run()
        m.impl = "kernel"
        ran = sum(LAUNCHES.values())
        check((ran > 0) == (impl == "kernel"), f"{impl} path launched {ran} kernels")
        check(set(tf.logits) == set(kernel_logits), "teacher-forced run saw other tokens")
        return tf.logits

    plain_logits = forced_run(model, "ref")
    model32 = _tempered(
        M.init_params(cfg, 0, compute_dtype=torch.float32, kv_dtype=torch.float32)
    )
    kernel32, plain32 = forced_run(model32, "kernel"), forced_run(model32, "ref")
    del model32
    forcing = {
        "bf16_kernel_vs_plain": _logits_gap(kernel_logits, plain_logits),
        "f32_kernel_vs_plain": _logits_gap(kernel32, plain32),
        "bf16_kernel_vs_f32_plain": _logits_gap(kernel_logits, plain32),
    }
    emit("teacher_forcing", tokens=len(kernel_logits), **forcing)
    # tolerances and their reasons are stated in PERF.md (Findings) before their first run
    for name, max_gap, agreement in (("bf16", 0.5, 0.9), ("f32", 1e-2, 0.99)):
        gap = forcing[f"{name}_kernel_vs_plain"]
        check(
            gap["max"] <= max_gap and gap["argmax_agreement"] >= agreement,
            f"{name} teacher forcing: kernel and plain paths differ: {gap}",
        )
    emit(
        "serving",
        arch=cfg.name,
        params=cfg.num_params(),
        init_s=init_s,
        **{k: summary[k] for k in ("requests", "done", "out_tokens", "steps", "wall_s")},
        prompt_tokens=summary["stats"]["prefill_tokens"],
        prefill_tokens_per_s=summary["prefill_tokens_per_s"],
        decode_ms_per_step=summary["decode_ms_per_step"],
        out_tokens_per_s=summary["out_tokens_per_s"],
        pool_imbalance=summary["pool_imbalance"],
        peak_memory_gb=peak_gb,
        launches=launches,
        predicted=want,
        stats=summary["stats"],
        teacher_forcing=forcing,
    )
    return dict(
        model=model,
        spec=spec,
        prompts=prompts,
        launches=launches,
        decode_ms_per_step=summary["decode_ms_per_step"],
    )


def phase_serving_profile(serving: dict) -> None:
    """Where a decode step's time goes: 8 decode-only steps of the first wave
    under ``torch.profiler`` against the unprofiled host time per step."""
    from repro_torch.launch import serve

    spec, steps = serving["spec"], 8
    eng, _ = serve.new_engine(
        serving["model"].cfg, serving["model"], spec, serving["prompts"][: spec.max_batch]
    )
    eng.step()  # admissions and the first decode step
    eng.step()
    kernels, wall = device_kernels(lambda: [eng.step() for _ in range(steps)])
    busy_us = sum(e.time_range.elapsed_us() for e in kernels)
    by_name: dict = {}
    for e in kernels:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    paged_us = sum(v for k, v in by_name.items() if "paged_split" in k or "paged_merge" in k)
    host_us = serving["decode_ms_per_step"] * 1e3
    emit(
        "serving_profile",
        decode_steps=steps,
        device_kernels_per_step=len(kernels) / steps,
        device_busy_us_per_step=busy_us / steps,
        host_us_per_step_unprofiled=host_us,
        device_idle_share=1 - busy_us / steps / host_us if busy_us else None,
        paged_attention_us_per_step=paged_us / steps,
        paged_attention_share_of_device_time=paged_us / busy_us if busy_us else None,
        top_kernels_us_per_step={k[:80]: v / steps for k, v in top},
        profiled_wall_s=wall,
    )


def _timing_row(name, fns, iters, nbytes, ops, launches, err, library, shape=None):
    """Device and call times of kernel / plain / library and the bound."""
    call_ms = {k: time_ms(fn, iters) for k, fn in fns.items()}
    dev_ms = {k: device_ms(fn, max(5, iters // 5)) for k, fn in fns.items()}
    ms = {k: dev_ms[k] if dev_ms[k] is not None else call_ms[k] for k in fns}
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / BF16_OPS_PER_S * 1e3
    emit(
        "timing",
        kernel=name,
        shape=shape,
        device_us={k: None if v is None else v * 1e3 for k, v in dev_ms.items()},
        call_us={k: v * 1e3 for k, v in call_ms.items()},
        bytes=nbytes,
        ops=ops,
        bound_us=max(bytes_ms, ops_ms) * 1e3,
        library=library,
    )
    return {
        "name": name,
        "route": "cuda",
        "source": f"src/repro_torch/kernels/{name}/csrc/{name}.cu",
        "replaces": {
            "banked_copy": "src/repro/kernels/banked_copy/kernel.py:29",
            "paged_attention": "src/repro/kernels/paged_attention/kernel.py:65",
            "flash_attention": "src/repro/kernels/flash_attention/kernel.py:72",
        }[name],
        "launches": launches,
        "max_abs_err": err,
        "ms": ms["kernel"],
        "plain_ms": ms["plain"],
        "bound_ms": max(bytes_ms, ops_ms),
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "library_ms": ms["library"],
        "call_ms": call_ms["kernel"],
        "library": library,
    }


def phase_llm_timing(serving: dict, errs: dict) -> list:
    """Timing rows of the serving kernels at the path's shapes (bf16,
    stablelm-1.6b): flash at the longest prompt (S = 1024; S = 128 and 517 on
    timing lines of their own), paged attention
    over 8 slots at the first wave's mid-decode lengths, banked_copy of a
    64-block burst into the 2048-block pool."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.banked_copy.ops import banked_copy
    from repro_torch.kernels.banked_copy.ref import banked_copy_ref
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref
    from repro_torch.kernels.paged_attention.ops import paged_attention
    from repro_torch.kernels.paged_attention.ref import paged_attention_ref

    cfg, spec, launches = serving["model"].cfg, serving["spec"], serving["launches"]
    H, G, D, L = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim, cfg.num_layers
    NB, bs, mb = 2048, spec.block_size, spec.max_len // spec.block_size
    bf16, gen = torch.bfloat16, torch.Generator(device="cuda").manual_seed(1)
    rows = []

    # flash at the short prompts (timing lines only, where a 64-row tile
    # leaves the card underfilled) and at the longest (the kernels line)
    for S in (128, 517, 1024):
        q, k, v = (_cuda_randn(gen, (1, S, n, D), bf16) for n in (H, G, G))
        qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        lib = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True).transpose(1, 2)
        check(_max_err(lib, flash_attention_ref(q, k, v)) <= 2e-2, "SDPA yardstick disagrees")
        row = _timing_row(
            "flash_attention",
            {
                "kernel": lambda: flash_attention(q, k, v),
                "plain": lambda: flash_attention_ref(q, k, v),
                "library": lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True),
            },
            100,
            4 * S * H * D * 2,
            4 * D * H * S * (S + 1) // 2,
            launches["flash_attention"],
            errs["flash_attention"],
            "F.scaled_dot_product_attention(is_causal=True)",
            shape=dict(B=1, S=S, H=H, G=G, D=D, causal=True),
        )
        if S == 1024:
            rows.append(row)
        del q, k, v, qt, kt, vt, lib

    B = spec.max_batch
    lens = [len(p) + spec.max_new_tokens // 2 for p in serving["prompts"][:B]]
    pool = _cuda_randn(gen, (NB, bs, L, 2, G, D), bf16)
    kp, vp = pool[:, :, 0, 0], pool[:, :, 0, 1]
    tbl = _unique_tables(gen, B, mb, NB, [-(-n // bs) for n in lens])
    ln = torch.tensor(lens, dtype=torch.int32, device="cuda")
    q = _cuda_randn(gen, (B, H, D), bf16)
    # yardstick: SDPA over K/V gathered beforehand (the gather is not timed)
    kg = kp[tbl.long().clamp(min=0)].reshape(B, mb * bs, G, D).transpose(1, 2).contiguous()
    vg = vp[tbl.long().clamp(min=0)].reshape(B, mb * bs, G, D).transpose(1, 2).contiguous()
    mask = (torch.arange(mb * bs, device="cuda")[None] < ln[:, None].long())[:, None, None]
    q4 = q[:, :, None]
    lib = F.scaled_dot_product_attention(q4, kg, vg, attn_mask=mask)[:, :, 0]
    check(_max_err(lib, paged_attention_ref(q, kp, vp, tbl, ln)) <= 3e-2, "paged yardstick")
    tokens = sum(lens)
    rows.append(
        _timing_row(
            "paged_attention",
            {
                "kernel": lambda: paged_attention(q, kp, vp, tbl, ln),
                "plain": lambda: paged_attention_ref(q, kp, vp, tbl, ln),
                "library": lambda: F.scaled_dot_product_attention(q4, kg, vg, attn_mask=mask),
            },
            200,
            2 * tokens * G * D * 2 + 2 * B * H * D * 2 + B * mb * 4 + B * 4,
            4 * D * H * tokens,
            launches["paged_attention"],
            errs["paged_attention"],
            "F.scaled_dot_product_attention on K/V gathered beforehand",
            shape=dict(B=B, H=H, G=G, D=D, block_size=bs, lengths=lens),
        )
    )
    del pool, kp, vp, kg, vg, lib

    nblk, W = 64, L * 2 * G * D
    pool = _cuda_randn(gen, (NB, bs, W), bf16)
    burst = _cuda_randn(gen, (1, nblk, bs, W), bf16)
    tbl = _unique_tables(gen, 1, nblk, NB, [nblk])
    idx = tbl[0].long()
    rows.append(
        _timing_row(
            "banked_copy",
            {
                "kernel": lambda: banked_copy(pool, burst, tbl),
                "plain": lambda: banked_copy_ref(pool, burst, tbl),
                "library": lambda: pool.index_copy_(0, idx, burst[0]),
            },
            50,
            2 * nblk * bs * W * 2 + nblk * 4,
            0,
            launches["banked_copy"],
            errs["banked_copy"],
            "Tensor.index_copy_",
            shape=dict(blocks=nblk, block_size=bs, W=W, pool_blocks=NB),
        )
    )
    del pool, burst
    return rows


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        msg = "chip_smoke: torch.cuda.is_available() is false; this needs a CUDA card"
        print(msg, file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    import repro_torch  # noqa: F401  (fails outside a checkout of the repository)

    t_start = time.perf_counter()
    phase_build()
    max_abs_err = phase_kernels()
    phase_golden()
    main_path = phase_full_width()
    phase_profile(main_path)
    kernel = phase_timing(main_path["launches"], max_abs_err)
    llm_errs = phase_llm_kernels()
    serving = phase_serving()
    phase_serving_profile(serving)
    rows = phase_llm_timing(serving, llm_errs)
    print(json.dumps({"kernels": [kernel, *rows]}), flush=True)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True,
        text=True,
        check=True,
        timeout=60,
    )
    print(smi.stdout.strip().splitlines()[0], flush=True)
    emit("done", seconds=time.perf_counter() - t_start)
    device = {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }
    print(json.dumps({"ok": True, "device": device}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
