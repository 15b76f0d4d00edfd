#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA Hopper card.

    python3 chip_smoke.py

Run from the repository root on a machine with a CUDA card and ``nvcc``.
Phases, one JSON line each; any failure exits non-zero:

  1. build      compile every kernel of the main path from ``src/repro_torch``
  2. kernels    each kernel against its plain PyTorch version on the card,
                grant for grant, over a set of shapes
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
    paths = _build.build(["bank_arbiter"])
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
    print(json.dumps({"kernels": [kernel]}), flush=True)
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
