#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA Hopper card.

    python3 chip_smoke.py

Run from the repository root on a machine with a CUDA card and ``nvcc``.
Phases, one JSON line each; any failure exits non-zero:

  1. build      compile every kernel of the port from ``src/repro_torch``
                (one ``nvcc`` per source, all started together)
  2. kernels    each kernel against its plain PyTorch version on the card:
                the arbiter grant for grant over a set of shapes (B = 1..64,
                ragged lanes, views with storage offsets, 130 and 6144
                banks, each cluster size it can pick, a CUDA-graph replay
                on new inputs, two calls bit for bit), then
                flash attention, paged attention and banked_copy at the JAX
                tests' shapes, at the edges (S = 1, ragged T, GQA 8:1, head
                dims 16..128, lengths 0, 1, at a split and past the table)
                and at the serving paths' shapes (stablelm-1.6b: 32 heads
                of 64; olmoe-1b-7b: 16 heads of 128, a 65536-wide pool row;
                deepseek-7b, chameleon-34b and stablelm-3b below, the last
                at D = 80 with its edges: S = 1, ragged T, a window, 1, 2, 4
                and 8 heads per group; banked_copy at W = 163840 and
                245760, and at the edges of its plan: one block, a burst
                under one chunk, every entry -1, B = 3 with -1 tails at
                W = 6144); flash and paged twice at those shapes, bit for bit
  3. golden     the three golden single-slice cases on the card, bit for bit
                against ``tests/data/golden_single_slice.json``
  4. fig4/table1  the paper's Fig. 4 sweep (X = 1..16) and Table I
                (outstanding 16 vs 1) at the prototype's full width with the
                paper's asserts; the X=16 point is the main path: its kernel
                launches are counted and must equal the cycles stepped and
                these the count predicted from its drain, and it must equal
                ``arbiter="ref"`` key for key
  5. profile    device kernels, device busy time and idle share per steady
                cycle of the main path: fixed-horizon runs of 8 and 72
                cycles, differenced, under ``torch.profiler`` for device
                time and without it for host time
  6. timing     per-call device time of each kernel, its plain version and
                one PyTorch call computing the same function: the arbiter at
                the main path's shape (B = 1) and a sweep's (B = 64), each
                beside the empty kernel of its launch shape (its floor) and
                at every cluster size
  7. moe_whitening  the paper's MoE-whitening check: the reference
                benchmark's inputs through the port's ``route`` with the
                fractal slot permutation on and off, its two asserts, its
                numbers and every expert choice and slot against
                ``moe_reference.json``
  8. serving    the second main path: stablelm-1.6b at full width (random
                weights from a seed) through ``repro_torch.launch.serve``,
                16 requests of 128..1024 prompt tokens, 32 new tokens each,
                8 slots; pool isolation after every step; kernel launches
                equal to their prediction from a traffic-only run; the first
                wave teacher-forced through the plain attention versions, its
                logits held to the kernel run's, in bf16 and in float32 (the
                weights keep the reference's init with ``wq``/``wk`` scaled
                by 1/8: see ``_tempered``)
  9. serving_profile  device kernels, busy time and idle share per decode step
  10. llm_timing the three serving kernels' timing rows at the path's shapes
                (and flash at the short prompts, S = 128 and 517); flash
                against SDPA at S = 1024 in alternating rounds of queued calls;
                every row as queued calls, the profiler's reading beside;
                banked_copy's row also cold (bursts and pool rows rotated
                over twice L2) and the floor of an empty kernel of its
                launch shape
  11. serving_moe  the MoE serving path: olmoe-1b-7b at full width (64
                experts, top-8, QK-norm) with the same request mix and
                checks as 8 (no tempering: QK-norm keeps the scores of unit
                scale), and the share of routing decisions that agree
                between the kernel run and each teacher-forced run; then its
                profile (as 9, and one decode step's expert products against
                their weight-read bound) and its kernels' timing rows (as 10,
                flash at S = 1024)
  11m. serving_mla  the MLA serving path: deepseek-v2-lite-16b at full width
                (27 layers, d 2048, 16 heads, kv_lora_rank 512, qk 128 + 64,
                v 128, 64 experts top-6 of 1408 plus 2 shared, 16.2 B
                parameters) with the same request mix and checks as 8: one
                576-wide latent row per token and layer in the pool (W =
                15552), prefill through flash at QK width 192 / V width 128,
                decode through the latent paged call in the absorbed form;
                ``wq``/``w_uk`` tempered (the scores' std per layer printed
                before and after); teacher forced in bf16 against the plain
                absorbed path, and the plain absorbed against the plain
                non-absorbed form, with routing agreement; then its profile
                (as 11) and timing rows (as 10, flash at S = 128, 517, 1024),
                and the ``latent_timing`` line: the bf16 latent call (one
                launch) as queued calls, its split and merge per CTA from the
                build with phase marks, live CTAs and stages, and the float32
                route's split and merge apart.
                Its kernels are also held to their plain versions in 2 (flash
                (192, 128) at S = 128, 517, 1024, bf16 and float32; the
                latent call at the first wave's mid-decode lengths with an
                idle slot; banked_copy at the 497,664-byte tile)
  11d. serving_dense7b, serving_vlm, serving_3b  the dense configs at full
                width with the checks of 8 and their profiles and timing
                rows (flash at S = 1024): deepseek-7b (30 layers, 32 heads
                of 128, 6.91 B parameters), tempered, teacher forced in bf16
                and float32; chameleon-34b (family vlm run as the reference
                runs it, a dense GQA 64:8 stack with QK-norm, 48 layers,
                34.29 B parameters: 68.6 GB of bf16 weights beside its 6.44
                GB pool), untempered, teacher forced in bf16 only (137 GB in
                float32); stablelm-3b (32 heads of 80: every serving kernel
                at D = 80), tempered, bf16 and float32.  Each prints its
                seconds
  11s. serving_swa, serving_ssm  h2o-danube-1.8b at full width and 12 of
                its 24 layers (a cut of the script's time; GQA 32:8 at 80, a
                4096-token sliding window), tempered, with the checks of 8 on the FULL mix
                (the window never masks there) and on the WINDOW mix (4
                prompts of 8192 tokens and 4 of 4065..4096, decode past
                position 4096: the paged kernel masks the keys before the
                window), its WINDOW decode profiled and timing rows 3w
                (paged with the window) and 4w (prefill flash at S 8192);
                then mamba2-1.3b at full width and depth (48 SSM layers, tied
                embeddings, 1.34 B parameters) on the FULL_SSD mix:
                isolation every step, the KV record, no attention or
                banked_copy launch, each slot's SSM state beside the pool,
                its decode profiled, and its two forms in float32 at 12
                of its 48 layers (a cut of the script's time; 8
                prompts of 512 tokens through the chunked prefill and
                through 512 recurrent steps: final state, conv window and
                last logits within ``SSM_FORMS_BOUND``).  Each prints its
                seconds.  The paged window is also held to its plain
                version in 2 (1, 4 and 8 heads a group, D = 64, 80, 128,
                windows of 1, 16, 1000 and 4096 against lengths whose
                window starts inside a split, on a split boundary, after 16
                and 19 dead splits, in split 0; a window at and past the
                lengths changes no bit; h2o-danube's decode shape), as is
                the flash forward at S 8192 with the window
  11h. serving_hybrid  jamba-1.5-large-398b cut to one super-block (8 of 72
                layers) and 8 of 16 experts, top-2 kept, every width the
                published one (25.82 B parameters, 51.6 GB of bf16 weights),
                on the FULL_SSD mix: one attention layer (64 query heads over
                8 KV groups at 128) and 7 SSD layers a super-block, MoE at
                odd positions; the checks of 8 (launches: flash and
                banked_copy once an admission, paged split and merge once a
                decode step; isolation, the KV record, teacher forcing in
                bf16), each slot's SSM state beside the pool, its decode
                profile and timing rows (flash at S 1024, row 4c's shape;
                paged, row 3c's; banked_copy at W = 2048, row 2j); its
                banked_copy tile is also held to its plain version in 2
                (bit for bit, twice alike).  Prints its seconds
  11w. serving_whisper  whisper-base at full width and depth (6 encoder
                layers over 1500 frames, 6 decoder layers with
                cross-attention, 8 heads of 64, 98.6 M parameters) on the
                SPEECH mix (16 requests of 4..224 prompt tokens, 192 new
                tokens, 8 slots, 448-token contexts): each admission encodes
                zero frames; launches 18 flash (6 encoder, 6 cross, 6 self)
                and one banked_copy an admission, 12 paged splits and
                merges a decode step (6 over the pool, 6 over the slots'
                cross K/V beside it); the checks of 8 in bf16 and float32,
                every attention's ``wq``/``wk`` tempered with the scores'
                std per flash call printed before and after; its decode
                profile; rows 3e (paged self), 2e (banked_copy at W = 6144),
                4e (the encoder's flash, S = T = 1500, non-causal), 4x
                (cross-attention at prefill over 1500) and 3x (paged over
                the cross buffer), each against SDPA, and the flash forward
                at S = 1 over 1500 beside 3x.  Its kernels are also held to
                their plain versions in 2 (flash at S = T = 1500, S 100 and
                224 over 1500, S = 1 over 1500; paged over the 94-block
                cross buffer; banked_copy at W = 6144).  Prints its seconds
  12. sweep     the scale path's main path, through the public entry points
                 with B lanes per arbiter launch: the golden ``"batch"`` entry
                 through ``simulate_batch`` and the three golden cases through
                 ``SCHEDULE_PIPELINE``, bit for bit; the full-width sweep
                 (every preset at 256 transactions per master x outstanding
                 1 and 8, 10 lanes) against ``sweep_reference.json`` and
                 against ``arbiter="ref"``; the scale grid (one shared
                 ``urban_perception`` schedule, 48 points, streaming
                 percentiles, chunks of 32), lanes 0 and 47 against their own
                 ``simulate`` and the reference's capture, every lane against
                 ``arbiter="ref"``; the time skip (8 gapped lanes) against the
                 reference's capture, no skip and ``arbiter="ref"``.  Launches
                 must equal the cycle bodies stepped in every run, and these
                 the count predicted from the drains where no lane skips; a
                 steady window of each run's shape (as in 5) gives the
                 arbiter's device time per launch at its B, device busy time
                 and idle share
  13. cosim     the serving co-sim grid (batch {2, 4} x slices {1, 2}, 24
                 recorded requests each): decode alone, QoS on and QoS off as
                 three lanes of one dense batch, every group's summaries and
                 per-gather stats bit for bit against ``cosim_reference.json``,
                 the reference benchmark's isolation and scaling asserts
  14. cosim_scale  the co-sim's scale mode: 256 recorded requests (the
                 benchmark's 1024 cut for the script's time) on the
                 schedule pipeline with streaming percentiles and the time
                 skip, against the capture; at 64 requests the fixed horizon
                 against the time skip (equal but for ``skipped_cycles``)
  15. fuzz      the scenario fuzzer: the 48-spec clean-tree job case by case
                 (spec, verdict, summaries) against the capture, the committed
                 corpus replayed to its verdicts, a planted violation found and
                 shrunk to the reference's reproducer.  In 13-15 the arbiter's
                 launches equal the cycle bodies stepped in every run; each
                 phase reports host seconds, cycles and lane-cycles per second,
                 graph-capture and set-up seconds, and (fuzz) specs per second
  16. training  (run after 11, before 12) the training path: the flash
                 backward kernel against its plain version (stablelm-1.6b's
                 heads at S = 4096, B = 4 and at a ragged S = 517, olmoe-1b-7b's,
                 GQA at head dims 64 and 128, windows, causal with T != S,
                 float32), the forward's log-sum-exp, two calls bit for bit;
                 one full-width stablelm-1.6b step (B = 4 x S = 4096, AdamW,
                 remat "full", bf16 compute, float32 parameters) with the
                 kernels against the plain attention path from one state and
                 batch, then three steps through ``train.step.make_train_step``
                 (the main path: launches counted), step time, tokens/s, peak
                 memory, model-FLOPs share and a profiled step; the launcher
                 ``repro_torch.launch.train`` at full width (its loss must
                 fall; stablelm-1.6b, and deepseek-v2-lite-16b with
                 ``--layers 4``); crash and resume at full width with 2 of 24 layers;
                 olmoe-1b-7b with 4 of 16 layers, three steps kernel against
                 plain; deepseek-v2-lite-16b (MLA: the forward's lse and the
                 backward at q/k 192, v 128) with 4 of 27 layers at B 2 x S
                 4096, three steps kernel against plain, launches 24 / 12,
                 step time, tokens/s, peak memory and model-FLOPs share;
                 stablelm-3b at full width and 16 of 32 layers (``train_3b``:
                 B 4 x S 4096, AdamW, remat full, three steps kernel against
                 plain, launches 96 / 48); h2o-danube-1.8b at full width and
                 12 of 24 layers (``train_swa``: S 8192, past its 4096-token window; three
                 steps kernel against plain at B 1, three timed kernel steps
                 at B 2, tokens/s, model-FLOPs share over the window's pairs,
                 peak memory; the forward's lse and the backward with the
                 window among the kernel checks; rows 4tw and 5w); mamba2-1.3b
                 at full width and depth (``train_ssm``: B 4 x S 4096, AdamW,
                 three steps, no launch, the loss finite and falling, step
                 time, tokens/s, model-FLOPs share, peak memory); jamba's
                 super-block at a stated reduced width (``train_hybrid``: d
                 2048, 16 heads over 2 groups at 128, 16 experts top-2, 3.0 B
                 parameters, B 2 x S 4096, Adafactor, three steps kernel
                 against plain, launches 6 / 3; its heads among the kernel
                 checks, rows 4tj and 5j); whisper-base at full width and
                 depth (``train_whisper``: B 8 x 4096 decoder tokens beside
                 8 x 1500 seeded frames, AdamW, remat full, three steps
                 kernel against plain, launches 108 / 54, model-FLOPs share
                 from the cost model's encoder-decoder terms; its non-causal
                 shapes among the kernel checks: S = T = 1500, S 4096 and
                 100 over 1500; rows 4te / 5e at the encoder's shape and
                 4tx / 5x at the cross-attention's); deepseek-7b at full
                 width and 4 of 30 layers (``train_dense7b``: B 2 x S 4096,
                 32 heads of 128, ``wq``/``wk`` tempered, three steps kernel
                 against plain, launches 24 / 12; rows 4tk / 5k) and
                 chameleon-34b at full width and 2 of 48 layers
                 (``train_vlm``: B 1 x S 4096, 64 heads over 8 groups at 128
                 with QK-norm, untempered, launches 12 / 6; rows 4tc / 5c),
                 both shapes among the kernel checks; and
                 the timing rows of the backward (with its rate on its own
                 products and its share of the 5-product bound) and of the
                 forward with its log-sum-exp, MLA's against SDPA's backend
                 that takes V narrower than Q and K (rows 4tm, 5m), and at
                 stablelm-3b's (rows 4td, 5d).  The MLA widths are also among
                 the kernel checks (B 2 x S 4096 bf16, S 517, S 300 / T 500
                 float32, a repeat at the main shape), and D = 80 (B 2 x S
                 4096 bf16, S 517, S 300 / T 500, a window, bf16 and float32,
                 repeats)
  11c. serving_cache  the reference's contiguous-cache serving steps
                (``prefill_cache``, ``decode_step_cache``) on the paged
                kernel, each sequence's slots read as consecutive blocks:
                stablelm-1.6b at full width and depth, a B 2 x 4096
                prefill on the flash kernel and 32 decode steps (launches
                24 flash, 768 paged splits and merges), teacher-forced
                against the plain path within ``FORCING_BOUNDS``, the
                layer's paged call against its plain version within one
                bf16 step of each entry and 3e-2 (its log-sum-exp within
                4e-3); one decode_32k step at
                B 8 x 32768 (batch 128 cut to 8: 51.5 GB of bf16 K/V from
                a seeded generator), its ms, device busy ms, tokens/s and
                share of the 15.4 ms K/V bound; h2o-danube-1.8b's
                long_500k cell at 12 of 24 layers (B 1, its 4096-slot
                ring at positions
                520,160 .. 520,223 across the wrap, each of its 768 paged
                calls against its plain version on the same inputs within
                one bf16 step of each entry and 3e-2, the first step's logits
                against the plain path's within 0.0625, the others
                reported); deepseek-v2-lite-16b (4 of 27 layers) with the
                absorbed decode on the latent call over 576-wide rows; rows
                3cs, 3c32, 3cw, 3cm against SDPA on the same contiguous
                K/V.  Prints its seconds
  16m. multi_device  (after 16, before 12) the multi-device layer on a
                 one-rank NCCL group and a 1 x 1 ``DeviceMesh``:
                 ``simulate_batch(shard=True)`` on the golden batch against
                 ``shard=False``, olmoe-1b-7b's MoE layer at full width on the
                 expert-parallel path against the unsharded path (both bit
                 for bit: every collective of a world of one is the
                 identity), the collectives that layer issues, and
                 ``launch.specs.build_cell`` for stablelm-1.6b at train_4k,
                 whose per-rank state bytes must equal the unsharded state's,
                 and the sharded decode step over the contiguous cache
                 (``distributed.serve``; stablelm-1.6b, 2 of 24 layers)
                 against the unsharded step on the same cache.
                 Prints its seconds
The serving phases (8, 11) also record each full-width run's KV access stream and
hold it to a traffic-only engine's on the same prompts: the stream the
co-sim replays.  Then the kernels line, the card's name and power limit, and as the last line
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import json
import math
import statistics
import subprocess
import sys
import time
from dataclasses import replace
from pathlib import Path

ROOT = Path(__file__).resolve().parent

#: H100 SXM device memory rate and dense bf16 tensor-core rate, bytes and
#: FLOP per second: the port's cost model's (``repro_torch.analysis.costs``
#: ``HBM_BW`` and ``PEAK_FLOPS``, NVIDIA's data sheet), set by ``main``
#: once the port is importable
HBM_BYTES_PER_S = BF16_OPS_PER_S = None
#: H100 SXM non-tensor-core float32 rate, used as the int32 ALU peak
ALU_OPS_PER_S = 67e12
#: clock cycles of the spin kernel ``queued_ms`` puts ahead of its calls:
#: 50 ms or more at the H100's top clock (1.98 GHz)
SPIN_CYCLES = 100_000_000
#: host seconds of issue that ``queued_ms`` accepts: half the spin's least length
SPIN_MIN_S = 0.025
#: alternating rounds of flash and SDPA queued calls in ``llm_timing``
FLASH_ROUNDS = 5
#: the kernels of the serving path, in the order of the kernels line
LLM_KERNELS = ("banked_copy", "paged_attention", "flash_attention")
#: the kernel only the training path runs
TRAIN_KERNELS = ("flash_attention_bwd",)
#: the flag that compiles the bf16 latent kernel's phase marks in (its timing line)
LATENT_MARK_FLAGS = ("-DLATENT_MARKS",)
#: library paths of the builds with marks, filled by ``phase_build``
MARKED: dict = {}


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


#: profiler sessions tried before a measurement is given up: on the card's
#: machine a session now and then records no device activity at all
PROFILER_ATTEMPTS = 3


def device_kernels(fn):
    """Run ``fn()`` under ``torch.profiler``; returns ``(device kernel
    events, host seconds)`` of the first of ``PROFILER_ATTEMPTS`` sessions
    that records device time (``fn()`` runs once per session).  The list is
    empty where none does."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(PROFILER_ATTEMPTS):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
        if sum(e.time_range.elapsed_us() for e in kernels) > 0:
            break
    return kernels, wall


def device_ms(fn, iters: int):
    """Mean device time of ``fn()`` in ms from the profiler's kernel events,
    or None where the profiler records no device time."""
    fn()
    kernels, _ = device_kernels(lambda: [fn() for _ in range(iters)])
    busy_us = sum(e.time_range.elapsed_us() for e in kernels)
    return busy_us / iters / 1e3 if busy_us > 0 else None


def queued_ms(fn, iters: int) -> float | None:
    """Device time per call of ``iters`` back-to-back calls of ``fn()``
    between two CUDA events, enqueued behind a spin kernel so that the
    device starts them only once the host has issued them all: the host's
    launch cost stays off the clock.  None where the host took longer to
    issue them than the spin surely lasts."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SPIN_CYCLES)
    t0 = time.perf_counter()
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    issued = time.perf_counter() - t0
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters if issued < SPIN_MIN_S else None


def arb_inputs(rng, B, S, NB, X, *, elig_p=0.4, bank_dtype=None, key_hi=None):
    """Random arbitration inputs on the card: keys packed as the simulator
    packs them for ``X`` masters (or drawn from ``[0, key_hi)`` to force
    ties), banks in ``[0, NB)``, each slot eligible with probability
    ``elig_p``.  The card tests draw theirs here too."""
    import numpy as np
    import torch

    from repro_torch.core.qos import arbitration_priority_key
    from repro_torch.core.simulator import SimParams, _age_cap

    if key_hi is None:
        age_cap = _age_cap(SimParams(), X)
        level = rng.integers(0, 8, (B, S))
        age = rng.integers(0, min(age_cap + 1, 4096), (B, S))
        rr = rng.integers(0, X, (B, S))
        key = arbitration_priority_key(level, age, rr, age_cap=age_cap, num_masters=X)
    else:
        key = rng.integers(0, key_hi, (B, S))
    return (
        torch.tensor(np.asarray(key), dtype=torch.int32, device="cuda"),
        torch.tensor(rng.integers(0, NB, (B, S)), dtype=bank_dtype or torch.int16, device="cuda"),
        torch.tensor(rng.random((B, S)) < elig_p, device="cuda"),
    )


def _offset_view(t, offset: int):
    """``t``'s values in a view whose data start ``offset`` elements into a
    larger buffer (a storage offset; not 16-byte aligned for odd offsets)."""
    import torch

    flat = torch.zeros(t.numel() + 16, dtype=t.dtype, device=t.device)
    view = flat[offset : offset + t.numel()].view(t.shape)
    view.copy_(t)
    return view


def phase_build() -> None:
    """Every kernel, and the paged kernels again with the latent kernel's
    phase marks, all nvcc processes at once."""
    import threading

    from repro_torch.kernels import _build

    t0 = time.perf_counter()
    failed = []

    def build_marked():
        try:
            MARKED.update(_build.build(["paged_attention"], extra_flags=LATENT_MARK_FLAGS))
        except RuntimeError as err:
            failed.append(err)

    marked = threading.Thread(target=build_marked)
    marked.start()
    paths = _build.build(["bank_arbiter", *LLM_KERNELS, *TRAIN_KERNELS])
    marked.join()
    if failed:
        raise failed[0]
    emit(
        "build",
        seconds=time.perf_counter() - t0,
        libraries={k: str(v) for k, v in paths.items()},
        marked={k: str(v) for k, v in MARKED.items()},
    )


def phase_kernels() -> int:
    """The kernel against its plain version on the card; returns the largest
    absolute difference seen (0 when every grant agrees)."""
    import numpy as np
    import torch

    from repro_torch.kernels.bank_arbiter.ops import bank_arbiter_winners
    from repro_torch.kernels.bank_arbiter.ref import bank_arbiter_ref

    rng = np.random.default_rng(0)
    cases = [
        # (name, B, S, NB, X, options); "cluster" forces the CTAs per lane,
        # "offsets" puts key/bank/elig in views with those storage offsets
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
        ("batch64", 64, 8192, 256, 32, {}),
        ("nb130_8192", 2, 8192, 130, 32, {}),
        ("offset_views_1_3_5", 3, 8193, 256, 32, {"offsets": (1, 3, 5)}),
        ("offset_views_4_2_13", 3, 8193, 130, 32, {"offsets": (4, 2, 13), "cluster": 8}),
        ("S64_cluster8", 1, 64, 16, 4, {"cluster": 8}),
        *(("paper_cluster%d" % c, 1, 8192, 256, 32, {"cluster": c}) for c in (1, 2, 4, 8)),
        *(("ragged_nb130_cluster%d" % c, 3, 8193, 130, 32, {"cluster": c}) for c in (1, 2, 4, 8)),
        # the most banks the wrapper takes: over 48 KB of dynamic shared memory
        *(("nb6144_cluster%d" % c, 1, 8192, 6144, 32, {"cluster": c}) for c in (1, 2, 4, 8)),
        ("nb6144_ragged_int32", 3, 8193, 6144, 32, {"bank_dtype": torch.int32}),
        # the sweep phase's launch shapes: the scale grid and the time skip
        ("scale_grid_32x4608", 32, 4608, 256, 9, {}),
        ("time_skip_8x4096", 8, 4096, 256, 16, {}),
    ]
    worst, rows = 0, []
    for name, B, S, NB, X, opts in cases:
        opts = dict(opts)
        cluster, offsets = opts.pop("cluster", None), opts.pop("offsets", None)
        key, bank, elig = arb_inputs(rng, B, S, NB, X, **opts)
        if offsets:
            key, bank, elig = (_offset_view(t, o) for t, o in zip((key, bank, elig), offsets))
        got = bank_arbiter_winners(key, bank, elig, num_banks=NB, _cluster=cluster)
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

    # one call captured in a CUDA graph, replayed on new inputs copied into
    # its static tensors; then two calls on the same inputs, bit for bit
    B, S, NB = 1, 8192, 256
    static = arb_inputs(rng, B, S, NB, 32)
    bank_arbiter_winners(*static, num_banks=NB)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = bank_arbiter_winners(*static, num_banks=NB)
    for n in range(3):
        fresh = arb_inputs(rng, B, S, NB, 32)
        for dst, src in zip(static, fresh):
            dst.copy_(src)
        graph.replay()
        torch.cuda.synchronize()
        err = int((out.long() - bank_arbiter_ref(*fresh, num_banks=NB).long()).abs().max())
        worst = max(worst, err)
        rows.append(dict(case=f"cuda_graph_replay_{n}", B=B, S=S, NB=NB, max_abs_err=err))
        check(err == 0, f"CUDA-graph replay {n} disagrees with the plain version")
    repeat = {}
    for B in (1, 64):
        key, bank, elig = arb_inputs(rng, B, S, NB, 32, key_hi=8, elig_p=0.9)
        first = bank_arbiter_winners(key, bank, elig, num_banks=NB)
        repeat[f"B{B}"] = torch.equal(first, bank_arbiter_winners(key, bank, elig, num_banks=NB))
    check(all(repeat.values()), f"the arbiter's second call differs from its first: {repeat}")
    emit("kernels", cases=rows, max_abs_err=worst, repeats_bit_for_bit=repeat)
    return worst


def counted(fn):
    """Run ``fn()`` with the launch and driver counts set to 0 just before it;
    returns ``(result, host seconds, arbiter launches, cycle bodies
    stepped)``."""
    import torch

    from repro_torch.core.simulator import DRIVER_COUNTS, reset_driver_counts
    from repro_torch.kernels import LAUNCHES, reset_launches

    torch.cuda.synchronize()
    reset_launches()
    reset_driver_counts()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return out, wall, LAUNCHES["bank_arbiter"], DRIVER_COUNTS["cycles"]


def phase_golden() -> None:
    import numpy as np

    from repro_torch.core.simulator import simulate
    from repro_torch.data import GOLDEN_KEYS, golden_cases

    golden = json.loads((ROOT / "tests" / "data" / "golden_single_slice.json").read_text())
    rows = []
    for name, trace, prm in golden_cases():
        out, wall, _, stepped = counted(lambda: simulate(trace, prm))
        bad = [k for k in GOLDEN_KEYS if np.asarray(out[k]).tolist() != golden["cases"][name][k]]
        check(not bad, f"golden {name}: keys differ {bad}")
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

    from repro_torch.core.simulator import SimParams, Trace, simulate
    from repro_torch.core.traffic import random_uniform

    num_txns, counts = 300, (1, 2, 4, 8, 16)
    rows, runs = {}, {}
    for X in counts:
        trace = random_uniform(X, num_txns, burst=16, full_duplex=True)
        prm = SimParams(max_cycles=int(num_txns * 16 * 1.3) + 2000)
        m, wall, launches, stepped = counted(lambda: simulate(trace, prm))
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
    want = predicted_cycles(main["out"]["drained_cycle"], main["prm"])
    check(main["stepped"] == want, f"fig4 X=16: {main['stepped']} cycles stepped, {want} predicted")
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
        m, wall, _, stepped = counted(lambda: simulate(tr, prm))
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


#: cycles of each profiled window beyond its lead-in run
PROFILE_CYCLES = 64
#: cycles of the lead-in run whose set-up the window subtracts
WINDOW_LEAD = 8
#: unprofiled runs of each length, the fastest of which gives host time
WINDOW_REPEATS = 3


def steady_window(run) -> dict:
    """Device kernels, busy time, idle share and the arbiter's device time
    per launch of a run's steady cycles.  ``run(n)`` runs ``n`` fixed-horizon
    cycles of the run's shape; it runs with ``n = WINDOW_LEAD`` and
    ``WINDOW_LEAD + PROFILE_CYCLES``, and every number is the difference of
    the two over ``PROFILE_CYCLES``, so the set-up both share (state, graph
    capture and its plain-arbiter warm-up cycle, copies, metrics) drops out.
    Kernels and busy time come from runs under the profiler.  Host time per
    cycle comes from runs without it (the profiler's own host cost,
    ``profiled_host_us_per_cycle``, would inflate it): the host seconds of
    the simulator's cycle loop alone, between two synchronizations, best of
    ``WINDOW_REPEATS`` runs (the set-up's host time varies by more than the
    window's cycles take).  The idle share is 1 - busy / host, None where
    busy reads above host (noise of a device-bound loop)."""
    import torch

    from repro_torch.core import simulator as sim

    inner, loop_s = sim._run_cycles, []

    def timed_loop(*args, **kwargs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state = inner(*args, **kwargs)
        torch.cuda.synchronize()
        loop_s[-1] += time.perf_counter() - t0
        return state

    def host_us(n):
        sim._run_cycles = timed_loop
        try:
            for _ in range(WINDOW_REPEATS):
                loop_s.append(0.0)
                run(n)
        finally:
            sim._run_cycles = inner
        return min(loop_s[-WINDOW_REPEATS:]) * 1e6

    run(WINDOW_LEAD)  # warm: the first call of a shape allocates
    got = []
    for n in (WINDOW_LEAD, WINDOW_LEAD + PROFILE_CYCLES):
        kernels, wall = device_kernels(lambda: run(n))
        arb = [e.time_range.elapsed_us() for e in kernels if "bank_arbiter" in e.name]
        busy = sum(e.time_range.elapsed_us() for e in kernels)
        got.append((busy, len(kernels), wall * 1e6, host_us(n), len(arb), sum(arb)))
    recorded = got[0][0] > 0 and got[1][0] > 0  # else a session lost its device time
    busy, kernels, profiled, host, arb_n, arb_us = (
        (b - a) / PROFILE_CYCLES for a, b in zip(*got)
    )
    return {
        "window_cycles": PROFILE_CYCLES,
        "host_us_per_cycle": host,
        "profiled_host_us_per_cycle": profiled,
        "device_kernels_per_cycle": kernels if recorded else None,
        "device_busy_us_per_cycle": busy if recorded else None,
        "device_idle_share": 1 - busy / host if recorded and 0 <= busy <= host else None,
        "arbiter_device_us_mean": arb_us / arb_n if recorded and arb_n > 0 else None,
    }


def predicted_cycles(drained_cycle, prm) -> int:
    """Cycle bodies the driver steps for a run whose lanes drained at
    ``drained_cycle`` when no lane takes the time skip: every cycle where
    early exit is off or a lane never drains, else the slowest lane's drain
    rounded up to whole blocks of ``block_cycles``.  A prediction from the
    results, independent of the driver's own count."""
    import numpy as np

    MC = prm.max_cycles
    drained = np.asarray(drained_cycle).reshape(-1)
    if not prm.early_exit or MC == 0 or (drained < 0).any():
        return MC
    K = max(1, min(prm.block_cycles, MC))
    return int(min(MC, -(-int(drained.max()) // K) * K))


def phase_profile(main: dict) -> None:
    """Where a cycle's time goes on the main path: device kernels, busy time
    and idle share per steady cycle (``steady_window``), beside the host
    time per cycle of the main run, and the arbiter kernel's share of the
    device time."""
    from repro_torch.core.simulator import simulate

    def run(n):
        return simulate(main["trace"], replace(main["prm"], max_cycles=n, early_exit=False))

    w = steady_window(run)
    arb_us, busy_us = w["arbiter_device_us_mean"], w["device_busy_us_per_cycle"]
    emit(
        "profile",
        **w,
        run_host_us_per_cycle=main["wall_s"] / main["stepped"] * 1e6,
        arbiter_share_of_device_time=arb_us / busy_us if arb_us and busy_us else None,
    )


def _rates(wall: float, stepped: int, lanes: int) -> dict:
    return {
        "lanes": lanes,
        "host_s": wall,
        "stepped_cycles": stepped,
        "cycles_per_s": stepped / wall,
        "lane_cycles_per_s": stepped * lanes / wall,
    }


def _sweep_run(name: str, lanes: int, fn, window, predict=None) -> tuple:
    """One run of the scale path: counted and checked (arbiter launches
    equal the cycle bodies stepped, and these equal ``predict(result)``
    where the run takes no time skip), then ``steady_window(window)``, where
    ``window(n)`` runs ``n`` fixed-horizon cycles of its shape; emits its
    line."""
    out, wall, launches, stepped = counted(fn)
    check(stepped > 0, f"sweep {name}: no cycle stepped")
    check(launches == stepped, f"sweep {name}: {launches} arbiter launches for {stepped} cycles")
    row = {**_rates(wall, stepped, lanes), "arbiter_launches": launches}
    if predict is not None:
        row["predicted_cycles"] = predict(out)
        check(stepped == row["predicted_cycles"], f"sweep {name}: cycles stepped vs drains: {row}")
    row.update(run_host_us_per_cycle=wall / stepped * 1e6, **steady_window(window))
    emit("sweep_run", run=name, **row)
    return out, row


def _equal_keys(a: dict, b: dict, skip=()) -> list:
    import numpy as np

    return [
        k
        for k in b
        if k not in skip and not (np.array_equal(a[k], b[k]) and a[k].dtype == b[k].dtype)
    ]


def _diff_records(got, want, path: str = "") -> tuple:
    """(integer and boolean mismatches, largest float difference) between
    two ``sweep_record`` trees; NaN equals NaN."""
    import math

    if isinstance(want, dict):
        if set(got) != set(want):
            return [f"{path}: keys {sorted(set(got) ^ set(want))}"], 0.0
        parts = [_diff_records(got[k], want[k], f"{path}/{k}") for k in want]
    elif isinstance(want, list):
        if len(got) != len(want):
            return [f"{path}: length"], 0.0
        parts = [_diff_records(g, w, f"{path}[{i}]") for i, (g, w) in enumerate(zip(got, want))]
    elif isinstance(want, float):
        if math.isnan(want) or math.isnan(got):
            return ([] if math.isnan(want) and math.isnan(got) else [path]), 0.0
        return [], abs(got - want)
    else:
        return ([] if got == want else [f"{path}: {got} != {want}"]), 0.0
    return [m for p in parts for m in p[0]], max([0.0, *(p[1] for p in parts)])


def _held_to_reference(name: str, got, want, source: str = "sweep_reference.json") -> None:
    """``got`` equals its record in ``source`` (a capture of the reference):
    every integer and boolean, and every float to the bit (the tests' stated
    tolerance, 0)."""
    mismatches, float_diff = _diff_records(json.loads(json.dumps(got)), want)
    check(not mismatches, f"{name} vs {source}: {mismatches[:5]}")
    check(float_diff == 0.0, f"{name}: float keys differ from {source} by up to {float_diff}")


def phase_sweep() -> dict:
    """The scale path on the card (see the module docstring, 10); returns
    each run's row for the kernels line."""
    import numpy as np
    import torch

    from repro_torch.core.percentile import STREAM_PCTS, p2_merge_quantile
    from repro_torch.core.simulator import (
        SCHEDULE_PIPELINE,
        SimParams,
        batch_envelope,
        carry_nbytes,
        simulate,
        simulate_batch,
    )
    from repro_torch.core.traffic import random_bursty
    from repro_torch.data import (
        GOLDEN_KEYS,
        SCALE_LANES,
        SCALE_MAX_CYCLES,
        SWEEP_OUTSTANDING,
        SWEEP_TXNS,
        TIME_SKIP_LANES,
        TIME_SKIP_MAX_CYCLES,
        TIME_SKIP_TRAFFIC,
        golden_batch,
        golden_cases,
        metrics_record,
        scale_grid_fields,
        sweep_record,
        sweep_reference,
    )
    from repro_torch.scenarios import (
        QOS_CLASSES,
        SweepPoint,
        preset_scenarios,
        run_sweep,
        urban_perception,
    )

    golden = json.loads((ROOT / "tests" / "data" / "golden_single_slice.json").read_text())
    runs = {}

    def horizon(prms, n, **pin):
        """``prms`` cut to ``n`` fixed-horizon cycles (a profiled window)."""
        return [replace(p, max_cycles=n, early_exit=False, **pin) for p in prms]

    # 1. goldens: the batch entry (B = 2) and the cases on the schedule pipeline
    traces, prms = golden_batch()
    out, runs["golden_batch"] = _sweep_run(
        "golden_batch",
        2,
        lambda: simulate_batch(traces, prms),
        lambda n: simulate_batch(traces, horizon(prms, n)),
        lambda out: predicted_cycles(out["drained_cycle"], prms[0]),
    )
    bad = [k for k in GOLDEN_KEYS if np.asarray(out[k]).tolist() != golden["batch"][k]]
    check(not bad, f"golden batch: keys differ {bad}")
    for name, trace, prm in golden_cases():
        sprm = replace(prm, stages=SCHEDULE_PIPELINE)
        out, wall, launches, stepped = counted(lambda: simulate(trace, sprm))
        bad = [k for k in GOLDEN_KEYS if np.asarray(out[k]).tolist() != golden["cases"][name][k]]
        check(not bad, f"golden {name} on the schedule pipeline: keys differ {bad}")
        check(launches == stepped, f"golden {name} schedule: {launches} launches, {stepped} cycles")
        emit("sweep_golden_schedule", case=name, **_rates(wall, stepped, 1))

    # 2. the full-width sweep, B = 10, against the reference's capture
    ref = sweep_reference()
    presets = preset_scenarios(SWEEP_TXNS)
    points = [
        SweepPoint(sc, SimParams(outstanding=o, max_cycles=ref["max_cycles"]))
        for sc in presets
        for o in SWEEP_OUTSTANDING
    ]
    res, runs["full_width_sweep"] = _sweep_run(
        "full_width_sweep",
        len(points),
        lambda: run_sweep(points),
        lambda n: run_sweep(
            [replace(p, params=horizon([p.params], n)[0]) for p in points]
        ),
        lambda res: predicted_cycles(
            [r.metrics["drained_cycle"] for r in res], points[0].params
        ),
    )
    _held_to_reference("full-width sweep", [sweep_record(r) for r in res], ref["points"])
    check(all(bool(r.metrics["all_done"]) for r in res), "full-width sweep: a lane not all_done")
    plain = [replace(p, params=replace(p.params, arbiter="ref")) for p in points]
    ref_res, ref_wall, _, ref_stepped = counted(lambda: run_sweep(plain))
    bad = [k for r, q in zip(res, ref_res) for k in _equal_keys(r.metrics, q.metrics)]
    check(not bad, f"full-width sweep: kernel and ref arbiters differ on {sorted(set(bad))}")
    emit(
        "sweep_full_width",
        points=len(points),
        max_cycles=ref["max_cycles"],
        drained_cycles=[int(r.metrics["drained_cycle"]) for r in res],
        ref_arbiter=_rates(ref_wall, ref_stepped, len(points)),
    )

    # 3. the scale grid: one shared schedule, 48 points, chunks of 32, B = 32
    sched = urban_perception().compile().schedule()
    grid = [SimParams(stages=SCHEDULE_PIPELINE, **f) for f in scale_grid_fields()]
    chunk = 32
    env = batch_envelope(grid)
    pin = dict(slots_override=env.slots_per_master, inflight_override=env.inflight_slots)
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    out, runs["scale_grid"] = _sweep_run(
        "scale_grid",
        chunk,
        lambda: simulate_batch([sched], grid, chunk=chunk),
        lambda n: simulate_batch([sched], horizon(grid[:chunk], n, **pin)),
    )
    peak = torch.cuda.max_memory_allocated() - base
    check(bool(out["all_done"].all()), "scale grid: a lane not all_done")
    plain = [replace(p, arbiter="ref") for p in grid]
    ref_out, ref_wall, _, ref_stepped = counted(
        lambda: simulate_batch([sched], plain, chunk=chunk)
    )
    bad = _equal_keys(out, ref_out)
    check(not bad, f"scale grid: kernel and ref arbiters differ on {bad}")
    for i in SCALE_LANES:
        one = replace(grid[i], **pin)
        alone, runs[f"scale_lane{i}"] = _sweep_run(
            f"scale_lane{i}",
            1,
            lambda: simulate(sched, one),
            lambda n: simulate(sched, horizon([one], n)[0]),
        )
        bad = _equal_keys(alone, {k: v[i] for k, v in out.items()})
        check(not bad, f"scale grid lane {i} differs from its own simulate() on {bad}")
        _held_to_reference(f"scale lane {i}", metrics_record(alone), ref["scale_lanes"][str(i)])
    merged = {}
    for c, cls in enumerate(QOS_CLASSES):
        for d, dname in enumerate(("read", "write")):
            g = c * 2 + d
            if out["p2_count"][:, g].sum() == 0:
                continue
            heights, marks = out["p2_height"][:, g], out["p2_npos"][:, g]
            merged[f"{cls}_{dname}"] = {
                f"p{int(q)}": p2_merge_quantile(
                    heights[:, qi], marks[:, qi], out["p2_count"][:, g], q / 100
                )
                for qi, q in enumerate(STREAM_PCTS)
            }
    X, N = sched.num_masters, sched.num_txns
    emit(
        "sweep_scale_grid",
        points=len(grid),
        chunk=chunk,
        max_cycles=SCALE_MAX_CYCLES,
        drained_cycles=sorted(set(out["drained_cycle"].tolist())),
        skipped_cycles=sorted(set(out["skipped_cycles"].tolist())),
        merged_latency_percentiles=merged,
        peak_memory_bytes_above_start=peak,
        carry_nbytes_x_chunk=carry_nbytes(env, X, N) * chunk,
        ref_arbiter=_rates(ref_wall, ref_stepped, chunk),
    )

    # 4. the time skip: 8 gapped lanes, B = 8, against the reference and no skip
    B = TIME_SKIP_LANES
    bursty = [random_bursty(**TIME_SKIP_TRAFFIC, seed=i) for i in range(B)]
    prm = SimParams(max_cycles=TIME_SKIP_MAX_CYCLES, stages=SCHEDULE_PIPELINE, collect="stream")
    on, runs["time_skip"] = _sweep_run(
        "time_skip",
        B,
        lambda: simulate_batch(bursty, [prm] * B),
        lambda n: simulate_batch(bursty, horizon([prm] * B, n)),
    )
    _held_to_reference("time skip", metrics_record(on), ref["time_skip"])
    no_skip = replace(prm, time_skip=False)
    off, off_wall, off_launches, off_stepped = counted(
        lambda: simulate_batch(bursty, [no_skip] * B)
    )
    check(off_launches == off_stepped, "time skip off: launches differ from cycles stepped")
    want = predicted_cycles(off["drained_cycle"], no_skip)
    check(off_stepped == want, f"time skip off: {off_stepped} cycles stepped, {want} predicted")
    bad = _equal_keys(on, off, skip=("skipped_cycles",))
    check(not bad, f"time skip on and off differ on {bad}")
    check(bool((on["skipped_cycles"] > 0).all()), "time skip: a lane skipped nothing")
    ref_on, ref_wall, _, ref_stepped = counted(
        lambda: simulate_batch(bursty, [replace(prm, arbiter="ref")] * B)
    )
    bad = _equal_keys(on, ref_on)
    check(not bad, f"time skip: kernel and ref arbiters differ on {bad}")
    emit(
        "sweep_time_skip",
        skipped_cycles=on["skipped_cycles"].tolist(),
        drained_cycles=on["drained_cycle"].tolist(),
        stepped_with_skip=runs["time_skip"]["stepped_cycles"],
        without_skip=_rates(off_wall, off_stepped, B),
        ref_arbiter=_rates(ref_wall, ref_stepped, B),
    )
    return runs


@contextlib.contextmanager
def _patched(module, name: str, wrap):
    """While active, ``module.name`` is ``wrap(module.name)``."""
    inner = getattr(module, name)
    setattr(module, name, wrap(inner))
    try:
        yield
    finally:
        setattr(module, name, inner)


@contextlib.contextmanager
def sim_accounting():
    """While active, the host seconds of every simulator cycle loop
    (``loop_s``) and CUDA-graph capture (``capture_s``, ``captures``), each
    between two synchronizations; what else a call takes is its set-up
    (state, input copies, the metrics' read-back)."""
    import torch

    from repro_torch.core import simulator as sim

    acc = {"loop_s": 0.0, "capture_s": 0.0, "captures": 0}

    def timed(key):
        def wrap(inner):
            def run(*args, **kwargs):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = inner(*args, **kwargs)
                torch.cuda.synchronize()
                acc[key] += time.perf_counter() - t0
                if key == "capture_s":
                    acc["captures"] += 1
                return out

            return run

        return wrap

    with _patched(sim, "_run_cycles", timed("loop_s")), _patched(
        sim, "_GraphedCycle", timed("capture_s")
    ):
        yield acc


#: the capture the co-sim and fuzz phases are held to
COSIM_CAPTURE = "cosim_reference.json"
#: the serving co-sim's three fabric configurations, lanes of one batch
COSIM_CONFIGS = ("alone", "qos_on", "qos_off")


def gather_stats(comp, trace, metrics) -> dict:
    """Per-gather service latency of the decode class, as the reference's
    co-sim benchmark counts it: a decode step is done when the slowest read
    of its whole-prefix gather returns (the engine cannot sample the next
    token before), so the latency is per decode event (the reads of one
    master row with one start cycle), not per burst."""
    import numpy as np

    acc = np.asarray(metrics["accept_cycle"])
    com = np.asarray(metrics["complete_cycle"])
    iw, burst = np.asarray(trace.is_write), np.asarray(trace.burst)
    start = trace.start_or_zeros()
    lats = []
    for m in [i for i, q in enumerate(comp.qos) if q == "realtime"]:
        sel = (burst[m] > 0) & (iw[m] == 0) & (com[m] >= 0) & (acc[m] >= 0)
        for t0 in np.unique(start[m][sel]):
            lats.append(float(com[m][sel & (start[m] == t0)].max() - t0))
    lats = np.asarray(lats)
    return {
        "gathers": int(lats.size),
        "gather_lat_p50": float(np.percentile(lats, 50)),
        "gather_lat_p99": float(np.percentile(lats, 99)),
        "gather_lat_max": float(lats.max()),
    }


def cosim_group(
    *,
    max_batch,
    num_slices,
    num_requests,
    prompt_lo,
    prompt_hi,
    max_new_tokens,
    cycles_per_step,
    bank_occupancy,
    reg_rate,
    reg_burst,
    seed,
    device=None,
) -> dict:
    """One group of the serving co-sim grid, as the reference's benchmark
    builds it: a traffic-only engine run recorded, compiled by
    ``serving_scenario``, and run alone (prefill silenced), with QoS on (the
    regulator) and with QoS off (no priorities) as three lanes of one dense,
    exact ``simulate_batch`` on ``device`` (default: CUDA).  Returns the
    record's summary, the trace's shape, each configuration's summary and
    gather stats, the lanes' drains and the batch's inputs."""
    import numpy as np

    from repro_torch.core.address import MemoryGeometry
    from repro_torch.core.simulator import SimParams, Trace, simulate_batch
    from repro_torch.scenarios import record_serving_run, serving_scenario

    rec = record_serving_run(
        num_requests=num_requests,
        max_batch=max_batch,
        max_len=prompt_hi + max_new_tokens + 16,
        prompt_lo=prompt_lo,
        prompt_hi=prompt_hi,
        max_new_tokens=max_new_tokens,
        seed=seed,
    )
    geom = MemoryGeometry(num_slices=num_slices)
    comp = serving_scenario(
        rec, geom=geom, cycles_per_step=cycles_per_step, decode_deadline=4 * cycles_per_step
    ).compile()
    full = comp.trace
    decode = np.array([q == "realtime" for q in comp.qos])
    silenced = np.where(decode[:, None], full.burst, 0).astype(np.int32)
    alone = Trace(full.is_write, silenced, full.addr, full.start, full.prio)
    blind = Trace(full.is_write, full.burst, full.addr, full.start, None)
    base = SimParams(
        geom=geom, max_cycles=(rec.steps + 16) * cycles_per_step, bank_occupancy=bank_occupancy
    )
    qos_on = replace(base, reg_rate=reg_rate, reg_burst=reg_burst)
    traces, prms = [alone, full, blind], [qos_on, qos_on, base]
    stacked = simulate_batch(traces, prms, device=device)
    rows, gathers = {}, {}
    for i, (cfg, tr, prm) in enumerate(zip(COSIM_CONFIGS, traces, prms)):
        metrics = {k: np.asarray(v)[i] for k, v in stacked.items()}
        rows[cfg] = replace(comp, trace=tr).summarize(prm, metrics).summary()
        gathers[cfg] = gather_stats(comp, tr, metrics)
    return {
        "record": rec.summary(),
        "trace_shape": list(full.burst.shape),
        "rows": rows,
        "gathers": gathers,
        "drained_cycle": stacked["drained_cycle"],
        "inputs": (traces, prms),
    }


def check_cosim_claims(groups: dict, bound_cycles: int, margin_cycles: int) -> dict:
    """The reference benchmark's asserts over the grid's groups (named
    ``batch<b>_slices<s>``): decode p99 with QoS on within ``bound_cycles`` of
    alone and no deadline missed in every group; at the heaviest corner QoS
    off at least ``margin_cycles`` worse than QoS on; a second slice at the
    largest batch at least halves the QoS-off damage.  Returns the headline."""
    p99 = {
        g: {c: r["gathers"][c]["gather_lat_p99"] for c in COSIM_CONFIGS}
        for g, r in groups.items()
    }
    shape = [tuple(int(x) for x in g.replace("batch", "").split("_slices")) for g in groups]
    batch = max(b for b, _ in shape)
    lo, hi = min(s for _, s in shape), max(s for _, s in shape)
    for g, h in p99.items():
        check(h["qos_on"] <= h["alone"] + bound_cycles, f"co-sim {g}: QoS-on p99 {h}")
        misses = groups[g]["rows"]["qos_on"]["per_class"]["realtime"]["deadline_misses"]
        check(misses == 0, f"co-sim {g}: {misses} decode deadlines missed with QoS on")
    heavy = p99[f"batch{batch}_slices{lo}"]
    check(heavy["qos_off"] >= heavy["qos_on"] + margin_cycles, f"co-sim heavy corner: {heavy}")
    at = {s: p99[f"batch{batch}_slices{s}"] for s in (lo, hi)}
    damage = {s: h["qos_off"] - h["alone"] for s, h in at.items()}
    if hi > lo:
        check(damage[hi] <= damage[lo] / 2, f"co-sim: a second slice does not halve {damage}")
    return {g: {f"{c}_p99": v for c, v in h.items()} for g, h in p99.items()}


def phase_cosim() -> dict:
    """The serving co-sim grid on the card (module docstring, 11); returns
    each group's row for the kernels line."""
    from repro_torch.core.simulator import simulate_batch
    from repro_torch.data import COSIM_GRID, cosim_reference

    ref = cosim_reference()["grid"]
    grid = dict(COSIM_GRID)
    batches, slices = grid.pop("batch_sizes"), grid.pop("slice_counts")
    bound, margin = grid.pop("bound_cycles"), grid.pop("margin_cycles")
    groups, runs = {}, {}
    for b in batches:
        for s in slices:
            name = f"batch{b}_slices{s}"
            with sim_accounting() as acc:
                out, wall, launches, stepped = counted(
                    lambda: cosim_group(max_batch=b, num_slices=s, **grid)
                )
            check(launches == stepped, f"co-sim {name}: {launches} launches, {stepped} cycles")
            want = predicted_cycles(out["drained_cycle"], out["inputs"][1][0])
            check(stepped == want, f"co-sim {name}: {stepped} cycles stepped, {want} predicted")
            got = {k: out[k] for k in ("record", "trace_shape", "rows", "gathers")}
            _held_to_reference(f"co-sim {name}", got, ref[name], COSIM_CAPTURE)
            groups[name] = out
            runs[name] = row = {
                **_rates(wall, stepped, 3),
                "arbiter_launches": launches,
                "loop_s": acc["loop_s"],
                "capture_s": acc["capture_s"],
                "setup_s": wall - acc["loop_s"],
                "trace_shape": out["trace_shape"],
                "engine_steps": out["record"]["steps"],
                "drained_cycle": out["drained_cycle"].tolist(),
            }
            emit("cosim_group", group=name, **row, gathers=out["gathers"])
    headline = check_cosim_claims(groups, bound, margin)
    traces, prms = groups[f"batch{max(batches)}_slices{min(slices)}"]["inputs"]
    window = steady_window(
        lambda n: simulate_batch(traces, [replace(p, max_cycles=n, early_exit=False) for p in prms])
    )
    emit("cosim", headline=headline, bound_cycles=bound, margin_cycles=margin, heavy_window=window)
    return runs


def cosim_scale_setup(n: int) -> tuple:
    """The co-sim's scale mode at ``n`` requests: ``(record, compiled
    scenario, SimParams)``, a recorded traffic-only run of ``COSIM_SCALE``'s
    shape on the schedule pipeline with streaming percentiles."""
    from repro_torch.core.simulator import SCHEDULE_PIPELINE, SimParams
    from repro_torch.data import COSIM_SCALE, cosim_scale_params
    from repro_torch.scenarios import record_serving_run, serving_scenario

    cfg = {k: v for k, v in COSIM_SCALE.items() if k not in ("cycles_per_step", "bank_occupancy")}
    cps = COSIM_SCALE["cycles_per_step"]
    rec = record_serving_run(
        **{**cfg, "num_requests": n},
        max_len=cfg["prompt_hi"] + cfg["max_new_tokens"] + 16,
        max_steps=None,
    )
    comp = serving_scenario(rec, cycles_per_step=cps, decode_deadline=4 * cps).compile()
    return rec, comp, SimParams(**cosim_scale_params(rec, SCHEDULE_PIPELINE))


def phase_cosim_scale() -> dict:
    """The co-sim's scale mode on the card (module docstring, 12); returns
    each leg's row for the kernels line."""
    from repro_torch.core.simulator import carry_nbytes, compile_simulate, simulate
    from repro_torch.data import (
        COSIM_SCALE,
        COSIM_SCALE_FIXED_REQUESTS,
        cosim_reference,
        metrics_record,
        scale_summary,
    )

    ref = cosim_reference()["scale"]
    runs = {}
    rec, comp, prm = cosim_scale_setup(COSIM_SCALE["num_requests"])
    with sim_accounting() as acc:
        res, wall, launches, stepped = counted(lambda: comp.simulate(prm))
    check(bool(res.metrics["all_done"]), "co-sim scale: the run did not drain")
    check(res.per_class["realtime"]["deadline_txns"] > 0, "co-sim scale: no deadline counted")
    check(launches == stepped, f"co-sim scale: {launches} launches, {stepped} cycles")
    carry = carry_nbytes(prm, comp.trace.num_masters, comp.trace.num_txns)
    summary = scale_summary(rec, comp, prm, res, carry)
    _held_to_reference("co-sim scale", summary, ref["summary"], COSIM_CAPTURE)
    metrics = metrics_record(res.metrics)
    _held_to_reference("co-sim scale metrics", metrics, ref["metrics"], COSIM_CAPTURE)
    runs["scale_skip"] = row = {
        **_rates(wall, stepped, 1),
        "arbiter_launches": launches,
        "loop_s": acc["loop_s"],
        "capture_s": acc["capture_s"],
        "setup_s": wall - acc["loop_s"],
    }
    sched = comp.schedule()
    window = steady_window(lambda n: simulate(sched, replace(prm, max_cycles=n, early_exit=False)))
    emit("cosim_scale", **summary, **row, window=window)

    # the fixed horizon against the time skip, at COSIM_SCALE_FIXED_REQUESTS
    n = COSIM_SCALE_FIXED_REQUESTS
    rec, comp, prm = cosim_scale_setup(n)
    sched = comp.schedule()
    legs, rows = {}, {}
    for name, p in (("skip", prm), ("fixed", replace(prm, early_exit=False, time_skip=False))):
        out, wall, launches, stepped = counted(compile_simulate(sched, p))
        check(launches == stepped, f"co-sim scale {name}: {launches} launches, {stepped} cycles")
        want = ref[f"legs{n}"][name]
        _held_to_reference(f"co-sim scale {name}", metrics_record(out), want, COSIM_CAPTURE)
        legs[name], rows[name] = out, {**_rates(wall, stepped, 1), "arbiter_launches": launches}
        runs[f"scale{n}_{name}"] = rows[name]
    check(rows["fixed"]["stepped_cycles"] == prm.max_cycles, "co-sim scale: the fixed horizon")
    bad = _equal_keys(legs["skip"], legs["fixed"], skip=("skipped_cycles",))
    check(not bad, f"co-sim scale: time skip and fixed horizon differ on {bad}")
    emit(
        "cosim_scale_legs",
        requests=rec.num_requests,
        max_cycles=prm.max_cycles,
        skipped_cycles=int(legs["skip"]["skipped_cycles"]),
        drained_cycle=int(legs["skip"]["drained_cycle"]),
        **rows,
        fixed_over_skip_wall=rows["fixed"]["host_s"] / rows["skip"]["host_s"],
        reference_speedup_floor=1.5,
    )
    return runs


def _fuzz_run(name: str, cfg: dict) -> tuple:
    """``run_fuzz(FuzzConfig(**cfg))`` on the card, counted; returns
    ``(outcome, results, calls, row)``: every case's result (from its
    ``evaluate_cases`` calls), every ``simulate_batch`` call (lanes, host
    seconds, cycles stepped, inputs) and the run's line of rates: host
    seconds, specs and cycles per second, lane-cycles per second, arbiter
    launches (equal to the cycles stepped), and the seconds of the cycle
    loops, of the graph captures and of the rest of the simulator calls."""
    import torch

    from repro_torch.core.simulator import DRIVER_COUNTS
    from repro_torch.scenarios import fuzz

    results, calls = [], []

    def recording(inner):
        def evaluate(*args, **kwargs):
            out = inner(*args, **kwargs)
            results.extend(out)
            return out

        return evaluate

    def timed(inner):
        def batch(inputs, prms, **kwargs):
            torch.cuda.synchronize()
            c0, t0 = DRIVER_COUNTS["cycles"], time.perf_counter()
            out = inner(inputs, prms, **kwargs)
            torch.cuda.synchronize()
            calls.append(
                dict(
                    lanes=len(prms),
                    host_s=time.perf_counter() - t0,
                    stepped_cycles=DRIVER_COUNTS["cycles"] - c0,
                    inputs=(inputs, prms),
                )
            )
            return out

        return batch

    with _patched(fuzz, "evaluate_cases", recording), _patched(fuzz, "simulate_batch", timed):
        with sim_accounting() as acc:
            outcome, wall, launches, stepped = counted(
                lambda: fuzz.run_fuzz(fuzz.FuzzConfig(**cfg))
            )
    check(launches == stepped, f"{name}: {launches} launches, {stepped} cycles")
    call_s = sum(c["host_s"] for c in calls)
    row = {
        "host_s": wall,
        "specs": outcome.evaluated,
        "specs_per_s": outcome.evaluated / wall,
        "simulate_batch_calls": len(calls),
        "lanes_per_call": [c["lanes"] for c in calls],
        "stepped_cycles": stepped,
        "cycles_per_s": stepped / wall,
        "lane_cycles_per_s": sum(c["stepped_cycles"] * c["lanes"] for c in calls) / wall,
        "arbiter_launches": launches,
        "loop_s": acc["loop_s"],
        "capture_s": acc["capture_s"],
        "captures": acc["captures"],
        "setup_s": call_s - acc["loop_s"],
        "setup_s_per_call": (call_s - acc["loop_s"]) / len(calls),
        "host_s_outside_simulator": wall - call_s,
    }
    return outcome, results, calls, row


def phase_fuzz() -> dict:
    """The scenario fuzzer on the card (module docstring, 13); returns its
    runs' rows for the kernels line."""
    from repro_torch.core.simulator import simulate_batch
    from repro_torch.data import FUZZ_JOB, FUZZ_PLANTED, case_record, cosim_reference
    from repro_torch.scenarios import fuzz

    ref = cosim_reference()["fuzz"]
    runs = {}

    # the clean-tree job: every case against the capture, verdict for verdict
    outcome, results, calls, runs["fuzz_job"] = _fuzz_run("fuzz job", FUZZ_JOB)
    check(outcome.evaluated == FUZZ_JOB["budget"] and not outcome.truncated, "fuzz job: budget")
    check(len(results) == len(ref["job"]["cases"]), f"fuzz job: {len(results)} cases evaluated")
    for res, want in zip(results, ref["job"]["cases"]):
        got = case_record(res, fuzz.case_to_json(res.case))
        _held_to_reference(f"fuzz case {res.case.index}", got, want, COSIM_CAPTURE)
    summary = outcome.summary()
    got = {k: summary[k] for k in ("evaluated", "violations", "violated_oracles")}
    _held_to_reference("fuzz job summary", got, ref["job"]["summary"], COSIM_CAPTURE)
    inputs, prms = max(calls, key=lambda c: c["lanes"])["inputs"]
    window = steady_window(
        lambda n: simulate_batch(inputs, [replace(p, max_cycles=n, early_exit=False) for p in prms])
    )
    emit(
        "fuzz_job",
        **runs["fuzz_job"],
        violated_oracles=summary["violated_oracles"],
        verdicts={r.case.index: sorted({v.oracle for v in r.violations}) for r in results},
        widest_call_window=window,
    )

    # the committed corpus replays to its verdicts
    replays = {}
    for path in sorted((ROOT / "tests" / "data" / "fuzz_corpus").glob("*.json")):
        case, verdict = fuzz.load_reproducer(path)
        res, wall, launches, stepped = counted(lambda: fuzz.replay_case(case))
        got = sorted({v.oracle for v in res.violations})
        check(got == sorted(verdict.get("violated_oracles", [])), f"corpus {path.name}: {got}")
        check(launches == stepped, f"corpus {path.name}: {launches} launches, {stepped} cycles")
        replays[path.stem] = dict(violated_oracles=got, **_rates(wall, stepped, 1))
    emit("fuzz_corpus", replays=replays)

    # a planted violation found and shrunk to the reference's minimal spec
    outcome, _, _, runs["fuzz_planted"] = _fuzz_run("fuzz planted", FUZZ_PLANTED)
    check(bool(outcome.violating), "fuzz planted: the planted violation was not found")
    want = ref["planted"]["reproducers"]
    _held_to_reference("fuzz planted", outcome.reproducers, want, COSIM_CAPTURE)
    emit("fuzz_planted", **runs["fuzz_planted"], shrunk=outcome.reproducers[0]["shrunk"])
    return runs


def phase_timing(launches: int, max_abs_err: int) -> dict:
    """Times at the main path's shape (B=1, S=32*256, NB=256) and at a
    sweep's (B=64): device time per call from the profiler (``ms``; CUDA
    events over back-to-back calls where the profiler records nothing) and
    the per-call time of back-to-back calls between CUDA events, which
    includes the host's launch overhead; beside them the device time of the
    empty kernel of the arbiter's launch shape (``floor``) and the kernel's
    device time at every cluster size."""
    from functools import partial

    import numpy as np
    import torch

    from repro_torch.kernels.bank_arbiter.ops import (
        CLUSTER_SIZES,
        bank_arbiter_winners,
        floor_launch,
        launch_shape,
    )
    from repro_torch.kernels.bank_arbiter.ref import KEY_FILLER, bank_arbiter_ref

    rows = {}
    for B in (1, 64):
        S, NB, X = 8192, 256, 32
        key, bank, elig = arb_inputs(np.random.default_rng(B), B, S, NB, X)
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
            "floor": lambda: floor_launch(B, S, num_banks=NB, device=key.device),
            "plain": lambda: bank_arbiter_ref(key, bank, elig, num_banks=NB),
            "library": lambda: init.scatter_reduce(1, seg, packed, "amin"),
        }
        call_ms = {k: time_ms(fn, 2000) for k, fn in fns.items()}
        dev_ms = {k: device_ms(fn, 200) for k, fn in fns.items()}
        ms = {k: dev_ms[k] if dev_ms[k] is not None else call_ms[k] for k in fns}
        # the kernel at every cluster size, beside the one the wrapper picks
        by_cluster = {}
        for c in CLUSTER_SIZES:
            at_c = partial(bank_arbiter_winners, key, bank, elig, num_banks=NB, _cluster=c)
            check(torch.equal(at_c(), lib_win), f"B={B}: the kernel at cluster {c} disagrees")
            by_cluster[c] = device_ms(at_c, 200)
        nbytes = B * S * (key.element_size() + bank.element_size() + elig.element_size())
        nbytes += B * NB * 4
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        ops_ms = 3 * B * S / ALU_OPS_PER_S * 1e3  # a test, a pack and an atomic per slot
        cluster, threads, tile = launch_shape(
            B, S, torch.cuda.get_device_properties(0).multi_processor_count
        )
        emit(
            "timing",
            shape=dict(B=B, S=S, NB=NB),
            launch=dict(cluster=cluster, threads=threads, tile=tile),
            device_us={k: None if v is None else v * 1e3 for k, v in dev_ms.items()},
            kernel_device_us_by_cluster={
                c: None if v is None else v * 1e3 for c, v in by_cluster.items()
            },
            call_us={k: v * 1e3 for k, v in call_ms.items()},
            bytes=nbytes,
            bound_us=max(bytes_ms, ops_ms) * 1e3,
        )
        rows[B] = dict(ms=ms, call_ms=call_ms, bytes_ms=bytes_ms, ops_ms=ops_ms)
    main = rows[1]
    return {
        "name": "bank_arbiter",
        "route": "cuda",
        "source": "src/repro_torch/kernels/bank_arbiter/csrc/bank_arbiter.cu",
        "replaces": "src/repro/kernels/bank_arbiter/kernel.py:79",
        "launches": launches,
        "max_abs_err": max_abs_err,
        "ms": main["ms"]["kernel"],
        "plain_ms": main["ms"]["plain"],
        "bound_ms": max(main["bytes_ms"], main["ops_ms"]),
        "bound_by": "bytes" if main["bytes_ms"] >= main["ops_ms"] else "operations",
        "library_ms": main["ms"]["library"],
        "call_ms": main["call_ms"]["kernel"],
        "floor_ms": main["ms"]["floor"],
        "B64_ms": rows[64]["ms"]["kernel"],
        "B64_floor_ms": rows[64]["ms"]["floor"],
    }


def _cuda_randn(gen, shape, dtype):
    """Standard normals drawn in float32 and rounded to ``dtype``, in slices
    of at most 2^28 elements along the first dim: a pool of many GB (10.7 GB
    of bf16 at stablelm-3b's row, 6.4 GB beside chameleon-34b's 68.6 GB of
    weights) never has a float32 copy of its own size."""
    import torch

    out = torch.empty(shape, dtype=dtype, device="cuda")
    rows = max(1, 2**28 // max(1, math.prod(shape[1:])))
    for part in out.split(rows):
        part.copy_(torch.randn(part.shape, generator=gen, device="cuda", dtype=torch.float32))
    return out


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


def _mla_lengths() -> list:
    """deepseek-v2-lite-16b's first wave at mid-decode: its 8 first prompts'
    lengths plus 16 (``launch.serve.FULL``, seed 0, as its serving run draws
    them)."""
    from repro_torch.configs import get_config
    from repro_torch.launch import serve

    prompts = serve.make_prompts(get_config("deepseek-v2-lite-16b"), serve.FULL, seed=0)
    return [len(p) + serve.FULL.max_new_tokens // 2 for p in prompts[: serve.FULL.max_batch]]


#: the serving paths' ``banked_copy`` bursts, bf16 blocks of 16 tokens: arch
#: -> (PERF.md's row, blocks, W, the kernel checks' case and pool blocks);
#: ``chip_turns.py --copy`` times the same bursts
COPY_BURSTS = {
    "stablelm-1.6b": ("2s", 64, 24 * 2 * 32 * 64, "path_64_blocks", 2048),
    "olmoe-1b-7b": ("2o", 64, 16 * 2 * 16 * 128, "olmoe_64_blocks", 2048),
    # a 497,664-byte tile
    "deepseek-v2-lite-16b": ("2m", 64, 27 * 576, "mla_64_blocks", 2048),
    "stablelm-3b": ("2d", 64, 32 * 2 * 32 * 80, "stablelm3b_64_blocks", 512),
    "deepseek-7b": ("2k", 64, 30 * 2 * 32 * 128, "deepseek7b_64_blocks", 512),
    # jamba's serving cut: one attention layer of 8 groups at 128
    "jamba-1.5-large-398b": ("2j", 64, 1 * 2 * 8 * 128, "jamba_64_blocks", 2048),
    # whisper-base: the SPEECH mix's longest prompt
    "whisper-base": ("2e", 14, 6 * 2 * 8 * 64, "whisper_14_blocks", 448),
}


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
    # the serving paths' prefill shapes (stablelm-1.6b: H = G = 32, D = 64;
    # olmoe-1b-7b: H = G = 16, D = 128)
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
        ("olmoe_S128", 1, 128, 128, 16, 16, 128, True, 0),
        ("olmoe_S517", 1, 517, 517, 16, 16, 128, True, 0),
        ("olmoe_S1024", 1, 1024, 1024, 16, 16, 128, True, 0),
        ("S1", 1, 1, 1, 4, 4, 64, True, 0),
        ("S15", 1, 15, 15, 4, 4, 64, True, 0),
        ("S2048_gqa4", 1, 2048, 2048, 4, 1, 64, True, 0),
        ("ragged_T333_gqa8_d32", 1, 100, 333, 8, 1, 32, False, 0),
        ("window64_gqa8", 1, 300, 300, 32, 4, 64, True, 64),
        ("d16", 2, 77, 77, 8, 2, 16, True, 0),
        ("batch2_gqa4_d128", 2, 200, 200, 16, 4, 128, True, 0),
        # the dense configs' prefill shapes: deepseek-7b (32 x 128), chameleon-34b
        # (GQA 64:8 at 128), stablelm-3b (32 x 80: the D = 80 instantiations),
        # and D = 80 at the edges (S = 1, ragged T, a window)
        ("deepseek7b_S1024", 1, 1024, 1024, 32, 32, 128, True, 0),
        ("chameleon_S1024", 1, 1024, 1024, 64, 8, 128, True, 0),
        ("stablelm3b_S128", 1, 128, 128, 32, 32, 80, True, 0),
        ("stablelm3b_S517", 1, 517, 517, 32, 32, 80, True, 0),
        ("stablelm3b_S1024", 1, 1024, 1024, 32, 32, 80, True, 0),
        ("d80_S1", 1, 1, 1, 32, 32, 80, True, 0),
        ("d80_ragged_T333_gqa8_full", 1, 100, 333, 8, 1, 80, False, 0),
        ("d80_window64_gqa4", 2, 300, 300, 32, 8, 80, True, 64),
        # h2o-danube-1.8b's prefill at the WINDOW mix's longest prompt: 32
        # heads over 8 groups at 80, S 8192, its window of 4096
        ("h2o_S8192_window4096", 1, 8192, 8192, 32, 8, 80, True, 4096),
        # whisper-base (8 heads of 64): the encoder over its 1500 frames, no
        # multiple of a tile (non-causal: the padded key columns masked by
        # the true length), cross-attention at prefill (a short prompt and
        # the SPEECH mix's longest over the 1500 frames), at S = 1 (the
        # route the paged kernel takes the place of), the causal prefill
        ("whisper_enc_S1500", 1, 1500, 1500, 8, 8, 64, False, 0),
        ("whisper_cross_S100", 1, 100, 1500, 8, 8, 64, False, 0),
        ("whisper_cross_S224", 1, 224, 1500, 8, 8, 64, False, 0),
        ("whisper_cross_S1_B8", 8, 1, 1500, 8, 8, 64, False, 0),
        ("whisper_self_S224", 1, 224, 224, 8, 8, 64, True, 0),
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

    # paged: the JAX tests' shapes, then the decode paths': 8 slots over
    # strided layer views of an all-layer pool (24 layers for stablelm-1.6b,
    # 16 for olmoe-1b-7b), one slot idle (length 0)
    paged_cases = [
        ("jax_2_8_2_64", 2, 8, 2, 64, 16, 16, 4, 0),
        ("jax_3_4_1_128", 3, 4, 1, 128, 32, 8, 6, 0),
        ("jax_2_16_4_64", 2, 16, 4, 64, 64, 32, 3, 0),
        ("heads8_3_16_2_64", 3, 16, 2, 64, 64, 16, 8, 0),
        ("d16_4_16_2_16", 4, 16, 2, 16, 64, 16, 8, 0),
        ("path_8x32x64_pool_view", 8, 32, 32, 64, 2048, 16, 128, 24),
        ("olmoe_8x16x128_pool_view", 8, 16, 16, 128, 2048, 16, 128, 16),
        # the dense configs' decode: deepseek-7b (30 layers of 32 x 128),
        # chameleon-34b (48 layers, 8 query heads per group at 128), stablelm-3b
        # (32 layers of 32 x 80), and D = 80 at 2 and 4 heads per group
        ("deepseek7b_8x32x128_pool_view", 8, 32, 32, 128, 2048, 16, 128, 30),
        ("chameleon_8x64x8x128_pool_view", 8, 64, 8, 128, 2048, 16, 128, 48),
        ("stablelm3b_8x32x80_pool_view", 8, 32, 32, 80, 2048, 16, 128, 32),
        ("d80_heads2_3_8_4", 3, 8, 4, 80, 64, 16, 8, 0),
        ("d80_heads4_3_8_2", 3, 8, 2, 80, 64, 16, 8, 0),
        # whisper-base's decoder self-attention: 6 layers of 8 x 64
        ("whisper_8x8x64_pool_view", 8, 8, 8, 64, 2048, 16, 128, 6),
    ]
    for name, B, H, G, D, NB, bs, mb, path_layers in paged_cases:
        path = path_layers > 0
        for dtype, tol in ((f32, 2e-5), (bf16, 3e-2)):
            if path and dtype == f32:
                continue
            q = _cuda_randn(gen, (B, H, D), dtype)
            if path:
                pool = _cuda_randn(gen, (NB, bs, path_layers, 2, G, D), dtype)
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
    # end, past it (clamped) and 0, with 8 query heads per group (D = 80:
    # also with 1, 2 and 4)
    for bs, D in ((16, 64), (8, 16), (32, 128), (16, 80)):
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
            if D != 80:
                continue
            for m in (1, 2, 4):
                q = _cuda_randn(gen, (B, G * m, D), dtype)
                got = paged_attention(q, kp, vp, tbl, ln)
                torch.cuda.synchronize()
                err = _max_err(got, paged_attention_ref(q, kp, vp, tbl, ln))
                record("paged_attention", f"edge_lengths_d80_heads{m}_{str(dtype)[6:]}", err, tol)
                check(bool((got[B - 1] == 0).all()), "paged edge lengths d80: empty request not 0")

    # banked_copy: the JAX tests' shapes and dtypes, two unaligned tiles, the
    # admission paths' bursts (``COPY_BURSTS``), and the edges of the kernel's
    # plan (``ops.copy_plan``): one block, a burst under one chunk, every entry
    # -1, and B = 3 with -1 tails at whisper's width;
    # ``used`` is each request's live entries (None: odd rows end with a -1)
    copy_cases = [
        ("jax_2_4_32_16_128", 2, 4, 32, 16, 128, None, (f32, bf16, torch.int32)),
        ("jax_3_2_16_8_256", 3, 2, 16, 8, 256, None, (f32, bf16, torch.int32)),
        ("jax_1_8_64_32_64", 1, 8, 64, 32, 64, None, (f32, bf16, torch.int32)),
        ("unaligned_3x5", 2, 3, 16, 3, 5, None, (f32, bf16)),
        *[(case, 1, n, NB, 16, W, None, (bf16,)) for _, n, W, case, NB in COPY_BURSTS.values()],
        ("one_block", 1, 1, 448, 16, 6 * 2 * 8 * 64, (1,), (f32, bf16, torch.int32)),
        ("under_one_chunk", 1, 1, 8, 2, 8, (1,), (f32, bf16, torch.int32)),
        ("all_skipped", 2, 4, 32, 16, 128, (0, 0), (f32, bf16, torch.int32)),
        ("whisper_b3_tails", 3, 14, 448, 16, 6 * 2 * 8 * 64, (14, 9, 3), (bf16,)),
    ]
    for name, B, nblk, NB, bs, W, used, dtypes in copy_cases:
        for dtype in dtypes:
            if dtype == torch.int32:
                pool = torch.randint(0, 100, (NB, bs, W), generator=gen, device="cuda").int()
                new = torch.randint(0, 100, (B, nblk, bs, W), generator=gen, device="cuda").int()
            else:
                pool = _cuda_randn(gen, (NB, bs, W), dtype)
                new = _cuda_randn(gen, (B, nblk, bs, W), dtype)
            live = used or [nblk - (b % 2) for b in range(B)]
            tbl = _unique_tables(gen, B, nblk, NB, live)
            got = banked_copy(pool.clone(), new, tbl)
            torch.cuda.synchronize()
            want = banked_copy_ref(pool, new, tbl)
            record("banked_copy", f"{name}_{str(dtype)[6:]}", float(not torch.equal(got, want)), 0)
            if name == "all_skipped":
                check(torch.equal(got, pool), "banked_copy wrote a pool row with every entry -1")
            if name.startswith("jamba"):
                repeat_copy = torch.equal(got, banked_copy(pool.clone(), new, tbl))
            del pool, new, got, want

    # MLA (deepseek-v2-lite-16b): flash at QK 192 / V 128 at its prompts'
    # lengths, the latent paged call (16 heads, K rows of 576, V their first
    # 512 columns) at its first wave's mid-decode lengths over a strided layer
    # view of the all-layer latent pool, one slot idle, ragged last blocks
    repeat = {"banked_copy_jamba": repeat_copy}
    mla_scale = 192**-0.5
    for S in (128, 517, 1024):
        for dtype, tol in ((f32, 2e-5), (bf16, 2e-2)):
            q, k = (_cuda_randn(gen, (1, S, 16, 192), dtype) for _ in range(2))
            v = _cuda_randn(gen, (1, S, 16, 128), dtype)
            got = flash_attention(q, k, v, causal=True, scale=mla_scale)
            torch.cuda.synchronize()
            want = flash_attention_ref(q, k, v, causal=True, scale=mla_scale)
            record("flash_attention", f"mla_S{S}_{str(dtype)[6:]}", _max_err(got, want), tol)
            if S == 1024 and dtype == bf16:
                again = flash_attention(q, k, v, causal=True, scale=mla_scale)
                repeat["flash_attention_mla"] = torch.equal(got, again)
    lens = _mla_lengths()
    lens[3] = 0
    for dtype, tol in ((f32, 2e-5), (bf16, 3e-2)):
        pool = _cuda_randn(gen, (2048, 16, 27, 576), dtype)
        kv = pool[:, :, 5, None]
        tbl = _unique_tables(gen, 8, 128, 2048, [-(-n // 16) for n in lens])
        ln = torch.tensor(lens, dtype=torch.int32, device="cuda")
        q = _cuda_randn(gen, (8, 16, 576), dtype)
        got = paged_attention(q, kv, kv[..., :512], tbl, ln, scale=mla_scale)
        torch.cuda.synchronize()
        want = paged_attention_ref(q, kv, kv[..., :512], tbl, ln, scale=mla_scale)
        record("paged_attention", f"mla_latent_{str(dtype)[6:]}", _max_err(got, want), tol)
        check(bool((got[3] == 0).all()), "paged latent call: idle slot not 0")
        if dtype == bf16:
            again = paged_attention(q, kv, kv[..., :512], tbl, ln, scale=mla_scale)
            repeat["paged_attention_mla"] = torch.equal(got, again)
        del pool, kv

    # the redesigned kernels repeat to the bit at the paths' shapes
    # (stablelm-1.6b: 32 heads of 64; olmoe-1b-7b: 16 heads of 128;
    # stablelm-3b: 32 heads of 80)
    for label, H, D in (("", 32, 64), ("_olmoe", 16, 128), ("_stablelm3b", 32, 80)):
        q, k, v = (_cuda_randn(gen, (1, 1024, H, D), bf16) for _ in range(3))
        repeat["flash_attention" + label] = torch.equal(
            flash_attention(q, k, v), flash_attention(q, k, v)
        )
        pool = _cuda_randn(gen, (2048, 16, 2, 2, H, D), bf16)
        kp, vp = pool[:, :, 1, 0], pool[:, :, 1, 1]
        lens = [585, 1061, 0, 700, 1024, 128, 845, 990]
        tbl = _unique_tables(gen, 8, 128, 2048, [-(-n // 16) for n in lens])
        ln = torch.tensor(lens, dtype=torch.int32, device="cuda")
        q = _cuda_randn(gen, (8, H, D), bf16)
        repeat["paged_attention" + label] = torch.equal(
            paged_attention(q, kp, vp, tbl, ln), paged_attention(q, kp, vp, tbl, ln)
        )
        del pool, kp, vp
    _paged_window_checks(gen, record, repeat)
    _paged_cross_checks(gen, record, repeat)
    _paged_cache_checks(gen, record, repeat)
    check(all(repeat.values()), f"a kernel's second call differs from its first: {repeat}")
    emit("llm_kernels", cases=rows, max_abs_err=worst, repeats_bit_for_bit=repeat)
    return worst


def _paged_cross_checks(gen, record, repeat) -> None:
    """The paged kernel over whisper-base's cross buffer as the engine keeps
    it (``CrossKV``: 8 slots x 94 blocks of 16 rows, 6 layers of K and V at
    8 x 64, a layer's strided view, lengths 1500 with the last block part
    full), float32 and bf16, and two bf16 calls bit for bit."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels.paged_attention.ops import paged_attention
    from repro_torch.kernels.paged_attention.ref import paged_attention_ref
    from repro_torch.models.attention import CrossKV

    cfg = get_config("whisper-base")
    for dtype, tol in ((torch.float32, 2e-5), (torch.bfloat16, 3e-2)):
        cross = CrossKV.empty(cfg, 8, 16, dtype=dtype, device="cuda")
        check(tuple(cross.block_table.shape) == (8, 94), "whisper's cross table")
        cross.kv.copy_(_cuda_randn(gen, tuple(cross.kv.shape), dtype))
        kv = cross.kv[:, :, 3]
        args = (kv[:, :, 0], kv[:, :, 1], cross.block_table, cross.lengths)
        q = _cuda_randn(gen, (8, 8, 64), dtype)
        got = paged_attention(q, *args)
        torch.cuda.synchronize()
        err = _max_err(got, paged_attention_ref(q, *args))
        record("paged_attention", f"whisper_cross_94_blocks_{str(dtype)[6:]}", err, tol)
        if dtype == torch.bfloat16:
            repeat["paged_attention_whisper_cross"] = torch.equal(got, paged_attention(q, *args))
        del cross, kv, args, q, got


def _paged_cache_checks(gen, record, repeat) -> None:
    """The paged kernel over contiguous caches read as consecutive blocks
    (``attention.CacheView``), float32 and bf16, each with its
    log-sum-exp (``return_lse``, what the sharded decode merges ranks by)
    against the plain version's: stablelm's layer view ``[B, T, 32, 64]``
    of an all-layer cache at lengths T, a part and 0; h2o-danube's
    4096-slot rolling buffer (8 x 80, window 4096); MLA's latent rows of
    576 at decode_32k's length in blocks of 32 (1024 blocks, the most the
    bf16 latent call stages) and at 4112 slots in blocks of 16.  lse
    within 1e-5 (float32) and 4e-3 (bf16: the latent kernel sums P rounded
    to bf16, at most 2^-8 of the sum, log(1 + 2^-8) = 3.9e-3) absolute,
    -inf for an empty row; two bf16 calls bit for bit."""
    import torch

    from repro_torch.kernels.paged_attention.ops import paged_attention
    from repro_torch.kernels.paged_attention.ref import paged_attention_ref
    from repro_torch.models.attention import CacheView

    cases = [  # (name, B, T, H, G, D, latent, lengths, window, layers)
        ("stablelm_cache_3x4128", 3, 4128, 32, 32, 64, False, [4128, 517, 0], 0, 4),
        ("h2o_ring_1x4096", 1, 4096, 32, 8, 80, False, [4096], 4096, 1),
        ("mla_cache_2x32768_bs32", 2, 32768, 16, 1, 576, True, [32768, 20000], 0, 1),
        ("mla_cache_3x4112", 3, 4112, 16, 1, 576, True, [4112, 4097, 0], 0, 1),
    ]
    for name, B, T, H, G, D, latent, lens, window, layers in cases:
        for dtype, tol, lse_tol in ((torch.float32, 2e-5, 1e-5), (torch.bfloat16, 3e-2, 4e-3)):
            shape = (layers, B, T, D) if latent else (layers, 2, B, T, G, D)
            cache = _cuda_randn(gen, shape, dtype)
            pos = torch.tensor(lens, device="cuda") - 1
            view = CacheView.make(pos, T, latent=latent)
            if latent:
                kp = view.pool(cache[layers // 2])[:, :, None]
                vp = kp[..., :512]
                scale = 192**-0.5
            else:
                kp, vp = view.pool(cache[layers // 2, 0]), view.pool(cache[layers // 2, 1])
                scale = None
            q = _cuda_randn(gen, (B, H, D), dtype)
            args = (q, kp, vp, view.block_table, view.lengths)
            kw = dict(scale=scale, window=window, return_lse=True)
            got, lse = paged_attention(*args, **kw)
            torch.cuda.synchronize()
            want, want_lse = paged_attention_ref(*args, **kw)
            tag = f"{name}_{str(dtype)[6:]}"
            record("paged_attention", tag, _max_err(got, want), tol)
            fin = torch.isfinite(want_lse)
            check(torch.equal(fin, torch.isfinite(lse)), f"paged {tag}: lse -inf where no row")
            lse_err = _max_err(lse[fin], want_lse[fin])
            record("paged_attention", tag + "_lse", lse_err, lse_tol)
            if dtype == torch.bfloat16:
                again = paged_attention(*args, **kw)
                repeat["paged_attention_" + name] = torch.equal(got, again[0]) and torch.equal(
                    lse, again[1]
                )
            del cache, kp, vp, q, got, want


#: lengths against a window of 4096 over 256-token splits (16 blocks of 16):
#: the start inside split 16 (16 dead splits before it), on a split boundary
#: (17 dead), inside split 19 (more than 16), inside split 0, short of the
#: window, and an idle slot
WINDOW_LENS = (8224, 8448, 9000, 4097, 100, 0)


def _window_lengths() -> list:
    """h2o-danube-1.8b's WINDOW mix at mid-decode: its 8 prompts' lengths
    plus 16 (``launch.serve.WINDOW``, seed 0, as its serving run draws them)."""
    from repro_torch.configs import get_config
    from repro_torch.launch import serve

    spec = serve.WINDOW
    prompts = serve.make_prompts(get_config("h2o-danube-1.8b"), spec, seed=0)
    return [len(p) + spec.max_new_tokens // 2 for p in prompts]


def _paged_window_checks(gen, record, repeat) -> None:
    """Paged attention with a sliding window against its plain version: at
    1, 4 and 8 query heads a group and D = 64, 80, 128, bf16 and float32,
    windows of 1, 16 (a block), 1000 (no block multiple) and 4096 over
    ``WINDOW_LENS``, each call one split and one merge launch and repeated
    bit for bit; windows equal to a length and past it change no bit; at
    h2o-danube's decode shape (8 slots, 32 heads over 8 groups at 80, a
    layer's views of its 24-layer pool, a 520-block table) at the WINDOW
    mix's mid-decode lengths, one slot idle, where the windowed output must
    differ from the unwindowed one (the mask is live)."""
    import torch

    from repro_torch.kernels import LAUNCHES
    from repro_torch.kernels.paged_attention.ops import paged_attention
    from repro_torch.kernels.paged_attention.ref import paged_attention_ref

    f32, bf16 = torch.float32, torch.bfloat16
    bs, mb, G = 16, 600, 2
    used = [-(-n // bs) for n in WINDOW_LENS]
    NB = sum(used) + 7
    ln = torch.tensor(WINDOW_LENS, dtype=torch.int32, device="cuda")
    tbl = _unique_tables(gen, len(WINDOW_LENS), mb, NB, used)
    for D in (64, 80, 128):
        for dtype, tol in ((f32, 2e-5), (bf16, 3e-2)):
            kp, vp = (_cuda_randn(gen, (NB, bs, G, D), dtype) for _ in range(2))
            for m in (1, 4, 8):
                q = _cuda_randn(gen, (len(WINDOW_LENS), G * m, D), dtype)
                plain = paged_attention(q, kp, vp, tbl, ln)
                for window in (1, 16, 1000, 4096):
                    before = LAUNCHES["paged_attention"], LAUNCHES["paged_attention_merge"]
                    got = paged_attention(q, kp, vp, tbl, ln, window=window)
                    torch.cuda.synchronize()
                    after = LAUNCHES["paged_attention"], LAUNCHES["paged_attention_merge"]
                    check(after == (before[0] + 1, before[1] + 1), f"window launches {after}")
                    want = paged_attention_ref(q, kp, vp, tbl, ln, window=window)
                    case = f"window{window}_d{D}_heads{m}_{str(dtype)[6:]}"
                    record("paged_attention", case, _max_err(got, want), tol)
                    check(bool((got[-1] == 0).all()), f"paged {case}: idle slot not 0")
                    again = paged_attention(q, kp, vp, tbl, ln, window=window)
                    repeat[f"paged_attention_{case}"] = torch.equal(got, again)
                # a window at or past every length is no window
                past = paged_attention(q, kp, vp, tbl, ln, window=max(WINDOW_LENS))
                check(torch.equal(past, plain), f"paged d{D} heads{m}: a window past the lengths")
                at = paged_attention(q, kp, vp, tbl, ln, window=WINDOW_LENS[3])
                check(torch.equal(at[3:], plain[3:]), f"paged d{D} heads{m}: window = length")
            del kp, vp

    lens = _window_lengths()
    lens[3] = 0
    NB = 4224
    used = [-(-n // bs) for n in lens]
    tbl = _unique_tables(gen, 8, 520, NB, used)
    ln = torch.tensor(lens, dtype=torch.int32, device="cuda")
    for dtype, tol in ((f32, 2e-5), (bf16, 3e-2)):
        pool = _cuda_randn(gen, (NB, bs, 24, 2, 8, 80), dtype)
        kp, vp = pool[:, :, 5, 0], pool[:, :, 5, 1]
        q = _cuda_randn(gen, (8, 32, 80), dtype)
        got = paged_attention(q, kp, vp, tbl, ln, window=4096)
        torch.cuda.synchronize()
        want = paged_attention_ref(q, kp, vp, tbl, ln, window=4096)
        case = f"h2o_8x32x8x80_pool_view_window4096_{str(dtype)[6:]}"
        record("paged_attention", case, _max_err(got, want), tol)
        check(bool((got[3] == 0).all()), f"paged {case}: idle slot not 0")
        unwindowed = paged_attention(q, kp, vp, tbl, ln)
        live = [b for b, n in enumerate(lens) if n >= 2 * 4096]  # half the rows masked
        check(
            all(_max_err(got[b], unwindowed[b]) > 1e-3 for b in live),
            f"paged {case}: the window changed nothing past it",
        )
        if dtype == bf16:
            repeat["paged_attention_h2o_window"] = torch.equal(
                got, paged_attention(q, kp, vp, tbl, ln, window=4096)
            )
        del pool, kp, vp


#: largest float64 logit gap between two experts that a float32 product of the
#: ``moe_whitening`` inputs may reorder: 64 terms of magnitude up to ~10 and a
#: sum up to ~37, each rounding off at most half a step of 3.8e-6
MOE_NEAR_TIE = 64 * 3.8e-6


def phase_moe_whitening() -> dict:
    """The paper's MoE-whitening check on the card: the reference benchmark's
    inputs (``benchmarks/paper_figures.py::moe_whitening``) through the
    port's ``route`` in float32, with the fractal slot permutation on and
    off.  The benchmark's two asserts must hold, its two numbers must equal
    ``moe_reference.json``, and every (b, s, k) expert choice and slot is
    held to the capture's: each that differs is counted and printed, and
    passes only where the two experts' float64 logits lie within
    ``MOE_NEAR_TIE`` (a near-tie that float32 rounding may order either way)."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.data import (
        MOE_WHITENING_CAPACITY_FACTOR,
        moe_reference,
        moe_whitening_inputs,
        moe_whitening_record,
        unpack_decisions,
    )
    from repro_torch.models.moe import expert_capacity, route

    check(not torch.backends.cuda.matmul.allow_tf32, "float32 matmuls must not round to TF32")
    cfg = dataclasses.replace(
        get_config("olmoe-1b-7b"), moe_capacity_factor=MOE_WHITENING_CAPACITY_FACTOR
    )
    x, router = moe_whitening_inputs()
    logits64 = x.astype(np.float64) @ router.astype(np.float64)
    capture = moe_reference()
    C = expert_capacity(cfg, x.shape[1])
    check(C == capture["capacity"], f"capacity {C}, the capture's {capture['capacity']}")
    xt, rt = torch.from_numpy(x).cuda(), torch.from_numpy(router).cuda()
    out = {}
    for name, whiten in (("fractal", True), ("tail_drop", False)):
        t0 = time.perf_counter()
        _, top_e, slot, _ = route(cfg, xt, rt, whiten=whiten)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        top_e, slot = top_e.cpu().numpy(), slot.cpu().numpy()
        rec = moe_whitening_record(top_e, slot, C)
        want = capture[name]
        want_e = unpack_decisions(want["top_e"])
        differ = np.argwhere(top_e != want_e)
        gaps = [
            abs(logits64[b, t, top_e[b, t, k]] - logits64[b, t, want_e[b, t, k]])
            for b, t, k in differ
        ]
        out[name] = {
            "drop_rate": rec["drop_rate"],
            "fraction_of_drops_in_last_quarter": rec["fraction_of_drops_in_last_quarter"],
            "decisions": int(top_e.size),
            "decisions_differing": int(len(differ)),
            "slots_differing": int((slot != unpack_decisions(want["slot"])).sum()),
            "largest_logit_gap_of_a_differing_decision": max(gaps, default=None),
            "seconds": seconds,
        }
    emit("moe_whitening", capacity=C, source=capture["source"], **out)
    frac = {k: v["fraction_of_drops_in_last_quarter"] for k, v in out.items()}
    check(frac["fractal"] < 0.35, f"whitened drops not spread over the sequence: {frac}")
    check(frac["tail_drop"] > 0.4, f"tail-drop does not drop the tail: {frac}")
    for name, got in out.items():
        for key in ("drop_rate", "fraction_of_drops_in_last_quarter"):
            check(
                got[key] == capture[name][key],
                f"moe_whitening {name} {key}: {got[key]}, the capture's {capture[name][key]}",
            )
        gap = got["largest_logit_gap_of_a_differing_decision"]
        check(
            gap is None or gap <= MOE_NEAR_TIE,
            f"moe_whitening {name}: an expert choice differs from the capture's beyond a "
            f"near-tie (float64 logit gap {gap})",
        )
    return out


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
    """``model`` with every attention layer's ``wq`` and ``wk`` (MLA: ``wq`` and
    ``w_uk``, which makes K's non-RoPE part) scaled by 1/8 (exact in bf16):
    attention scores of std ~1, as in a trained model.  Under the
    reference's fan-in init they have std ~64 and the network is chaotic at
    any precision, so two paths that differ in the last bit of one sum give
    unrelated logits (PERF.md, Findings)."""
    import torch

    with torch.no_grad():
        for attn in _attention_modules(model):
            attn.wq.mul_(0.125)
            (attn.w_uk if model.cfg.use_mla else attn.wk).mul_(0.125)
    return model


def _attention_modules(model) -> list:
    """The stack's attention modules: one a layer, or one a super-block of a
    hybrid stack; whisper's encoder layers' and its decoder layers'
    cross-attention too."""
    if model.cfg.family == "hybrid":
        return [blk.attn.attn for blk in model.layers]
    mods = [blk.attn for blk in model.layers]
    if model.cfg.is_encoder_decoder:
        mods += [layer.attn for layer in model.encoder.layers]
        mods += [blk.cross for blk in model.layers]
    return mods


def _score_std(model, prompt) -> list:
    """Per prefill flash call, in call order, the std of its attention scores
    (scaled; causal entries of a causal call, every entry of another; the
    first 256 query rows) of one prompt, read at the call's inputs (whisper:
    over zero frames, as its engine encodes them: the encoder's layers, then
    each decoder layer's self- and cross-attention); its launches are not
    the main path's."""
    import torch

    from repro_torch.models import attention
    from repro_torch.models import model as M

    stds = []
    flash, paged = attention.ATTENTION["kernel"]

    def spy(q, k, v, *, causal=True, window=0, scale=None):
        G = k.shape[2]
        qg = q[:, :256].unflatten(2, (G, -1)).float()
        scale_ = scale if scale is not None else q.shape[-1] ** -0.5
        s = torch.einsum("bsgmd,btgd->bgmst", qg, k.float()) * scale_
        ok = torch.ones(s.shape[-2:], dtype=torch.bool, device=s.device)
        stds.append(float(s[..., ok.tril() if causal else ok].std()))
        return flash(q, k, v, causal=causal, window=window, scale=scale)

    cfg, kw = model.cfg, {}
    if cfg.is_encoder_decoder:
        kw["frames"] = torch.zeros((1, cfg.encoder_seq_len, cfg.d_model), device="cuda")
    attention.ATTENTION["kernel"] = (spy, paged)
    try:
        M.prefill(model, torch.as_tensor(prompt, device="cuda")[None], **kw)
    finally:
        attention.ATTENTION["kernel"] = (flash, paged)
    return stds


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


#: teacher-forcing bounds per architecture, bf16 and float32 kernel runs
#: against the plain attention path: (largest |Δlogit| over tokens, least
#: share of tokens whose argmax agrees); their reasons are in PERF.md.
#: olmoe-1b-7b's are set from its first full-width run on an H100 (bf16
#: 0.0352 and 97.7 %, float32 6.6e-6 and 100 %): about 3x and 15x the
#: measured gaps.  The dense configs' were written before their first run:
#: deepseek-7b and stablelm-3b are tempered as stablelm-1.6b is and take its
#: bounds; chameleon-34b, untempered (QK-norm), is 48 layers deep, three
#: times olmoe's depth, so its bf16 bound is the tempered paths' 0.5; its
#: float32 model (137 GB) does not fit the card, so it has no float32 run
FORCING_BOUNDS = {
    "stablelm-1.6b": {"bf16": (0.5, 0.9), "f32": (1e-2, 0.99)},
    "olmoe-1b-7b": {"bf16": (0.1, 0.9), "f32": (1e-4, 0.99)},
    "deepseek-v2-lite-16b": {"bf16": (0.5, 0.9)},
    "deepseek-7b": {"bf16": (0.5, 0.9), "f32": (1e-2, 0.99)},
    "chameleon-34b": {"bf16": (0.5, 0.9)},
    "stablelm-3b": {"bf16": (0.5, 0.9), "f32": (1e-2, 0.99)},
    # written before its first run: tempered as stablelm-1.6b and on both
    # mixes (the WINDOW mix's 8192-token prompts and decode past the window)
    "h2o-danube-1.8b": {"bf16": (0.5, 0.9), "f32": (1e-2, 0.99)},
    # written before its first run: tempered as stablelm-1.6b (no QK-norm),
    # one attention layer and 7 SSD layers a super-block, bf16 only (its
    # float32 weights, 103 GB, do not fit the card)
    "jamba-1.5-large-398b": {"bf16": (0.5, 0.9)},
    # written before its first run: tempered as stablelm-1.6b (every
    # attention's wq and wk: the encoder's, the decoder's self- and
    # cross-attention), 6 + 6 layers, 192 decode steps a request
    "whisper-base": {"bf16": (0.5, 0.9), "f32": (1e-2, 0.99)},
}
#: jamba-1.5-large-398b's serving cut on one card, stated before its first
#: run: 8 of its 72 layers (one super-block) and 8 of its 16 experts, top-2
#: kept, every width the published one: 25.82 B parameters, 51.6 GB of bf16
#: weights (one super-block with all 16 experts is 90.3 GB, over the card)
HYBRID_SERVE_LAYERS, HYBRID_SERVE_EXPERTS = 8, 8
#: mamba2-1.3b's two forms of one function on the card (float32): the
#: chunked prefill of 8 prompts of 512 tokens (two 256-token chunks) and 512
#: recurrent decode steps from a zero state, held to each other as the
#: largest abs difference over the largest abs entry of the final SSM state,
#: of the conv window and of the last logits (stated before the first run:
#: float32 summation orders through 48 layers, ~1e-5 expected)
SSM_FORMS_BOUND = 1e-2
#: the two forms' depth, a cut: 12 of mamba2's 48 layers.  Its 512
#: recurrent steps through 48 layers took 26.7 s of the script, which the
#: hybrid stack's phases pushed past the 1050 s aim; every piece
#: of the check (two chunks, the state carried between them, the conv
#: window, the tied logits) runs at any depth
SSM_FORMS_LAYERS = 12
#: deepseek-v2-lite-16b's plain absorbed decode against the plain
#: non-absorbed one (the reference's two forms of one function), teacher
#: forced, bf16: the same bounds as the kernel path against the plain one
MLA_FORMS_BOUND = FORCING_BOUNDS["deepseek-v2-lite-16b"]["bf16"]
#: least share of routing decisions (layer, token, k) on which the MoE
#: path's teacher-forced plain run agrees with its kernel run (measured in
#: that run: bf16 95.7 %, float32 99.9995 %; bf16 attention's rounding
#: moves bf16 router logits, which tie often, across a top-8 edge)
ROUTE_AGREEMENT = {"bf16": 0.9, "f32": 0.999}


def _decode_form(absorbed: bool):
    """A wrapper of ``models.model.decode_step`` that decodes MLA in the
    given form (the engine asks for the absorbed one); GQA ignores it."""

    def wrap(inner):
        def run(*args, **kwargs):
            kwargs["mla_absorbed"] = absorbed
            return inner(*args, **kwargs)

        return run

    return wrap


@contextlib.contextmanager
def _routes_logged():
    """While active, the expert choices ``top_e`` of every ``moe.route``
    call, in call order (one call per MoE layer per prefill or decode step)."""
    from repro_torch.models import moe

    log = []

    def wrap(inner):
        def run(*args, **kwargs):
            out = inner(*args, **kwargs)
            log.append(out[1].clone())
            return out

        return run

    with _patched(moe, "route", wrap):
        yield log


def _route_agreement(kernel: list, plain: list) -> dict:
    """How many routing decisions (layer, token, k) of the teacher-forced
    plain run equal the kernel run's on the same calls (the plain run's
    calls are the first of the kernel run's); and the share of tokens that
    picked the same experts in any order (a swap of two near-equal weights
    moves an expert between positions k without changing the output)."""
    check(len(kernel) >= len(plain) > 0, f"route calls: {len(kernel)} vs {len(plain)}")
    same = total = same_sets = tokens = 0
    first = None
    for n, (a, b) in enumerate(zip(kernel, plain)):
        check(a.shape == b.shape, f"route call {n}: {tuple(a.shape)} vs {tuple(b.shape)}")
        eq = int((a == b).sum())
        same, total = same + eq, total + b.numel()
        if first is None and eq < b.numel():
            first = n
        sets = (a.sort(-1).values == b.sort(-1).values).all(-1)
        same_sets, tokens = same_sets + int(sets.sum()), tokens + sets.numel()
    return {
        "calls": len(plain),
        "decisions": total,
        "decisions_differing": total - same,
        "agreement": same / total,
        "tokens_with_the_same_experts": same_sets / tokens,
        "first_differing_call": first,
    }


def phase_serving() -> dict:
    """The serving main path, stablelm-1.6b at full width (``wq``/``wk``
    tempered, see ``_tempered``)."""
    return _serving_path("stablelm-1.6b", "serving", temper=True)


def phase_serving_moe() -> dict:
    """The MoE serving path: olmoe-1b-7b at full width, untempered (its
    QK-norm keeps the attention scores of unit scale), with the routing
    decisions of the kernel and teacher-forced runs compared."""
    return _serving_path("olmoe-1b-7b", "serving_moe", temper=False)


def phase_serving_mla() -> dict:
    """The MLA serving path: deepseek-v2-lite-16b at full width (27 layers,
    16.2 B parameters), ``wq``/``w_uk`` tempered, decoding in the absorbed
    form over the pool's latent rows; teacher forced in bf16 only (float32
    weights, 64.8 GB beside the bf16 model's 32.4 GB, do not fit the card),
    with the plain absorbed and non-absorbed forms also held to each other."""
    return _serving_path("deepseek-v2-lite-16b", "serving_mla", temper=True, f32_forcing=False)


def phase_serving_dense7b() -> dict:
    """deepseek-7b at full width (30 layers, d 4096, 32 heads of 128, MHA,
    6.91 B parameters, 13.8 GB of bf16 weights; a 245760-wide pool row),
    ``wq``/``wk`` tempered; teacher forced in bf16 and float32 (the float32
    model, 27.6 GB, and its float32 pool, 32.2 GB, fit beside the bf16 one)."""
    return _serving_path("deepseek-7b", "serving_dense7b", temper=True)


def phase_serving_vlm() -> dict:
    """chameleon-34b at full width (family vlm: 48 layers, d 8192, GQA 64:8 at
    128 with QK-norm, 34.29 B parameters, 68.6 GB of bf16 weights beside a
    6.44 GB pool), untempered as olmoe is (QK-norm keeps the scores of unit
    scale); teacher forced in bf16 only (its float32 weights, 137 GB, do
    not fit the card)."""
    return _serving_path("chameleon-34b", "serving_vlm", temper=False, f32_forcing=False)


def phase_serving_3b() -> dict:
    """stablelm-3b at full width (32 layers, d 2560, 32 heads of 80: every
    attention kernel at D = 80; 2.80 B parameters; a 163840-wide pool row),
    ``wq``/``wk`` tempered; teacher forced in bf16 and float32."""
    return _serving_path("stablelm-3b", "serving_3b", temper=True)


def phase_serving_swa_ssm(llm_errs: dict) -> list:
    """``serving_swa`` with its profile (the WINDOW run's decode) and timing
    rows 3w and 4w, then ``serving_ssm`` with its profile, each printing its
    seconds; returns the kernels-line rows."""
    import torch

    t0 = time.perf_counter()
    full, window = phase_serving_swa()
    phase_serving_profile(window)
    rows = _swa_timing(window, llm_errs)
    emit("serving_swa_seconds", seconds=time.perf_counter() - t0)
    del full, window
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    serving = phase_serving_ssm()
    phase_serving_profile(serving)
    emit("serving_ssm_seconds", seconds=time.perf_counter() - t0)
    del serving
    torch.cuda.empty_cache()
    return rows


def phase_serving_swa() -> tuple:
    """h2o-danube-1.8b at full width (d 2560, GQA 32:8 at 80, a 4096-token
    sliding window) and ``SWA_SERVE_LAYERS`` of its 24 layers, ``wq``/``wk``
    tempered, on the FULL mix (contexts of at most 1056 tokens: the window
    never masks) and on the WINDOW mix (prompts of 8192 tokens, twice the
    window, and of 4065..4096, whose decode crosses position 4096), each
    with the checks of ``_serving_path`` (launches, isolation every step,
    the KV record, teacher forcing in bf16 and float32).  Returns both
    runs' results (``(full, window)``)."""
    from repro_torch.configs import get_config
    from repro_torch.launch import serve

    arch = "h2o-danube-1.8b"
    cfg = serve.cut(get_config(arch), layers=SWA_SERVE_LAYERS)
    full = _serving_path(arch, "serving_swa", temper=True, cfg=cfg)
    window = _serving_path(
        arch, "serving_swa_window", temper=True, mix="WINDOW", model=full["model"], cfg=cfg
    )
    del full["model"]
    return full, window


def phase_serving_ssm() -> dict:
    """mamba2-1.3b at full width and depth (48 SSM layers, d 2048, 64 SSD
    heads of 64 with a 128-wide state, tied embeddings, 1.34 B parameters)
    on the FULL_SSD mix: the pool allocates and frees blocks as the
    reference's engine does (its KV access record held to a traffic-only
    engine's), isolation every step, no attention or ``banked_copy``
    launch, each slot's SSM state and conv window beside the pool.  Then
    the two forms on the card in float32 (``SSM_FORMS_BOUND``) at
    ``SSM_FORMS_LAYERS`` of its 48 layers: 8 prompts of 512 tokens through
    the chunked prefill at B = 8 and through 512 recurrent decode steps from
    a zero state."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.launch import serve
    from repro_torch.models import model as M
    from repro_torch.serving.record import KVAccessRecorder

    cfg, spec = get_config("mamba2-1.3b"), serve.FULL_SSD
    t0 = time.perf_counter()
    model = M.init_params(cfg, 0)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    prompts = serve.make_prompts(cfg, spec, seed=0)
    serve.check_mix(cfg, spec, prompts)
    plan_rec = KVAccessRecorder()
    plan, _ = serve.new_engine(None, None, spec, prompts, recorder=plan_rec)
    plan.run()
    recorder = KVAccessRecorder()
    eng, reqs = serve.new_engine(cfg, model, spec, prompts, recorder=recorder)
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    while eng.queue or any(r is not None for r in eng.slot_req):
        eng.step()
        check(eng.pool.check_isolation(), f"pool isolation broken at step {eng.steps}")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(LAUNCHES)
    summary = serve.summarize(eng, reqs, wall)
    check(sum(launches.values()) == 0, f"the SSM path launched kernels: {launches}")
    check(eng.kv is None, "the SSM engine allocated a KV store")
    check(eng.steps == plan.steps, f"{eng.steps} engine steps, traffic-only run took {plan.steps}")
    check(
        recorder.record.events_key() == plan_rec.record.events_key(),
        "the SSM run's KV access record differs from the traffic-only engine's",
    )
    check(
        all(r.done and len(r.out_tokens) == spec.max_new_tokens for r in reqs),
        "a request did not finish with its token count",
    )
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    state_bytes = eng.ssm.nbytes()
    del eng
    forms = _ssm_two_forms(replace(cfg, num_layers=SSM_FORMS_LAYERS))
    emit(
        "serving_ssm",
        arch=cfg.name,
        mix="FULL_SSD",
        params=cfg.num_params(),
        init_s=init_s,
        **{k: summary[k] for k in ("requests", "done", "out_tokens", "steps", "wall_s")},
        prompt_lengths=[len(p) for p in prompts],
        prompt_tokens=summary["stats"]["prefill_tokens"],
        prefill_tokens_per_s=summary["prefill_tokens_per_s"],
        decode_ms_per_step=summary["decode_ms_per_step"],
        out_tokens_per_s=summary["out_tokens_per_s"],
        pool_imbalance=summary["pool_imbalance"],
        peak_memory_gb=peak_gb,
        ssm_state_mb_per_slot=state_bytes / spec.max_batch / 1e6,
        ssm_state_mb=state_bytes / 1e6,
        launches=launches,
        stats=summary["stats"],
        two_forms=forms,
        kv_access_record=recorder.record.summary(),
    )
    return dict(
        model=model,
        spec=spec,
        prompts=prompts,
        launches=launches,
        decode_ms_per_step=summary["decode_ms_per_step"],
        phase="serving_ssm",
    )


def _ssm_two_forms(cfg) -> dict:
    """The chunked prefill and the recurrence of one float32 model on the
    same 8 prompts of 512 tokens: final SSM state, conv window and last
    logits held to each other within ``SSM_FORMS_BOUND`` (relative to the
    largest entry)."""
    import torch

    from repro_torch.models import model as M

    model = M.init_params(cfg, 0, compute_dtype=torch.float32, kv_dtype=torch.float32)
    gen = torch.Generator(device="cuda").manual_seed(512)
    tokens = torch.randint(0, cfg.vocab_size, (8, 512), generator=gen, device="cuda")
    chunked = model.init_ssm_cache(8)
    t0 = time.perf_counter()
    want = M.prefill(model, tokens, ssm_out=chunked)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    rec = model.init_ssm_cache(8)
    pos = torch.zeros(8, dtype=torch.int64, device="cuda")
    t0 = time.perf_counter()
    for i in range(512):
        got = M.decode_step(model, tokens[:, i : i + 1], pos + i, rec)
    torch.cuda.synchronize()
    decode_s = time.perf_counter() - t0
    out = {
        "prompts": 8,
        "tokens": 512,
        "layers": cfg.num_layers,
        "chunk": cfg.ssm_chunk,
        "state_rel_err": _rel_err(rec.ssm, chunked.ssm),
        "conv_rel_err": _rel_err(rec.conv, chunked.conv),
        "logits_rel_err": _rel_err(got, want),
        "logits_max_abs_err": _max_err(got, want),
        "bound": SSM_FORMS_BOUND,
        "prefill_s": prefill_s,
        "recurrent_s": decode_s,
    }
    del model, chunked, rec
    torch.cuda.empty_cache()
    for key in ("state_rel_err", "conv_rel_err", "logits_rel_err"):
        check(out[key] <= SSM_FORMS_BOUND, f"mamba2's two forms differ: {out}")
    return out


def phase_serving_hybrid(llm_errs: dict) -> list:
    """jamba-1.5-large-398b at the serving cut (``HYBRID_SERVE_LAYERS`` of 72
    layers, one super-block: an attention layer of 64 query heads over 8 KV
    groups at 128 and 7 SSD layers of 256 heads, state 128; a dense FFN at
    even positions and ``HYBRID_SERVE_EXPERTS`` of 16 experts, top-2, at
    odd ones; every width the published one) on the FULL_SSD mix, with the
    checks of ``_serving_path``: launches (flash and ``banked_copy`` once an
    admission, paged split and merge once a decode step: one attention
    layer), isolation every step, the KV record, teacher forcing in bf16
    (``wq``/``wk`` tempered); each slot's SSM state beside the pool.  Then
    its decode profile and the timing rows of its kernels (flash at S 1024,
    row 4c's shape; paged, row 3c's; ``banked_copy`` at W = 2048, row 2j).
    Prints its seconds; returns the kernels-line rows."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.launch import serve

    t0 = time.perf_counter()
    arch = "jamba-1.5-large-398b"
    cfg = serve.cut(get_config(arch), layers=HYBRID_SERVE_LAYERS, experts=HYBRID_SERVE_EXPERTS)
    serving = _serving_path(
        arch, "serving_hybrid", temper=True, f32_forcing=False, mix="FULL_SSD", cfg=cfg
    )
    phase_serving_profile(serving)
    rows = phase_llm_timing(serving, llm_errs, flash_lengths=(1024,))
    emit("serving_hybrid_seconds", seconds=time.perf_counter() - t0)
    del serving
    torch.cuda.empty_cache()
    return rows


def phase_serving_whisper(llm_errs: dict) -> list:
    """whisper-base at full width and depth (6 encoder layers over 1500
    frames, 6 decoder layers with cross-attention, 8 heads of 64, 98.6 M
    parameters) on the SPEECH mix, with the checks of ``_serving_path``:
    launches (flash 6 encoder + 6 cross + 6 self and ``banked_copy`` once
    an admission; paged split and merge 6 self + 6 cross a decode step),
    isolation every step, the KV record, teacher forcing in bf16 and
    float32, each slot's cross K/V beside the pool.  ``wq``/``wk`` of every
    attention tempered, with the scores' std per flash call printed before
    and after.  Then its decode profile, the timing rows of the decoder's
    paged self-attention (3e) and ``banked_copy`` at W = 6144 (2e), and
    ``_whisper_timing``'s.  Prints its seconds; returns the kernels-line
    rows."""
    import torch

    t0 = time.perf_counter()
    serving = _serving_path("whisper-base", "serving_whisper", temper=True, mix="SPEECH")
    phase_serving_profile(serving)
    bs = serving["spec"].block_size
    nblk = max(-(-len(p) // bs) for p in serving["prompts"])
    rows = phase_llm_timing(serving, llm_errs, flash_lengths=(), copy_blocks=nblk)
    rows += _whisper_timing(serving, llm_errs)
    emit("serving_whisper_seconds", seconds=time.perf_counter() - t0)
    del serving
    torch.cuda.empty_cache()
    return rows


#: ``serving_cache``'s cuts, stated before its first run: decode_32k's batch
#: of 128 cut to 8 (its K/V at 32768 tokens, 51.5 GB of bf16, is what one
#: card holds beside the model), deepseek-v2-lite-16b to 4 of its 27 layers
#: (every width the published one; the absorbed decode is the same call in
#: every layer); stablelm-1.6b and h2o-danube-1.8b at full depth
CACHE_32K_B = 8
CACHE_MLA_LAYERS = 4
#: h2o-danube-1.8b's long_500k decode: positions 520,160 .. 520,223, slots
#: 4064 .. 4095 then 0 .. 31 of its 4096-slot rolling buffer; at 12 of its 24
#: layers, as ``serving_swa`` (a cut of the script's time: the phase took
#: 44.8 s with all 24 on an H100, where it aimed at 25)
CACHE_LONG_POS, CACHE_LONG_STEPS = 520_160, 64
CACHE_LONG_LAYERS = 12
#: the first step's logits, kernel against plain from the same cache: two
#: bf16 steps at |logit| 4-8 (measured 0.0 at 12 layers, 0.031 at 24)
CACHE_LONG_FIRST_BOUND = 0.0625


def _cache_row(name, path, fns, iters, nbytes, ops, launches, err, library, shape):
    """A timing row of the paged kernel over a contiguous cache view."""
    return _timing_row(
        "paged_attention", fns, iters, nbytes, ops, launches, err, library, shape=shape,
        path=path, queued=True,
    )


def _cache_run(model, tokens, cache, steps: int, pos0, *, absorbed=False, prefill=True,
               fresh=False):
    """The cache form on ``model``: the prompt ``tokens [B, S]`` prefilled
    into ``cache`` (``prefill``; else ``cache`` is already filled up to
    ``pos0`` and ``tokens [B, 1]`` is the first token), then ``steps``
    greedy decode steps through the kernels, with the launch counts set to
    0 just before the run and read just after.  The plain attention
    (``impl="ref"``) is held to it: teacher-forced from a copy of the cache
    as it stood before the first step, each step fed the kernel run's
    token; or, ``fresh``, each step from a copy of the kernel run's cache
    as that step found it (one step's gap, where the stack's own dynamics
    would amplify a rounding step over many).  The plain steps launch no
    kernel.  Returns the logits gap (``_logits_gap``), the launches, the
    kernel run's final cache, its decode seconds a step (the plain steps
    between excluded) and its greedy tokens."""
    import torch

    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.models import model as M

    def plain_step(c, tok, pos):
        model.impl = "ref"
        try:
            return M.decode_step_cache(model, c, tok[:, None], pos, mla_absorbed=absorbed)[0]
        finally:
            model.impl = "kernel"

    torch.cuda.synchronize()
    reset_launches()
    B = tokens.shape[0]
    if prefill:
        logits, cache = M.prefill_cache(model, tokens, cache)
        tok = logits[:, -1].argmax(-1)
    else:
        tok = tokens[:, -1]
    plain = {k: v.clone() for k, v in cache.items()}
    pos = torch.as_tensor(pos0, device="cuda").long().expand(B).clone()
    got, want, greedy, kernel_s = {}, {}, [], 0.0
    for i in range(steps):
        if fresh:
            plain = {k: v.clone() for k, v in cache.items()}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, cache = M.decode_step_cache(
            model, cache, tok[:, None], pos + i, mla_absorbed=absorbed
        )
        torch.cuda.synchronize()
        kernel_s += time.perf_counter() - t0
        if fresh:
            ref = plain_step(plain, tok, pos + i)
            for b in range(B):
                want[(b, i)] = ref[b, 0]
        for b in range(B):
            got[(b, i)] = logits[b, 0]
        greedy.append(tok)
        tok = logits[:, 0].argmax(-1)
    launches = dict(LAUNCHES)
    if not fresh:
        for i in range(steps):
            ref = plain_step(plain, greedy[i], pos + i)
            for b in range(B):
                want[(b, i)] = ref[b, 0]
    return _logits_gap(got, want), launches, cache, kernel_s / steps, torch.stack(greedy, 1)


def _bf16_steps(got, want):
    """The largest gap of ``got`` to ``want``, element by element, in bf16
    steps of ``want``: ``|got - want| / (2**-7 |want| + 2**-8)`` (a bf16
    rounding step of the entry, and a floor for entries near 0), at most 1
    where the two differ only by their last rounding (a 0-d tensor)."""
    want = want.float()
    return ((got.float() - want).abs() / (want.abs() * 2**-7 + 2**-8)).max()


def _cache_layer_check(q, k, v, view, *, window=0, scale=None) -> float:
    """The paged kernel against its plain version on one layer's contiguous
    view at the path's shapes (bf16): within one bf16 step of each entry
    (``_bf16_steps``; the GQA route is float32 inside and rounds once, the
    latent call also rounds P to bf16 before P V, 0.33 of a step on an
    H100) and within the paged checks' 3e-2, the log-sum-exp within 4e-3."""
    from repro_torch.kernels.paged_attention.ops import paged_attention
    from repro_torch.kernels.paged_attention.ref import paged_attention_ref

    args = (q, k, v, view.block_table, view.lengths)
    got, lse = paged_attention(*args, window=window, scale=scale, return_lse=True)
    want, want_lse = paged_attention_ref(*args, window=window, scale=scale, return_lse=True)
    err, steps = _max_err(got, want), float(_bf16_steps(got, want))
    emit("paged_cache_layer_check", shape=list(k.shape), err=err, bf16_steps=steps)
    check(steps <= 1 and err <= 3e-2,
          f"paged over the contiguous cache: {err} ({steps} bf16 steps)")
    check(_max_err(lse, want_lse) <= 4e-3, "paged over the contiguous cache: lse")
    return err


def _cache_dense(errs) -> tuple:
    """stablelm-1.6b at full width and depth: the contiguous prefill of B 2 x
    4096 on the flash kernel, 32 decode steps on the paged kernel against
    the plain path, a row at that cache's shape; then one decode_32k step at
    32768 tokens, batch ``CACHE_32K_B``, timed, and its launch's row."""
    import torch
    import torch.nn.functional as F

    from repro_torch.configs import get_config
    from repro_torch.kernels.paged_attention.ops import paged_attention
    from repro_torch.kernels.paged_attention.ref import paged_attention_ref
    from repro_torch.models import model as M
    from repro_torch.models.attention import CacheView

    arch, S, steps = "stablelm-1.6b", 4096, 32
    cfg = get_config(arch)
    model = _tempered(M.init_params(cfg, 0))
    gen = torch.Generator(device="cuda").manual_seed(28)
    H, G, D, L = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim, cfg.num_layers
    tokens = torch.randint(0, cfg.vocab_size, (2, S), generator=gen, device="cuda")
    T = S + steps
    cache = M.init_cache(cfg, 2, T)
    gap, launches, cache, per_step, greedy = _cache_run(model, tokens, cache, steps, S)
    bound, agree = FORCING_BOUNDS[arch]["bf16"]
    check(gap["max"] <= bound and gap["argmax_agreement"] >= agree, f"{arch} cache decode {gap}")
    want = {"flash_attention": L, "paged_attention": L * steps, "paged_attention_merge": L * steps}
    check(all(launches[k] == n for k, n in want.items()), f"{arch} cache launches {launches}")
    view = CacheView.make(torch.full((2,), T - 1, device="cuda"), T)
    kp, vp = view.pool(cache["k"][0]), view.pool(cache["v"][0])
    q = _cuda_randn(gen, (2, H, D), torch.bfloat16)
    err = _cache_layer_check(q, kp, vp, view)
    out = {"prompt": [2, S], "steps": steps, "kernel_vs_plain": gap, "held": "teacher-forced",
           "launches": launches, "decode_ms_per_step": per_step * 1e3, "max_abs_err": err}
    emit("serving_cache", path=arch, **out)
    rows = []
    kt, vt = cache["k"][0].transpose(1, 2), cache["v"][0].transpose(1, 2)  # [B, G, T, D] views
    q4 = q[:, :, None]
    sdpa = lambda: F.scaled_dot_product_attention(q4, kt, vt)
    check(_max_err(sdpa()[:, :, 0], paged_attention_ref(q, kp, vp, view.block_table,
                                                         view.lengths)) <= 3e-2, "cache yardstick")
    args = (q, kp, vp, view.block_table, view.lengths)
    # what the merge's log-sum-exp output costs: the same call with and
    # without it, queued, in turns
    lse_ms = [
        queued_ms(lambda: paged_attention(*args, return_lse=lse), 200)
        for lse in (False, True, True, False)
    ]
    lse_us = [None if t is None else t * 1e3 for t in lse_ms]
    emit("paged_lse_cost", path=arch + "-cache", queued_us_without_with_with_without=lse_us)
    rows.append(_cache_row(
        arch + "-cache", arch + "-cache",
        {"kernel": lambda: paged_attention(*args), "plain": lambda: paged_attention_ref(*args),
         "library": sdpa},
        200, 2 * T * G * 2 * D * 2 + 2 * H * 2 * D * 2, 4 * D * H * 2 * T,
        launches["paged_attention"], err,
        "F.scaled_dot_product_attention on the contiguous K/V (a transposed view: no gather)",
        dict(B=2, T=T, H=H, G=G, D=D, block_size=view.block_size),
    ))
    del cache, kp, vp, kt, vt, q, args
    torch.cuda.empty_cache()

    row, out32 = _cache_decode_32k(model, gen)
    rows.append(row)
    del model
    # the 51.5 GB cache's blocks back to CUDA before anything small is
    # carved out of them (a live tensor there would pin the whole segment)
    torch.cuda.empty_cache()
    return rows, {**out, "decode_32k": out32}


def _cache_decode_32k(model, gen) -> tuple:
    """One decode_32k step of ``model`` (stablelm-1.6b) at the full context,
    batch ``CACHE_32K_B``: ms a step, device busy ms, tokens/s, the share of
    the K/V bound; the launch's row against SDPA on the same K/V."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.kernels.paged_attention.ops import paged_attention
    from repro_torch.kernels.paged_attention.ref import paged_attention_ref
    from repro_torch.models import model as M
    from repro_torch.models.attention import CacheView

    cfg = model.cfg
    arch = cfg.name
    H, G, D, L = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim, cfg.num_layers
    B, T = CACHE_32K_B, 32768
    c32 = {
        "k": _cuda_randn(gen, (L, B, T, G, D), torch.bfloat16),
        "v": _cuda_randn(gen, (L, B, T, G, D), torch.bfloat16),
        "pos": torch.arange(T, dtype=torch.int32, device="cuda").expand(L, B, T).contiguous(),
    }
    kv_bytes = 2 * L * B * T * G * D * 2
    tok = torch.randint(0, cfg.vocab_size, (B, 1), generator=gen, device="cuda")
    step = lambda: M.decode_step_cache(model, c32, tok, T - 1)
    torch.cuda.synchronize()
    reset_launches()
    step()
    torch.cuda.synchronize()
    launches32 = dict(LAUNCHES)
    check(launches32["paged_attention"] == L and launches32["paged_attention_merge"] == L,
          f"decode_32k launches {launches32}")
    ms = time_ms(step, 10, warmup=2)
    busy = device_ms(step, 3)
    bound_ms = kv_bytes / HBM_BYTES_PER_S * 1e3
    out32 = {"batch": B, "context": T, "kv_bytes": kv_bytes, "ms_per_step": ms,
             "tokens_per_s": B / ms * 1e3, "device_busy_ms_per_step": busy,
             "kv_bound_ms": bound_ms, "share_of_kv_bound": bound_ms / ms,
             "busy_share_of_kv_bound": None if busy is None else bound_ms / busy,
             "launches": launches32, "cut": f"decode_32k's batch 128 -> {B}"}
    emit("serving_cache_decode_32k", path=arch, **out32)
    view = CacheView.make(torch.full((B,), T - 1, device="cuda"), T)
    kp, vp = view.pool(c32["k"][0]), view.pool(c32["v"][0])
    q = _cuda_randn(gen, (B, H, D), torch.bfloat16)
    err = _cache_layer_check(q, kp, vp, view)
    kt, vt = c32["k"][0].transpose(1, 2), c32["v"][0].transpose(1, 2)
    q4 = q[:, :, None]
    args = (q, kp, vp, view.block_table, view.lengths)
    row = _cache_row(
        arch + "-decode_32k", arch + "-decode_32k",
        {"kernel": lambda: paged_attention(*args), "plain": lambda: paged_attention_ref(*args),
         "library": lambda: F.scaled_dot_product_attention(q4, kt, vt)},
        20, 2 * B * T * G * D * 2 + B * H * 2 * D * 2, 4 * D * H * B * T,
        launches32["paged_attention"], err,
        "F.scaled_dot_product_attention on the contiguous K/V (a transposed view: no gather)",
        dict(B=B, T=T, H=H, G=G, D=D, block_size=view.block_size),
    )
    return row, out32


def _cache_long(errs) -> tuple:
    """h2o-danube-1.8b's long_500k cell at full width, ``CACHE_LONG_LAYERS``
    of its 24 layers: batch 1,
    its 4096-slot rolling buffer (10.5 MB a layer) filled from a seeded
    generator as after position 520,159, then ``CACHE_LONG_STEPS`` decode
    steps across the buffer's wrap.  Each of the path's paged calls is held
    to its plain version on the same inputs within one bf16 step of each
    entry (``_bf16_steps``: the kernel is float32 inside and rounds once)
    and within the paged checks' 3e-2.
    Each step's logits are compared with the plain path's from the cache as
    that step found it: the first step's within ``CACHE_LONG_FIRST_BOUND``,
    the others reported, as over a random ring the stack amplifies one bf16
    step of an attention output into logit gaps up to 0.45 at 12 layers and
    1.2 at 24 (teacher-forced over the 64 steps: 2-4; 4 layers, or
    stablelm-1.6b's 24, stay within 0.2; the window on or off alike; PERF.md,
    §5).  A row at the buffer's shape."""
    import torch
    import torch.nn.functional as F

    from repro_torch.configs import get_config
    from repro_torch.kernels.paged_attention.ops import paged_attention
    from repro_torch.kernels.paged_attention.ref import paged_attention_ref
    from repro_torch.launch import serve
    from repro_torch.models import model as M
    from repro_torch.models.attention import ATTENTION, CacheView

    arch = "h2o-danube-1.8b"
    cfg = serve.cut(get_config(arch), layers=CACHE_LONG_LAYERS)
    model = _tempered(M.init_params(cfg, 0))
    gen = torch.Generator(device="cuda").manual_seed(500)
    H, G, D, L, w = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim, cfg.num_layers, \
        cfg.sliding_window
    T = M.cache_length(cfg, 524_288)
    check(T == w == 4096, f"{arch}'s long_500k cache: {T} slots")
    cache = M.init_cache(cfg, 1, T)
    cache["k"].copy_(_cuda_randn(gen, tuple(cache["k"].shape), torch.bfloat16))
    cache["v"].copy_(_cuda_randn(gen, tuple(cache["v"].shape), torch.bfloat16))
    last = CACHE_LONG_POS - 1
    slot = torch.arange(T, device="cuda")
    cache["pos"].copy_((last - (last - slot) % T).int().expand_as(cache["pos"]))
    tok = torch.randint(0, cfg.vocab_size, (1, 1), generator=gen, device="cuda")
    flash, paged = ATTENTION["kernel"]
    calls = []

    def held(*args, **kw):  # the kernel's call, and its plain version on the same inputs
        out = paged(*args, **kw)
        want = paged_attention_ref(*args, **kw).float()
        gap = (out.float() - want).abs().max()
        calls.append(torch.stack([gap, want.abs().max(), _bf16_steps(out, want)]))
        return out

    ATTENTION["kernel"] = (flash, held)
    try:
        gap, launches, cache, _, greedy = _cache_run(
            model, tok, cache, CACHE_LONG_STEPS, CACHE_LONG_POS, prefill=False, fresh=True
        )
    finally:
        ATTENTION["kernel"] = (flash, paged)
    diffs = torch.stack(calls)
    call_err, call_steps = float(diffs[:, 0].max()), float(diffs[:, 2].max())
    check(len(calls) == L * CACHE_LONG_STEPS and call_steps <= 1 and call_err <= 3e-2,
          f"{arch} long_500k: {len(calls)} paged calls, largest gap to plain {call_err} "
          f"({call_steps} bf16 steps)")
    check(math.isfinite(gap["max"]) and gap["first_token_max"] <= CACHE_LONG_FIRST_BOUND,
          f"{arch} long_500k logits {gap}")
    want = L * CACHE_LONG_STEPS
    check(launches["paged_attention"] == want == launches["paged_attention_merge"],
          f"{arch} long_500k launches {launches}")
    end = CACHE_LONG_POS + CACHE_LONG_STEPS - 1
    check(int(cache["pos"][0, 0].max()) == end, "the ring's newest position")
    view = CacheView.make(torch.full((1,), end, device="cuda"), T)
    kp, vp = view.pool(cache["k"][0]), view.pool(cache["v"][0])
    q = _cuda_randn(gen, (1, H, D), torch.bfloat16)
    err = _cache_layer_check(q, kp, vp, view, window=w)
    out = {"batch": 1, "positions": [CACHE_LONG_POS, end], "slots": T,
           "paged_calls_max_abs_err": call_err, "paged_calls_max_bf16_steps": call_steps,
           "paged_calls_largest_entry": float(diffs[:, 1].max()), "logits_kernel_vs_plain": gap,
           "held": "each step from the kernel run's cache", "launches": launches,
           "max_abs_err": err}
    emit("serving_cache_long_500k", path=arch, **out)
    kt = cache["k"][0].transpose(1, 2).repeat_interleave(H // G, dim=1)
    vt = cache["v"][0].transpose(1, 2).repeat_interleave(H // G, dim=1)
    q4 = q[:, :, None]
    args = (q, kp, vp, view.block_table, view.lengths)
    row = _cache_row(
        arch + "-long_500k", arch + "-long_500k",
        {"kernel": lambda: paged_attention(*args, window=w),
         "plain": lambda: paged_attention_ref(*args, window=w),
         "library": lambda: F.scaled_dot_product_attention(q4, kt, vt)},
        200, T * G * 2 * D * 2 + H * 2 * D * 2, 4 * D * H * T, launches["paged_attention"], err,
        "F.scaled_dot_product_attention on the ring's K/V (repeated per query head beforehand)",
        dict(B=1, T=T, H=H, G=G, D=D, block_size=view.block_size, window=w),
    )
    del cache, kp, vp, kt, vt, model
    torch.cuda.empty_cache()
    return [row], out


def _cache_mla(errs) -> tuple:
    """deepseek-v2-lite-16b at full width, ``CACHE_MLA_LAYERS`` layers: the
    contiguous prefill of B 2 x 4096 (flash at QK 192 / V 128), then 16
    absorbed decode steps on the latent call over the cache's 576-wide rows,
    kernel against plain; a row at that cache's shape."""
    import torch
    import torch.nn.functional as F

    from repro_torch.configs import get_config
    from repro_torch.kernels.paged_attention.ops import paged_attention
    from repro_torch.kernels.paged_attention.ref import paged_attention_ref
    from repro_torch.launch import serve
    from repro_torch.models import model as M
    from repro_torch.models.attention import CacheView

    arch, S, steps = "deepseek-v2-lite-16b", 4096, 16
    cfg = serve.cut(get_config(arch), layers=CACHE_MLA_LAYERS)
    model = _tempered(M.init_params(cfg, 0))
    gen = torch.Generator(device="cuda").manual_seed(16)
    tokens = torch.randint(0, cfg.vocab_size, (2, S), generator=gen, device="cuda")
    T = S + steps
    cache = M.init_cache(cfg, 2, T)
    gap, launches, cache, per_step, greedy = _cache_run(
        model, tokens, cache, steps, S, absorbed=True
    )
    bound, agree = FORCING_BOUNDS[arch]["bf16"]
    check(gap["max"] <= bound and gap["argmax_agreement"] >= agree, f"{arch} cache decode {gap}")
    L = cfg.num_layers
    want = {"flash_attention": L, "paged_attention": L * steps}
    check(all(launches[k] == n for k, n in want.items()), f"{arch} cache launches {launches}")
    view = CacheView.make(torch.full((2,), T - 1, device="cuda"), T, latent=True)
    kp = view.pool(cache["latent"][0])[:, :, None]
    vp = kp[..., : cfg.kv_lora_rank]
    H, Dk, Dv = cfg.num_heads, cfg.latent_dim, cfg.kv_lora_rank
    scale = (cfg.qk_nope_dim + cfg.qk_rope_dim) ** -0.5
    q = _cuda_randn(gen, (2, H, Dk), torch.bfloat16)
    err = _cache_layer_check(q, kp, vp, view, scale=scale)
    out = {"prompt": [2, S], "steps": steps, "layers": L, "kernel_vs_plain": gap,
           "held": "teacher-forced", "launches": launches, "decode_ms_per_step": per_step * 1e3,
           "max_abs_err": err, "cut": f"{CACHE_MLA_LAYERS} of 27 layers"}
    emit("serving_cache_mla", path=arch, **out)
    lat = cache["latent"][0][:, None]  # [B, 1, T, 576]: one latent head for the 16
    kt, vt = lat.expand(2, H, T, Dk), lat[..., :Dv].expand(2, H, T, Dv)
    q4 = q[:, :, None]
    args = (q, kp, vp, view.block_table, view.lengths)
    row = _cache_row(
        arch + "-cache", arch + "-cache",
        {"kernel": lambda: paged_attention(*args, scale=scale),
         "plain": lambda: paged_attention_ref(*args, scale=scale),
         "library": lambda: F.scaled_dot_product_attention(q4, kt, vt, scale=scale)},
        200, 2 * T * Dk * 2 + 2 * H * (Dk + Dv) * 2, 2 * (Dk + Dv) * H * 2 * T,
        launches["paged_attention"], err,
        "F.scaled_dot_product_attention on the contiguous latent rows (one head as a view)",
        dict(B=2, T=T, H=H, G=1, D=Dk, Dv=Dv, block_size=view.block_size),
    )
    del cache, kp, vp, lat, kt, vt, model
    torch.cuda.empty_cache()
    return [row], out


def phase_serving_cache(llm_errs: dict) -> list:
    """The reference's contiguous-cache serving steps (``prefill_cache``,
    ``decode_step_cache``) on the paged kernel: ``_cache_dense``,
    ``_cache_long`` and ``_cache_mla``; returns their kernels-line rows."""
    import gc

    import torch

    rows = []
    for part in (_cache_dense, _cache_long, _cache_mla):
        t0 = time.perf_counter()
        rows += part(llm_errs)[0]
        gc.collect()
        torch.cuda.empty_cache()
        emit("serving_cache_part_seconds", part=part.__name__, seconds=time.perf_counter() - t0,
             allocated_gb=torch.cuda.memory_allocated() / 1e9,
             reserved_gb=torch.cuda.memory_reserved() / 1e9)
    return rows


def _flash_bytes_ops(B, S, T, H, G, D, *, lse=False, bwd=False) -> tuple:
    """Bytes and operations of one non-causal flash call: each input read
    once and each output written once (bf16; lse float32), and 2 flop a
    multiply-add over the S x T pairs of each head: 2 products forward, 5
    backward (P recomputed, dV, dP, dQ, dK)."""
    pairs = B * H * S * T
    if not bwd:
        nbytes = 2 * B * (2 * S * H * D + 2 * T * G * D) + (4 * B * H * S if lse else 0)
        return nbytes, 4 * D * pairs
    nbytes = 2 * B * (4 * S * H * D + 4 * T * G * D) + 4 * B * H * S
    return nbytes, 10 * D * pairs


def _whisper_timing(serving: dict, errs: dict) -> list:
    """whisper's non-causal flash and cross-attention rows (bf16, 8 heads of
    64), each against its plain version and one PyTorch call of the same
    function: row 4e, the encoder's self-attention (B 1, S = T = 1500;
    SDPA non-causal); row 4x, cross-attention at prefill (the mix's longest
    prompt over T = 1500; SDPA non-causal); row 3x, the paged kernel over
    the cross buffer (8 slots x 94 blocks of 16 rows, lengths 1500, a
    layer's strided view; SDPA at S = 1 over the same K/V gathered
    beforehand).  Then a timing line of the flash forward at S = 1 over
    the same 8 x 1500 rows, the route the paged kernel takes the place of
    at decode."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref
    from repro_torch.kernels.paged_attention.ops import paged_attention
    from repro_torch.kernels.paged_attention.ref import paged_attention_ref

    model, spec, launches = serving["model"], serving["spec"], serving["launches"]
    cfg, stats = model.cfg, serving["plan_stats"]
    H, G, D, T, L = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim, 1500, cfg.num_layers
    bf16, gen = torch.bfloat16, torch.Generator(device="cuda").manual_seed(26)
    rows = []
    S_cross = max(len(p) for p in serving["prompts"])
    for name, S, n in (
        ("encoder", T, cfg.num_encoder_layers * stats.admissions),
        ("cross", S_cross, L * stats.admissions),
    ):
        q = _cuda_randn(gen, (1, S, H, D), bf16)
        k, v = (_cuda_randn(gen, (1, T, G, D), bf16) for _ in range(2))
        qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        lib = F.scaled_dot_product_attention(qt, kt, vt).transpose(1, 2)
        check(_max_err(lib, flash_attention_ref(q, k, v, causal=False)) <= 2e-2, "SDPA yardstick")
        nbytes, ops = _flash_bytes_ops(1, S, T, H, G, D)
        rows.append(
            _timing_row(
                "flash_attention",
                {
                    "kernel": lambda: flash_attention(q, k, v, causal=False),
                    "plain": lambda: flash_attention_ref(q, k, v, causal=False),
                    "library": lambda: F.scaled_dot_product_attention(qt, kt, vt),
                },
                100,
                nbytes,
                ops,
                n,
                errs["flash_attention"],
                "F.scaled_dot_product_attention (non-causal)",
                shape=dict(B=1, S=S, T=T, H=H, G=G, D=D, causal=False),
                path=f"{cfg.name}-{name}",
                queued=True,
            )
        )
        del q, k, v, qt, kt, vt, lib

    # row 3x: the cross buffer as the engine keeps it, every layer's K and V
    B, bs = spec.max_batch, spec.block_size
    cross = model.init_cross_kv(B, bs)
    cross.kv.copy_(_cuda_randn(gen, tuple(cross.kv.shape), bf16))
    kv = cross.kv[:, :, 0]
    kp, vp, tbl, ln = kv[:, :, 0], kv[:, :, 1], cross.block_table, cross.lengths
    q = _cuda_randn(gen, (B, H, D), bf16)
    idx = tbl.long()
    kg = kp[idx].reshape(B, -1, G, D)[:, :T].transpose(1, 2).contiguous()
    vg = vp[idx].reshape(B, -1, G, D)[:, :T].transpose(1, 2).contiguous()
    q4 = q[:, :, None]
    lib = F.scaled_dot_product_attention(q4, kg, vg)[:, :, 0]
    want = paged_attention_ref(q, kp, vp, tbl, ln)
    check(_max_err(lib, want) <= 3e-2, "paged cross yardstick")
    nbytes = B * T * G * 2 * D * 2 + 2 * B * H * D * 2 + tbl.numel() * 4 + B * 4
    rows.append(
        _timing_row(
            "paged_attention",
            {
                "kernel": lambda: paged_attention(q, kp, vp, tbl, ln),
                "plain": lambda: paged_attention_ref(q, kp, vp, tbl, ln),
                "library": lambda: F.scaled_dot_product_attention(q4, kg, vg),
            },
            200,
            nbytes,
            4 * D * H * B * T,
            launches["paged_attention"] // 2,
            errs["paged_attention"],
            "F.scaled_dot_product_attention at S = 1 on the cross K/V gathered beforehand",
            shape=dict(B=B, H=H, G=G, D=D, block_size=bs, blocks=tbl.shape[1], lengths=T),
            path=f"{cfg.name}-cross-decode",
            queued=True,
        )
    )
    # the flash forward at S = 1 over the same rows: what the paged route saves
    qf = q[:, None].contiguous()
    kf, vf = (t.transpose(1, 2).contiguous() for t in (kg, vg))
    check(_max_err(flash_attention(qf, kf, vf, causal=False)[:, 0], want) <= 3e-2, "flash S = 1")
    flash_ms = queued_ms(lambda: flash_attention(qf, kf, vf, causal=False), 200)
    paged_ms = queued_ms(lambda: paged_attention(q, kp, vp, tbl, ln), 200)
    emit(
        "whisper_cross_decode_routes",
        shape=dict(B=B, S=1, T=T, H=H, G=G, D=D),
        flash_us=None if flash_ms is None else flash_ms * 1e3,
        paged_us=None if paged_ms is None else paged_ms * 1e3,
        bound_us=nbytes / HBM_BYTES_PER_S * 1e6,
    )
    del cross, kv, kp, vp, q, kg, vg, q4, lib, qf, kf, vf
    torch.cuda.empty_cache()
    return rows


def _swa_timing(window: dict, errs: dict) -> list:
    """h2o-danube-1.8b's windowed kernels at its WINDOW mix's shapes (bf16):
    paged over 8 slots at the mix's mid-decode lengths, window 4096 (row
    3w; its byte bound counts only the rows in the window; the yardstick is
    SDPA over K/V gathered beforehand, the window as ``attn_mask``), and the
    prefill flash at S 8192 with the window (row 4w; SDPA with the window
    as ``attn_mask``, K/V repeated per query head)."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.flash_attention.ref import attention_mask, flash_attention_ref
    from repro_torch.kernels.paged_attention.ops import paged_attention
    from repro_torch.kernels.paged_attention.ref import paged_attention_ref

    model, launches = window["model"], window["launches"]
    cfg = model.cfg
    H, G, D, w = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim, cfg.sliding_window
    bf16, gen = torch.bfloat16, torch.Generator(device="cuda").manual_seed(3)
    rows = []
    lens = _window_lengths()
    B, bs, mb = len(lens), 16, 520
    NB = sum(-(-n // bs) for n in lens) + 8
    tbl = _unique_tables(gen, B, mb, NB, [-(-n // bs) for n in lens])
    ln = torch.tensor(lens, dtype=torch.int32, device="cuda")
    pool = _cuda_randn(gen, (NB, bs, *model.kv_row_shape()), bf16)
    kp, vp = pool[:, :, 0, 0], pool[:, :, 0, 1]
    q = _cuda_randn(gen, (B, H, D), bf16)
    live = sum(min(n, w) for n in lens)  # rows in the window
    nbytes = live * G * 2 * D * 2 + B * H * 2 * D * 2 + B * mb * 4 + B * 4
    idx = tbl.long().clamp(min=0)
    kg = kp[idx].reshape(B, mb * bs, G, D).transpose(1, 2).repeat_interleave(H // G, dim=1)
    vg = vp[idx].reshape(B, mb * bs, G, D).transpose(1, 2).repeat_interleave(H // G, dim=1)
    tok = torch.arange(mb * bs, device="cuda")[None]
    n = ln[:, None].long()
    mask = ((tok < n) & (tok >= n - w))[:, None, None]
    q4 = q[:, :, None]
    sdpa = lambda: F.scaled_dot_product_attention(q4, kg, vg, attn_mask=mask)
    want = paged_attention_ref(q, kp, vp, tbl, ln, window=w)
    check(_max_err(sdpa()[:, :, 0], want) <= 3e-2, "windowed paged yardstick")
    rows.append(
        _timing_row(
            "paged_attention",
            {
                "kernel": lambda: paged_attention(q, kp, vp, tbl, ln, window=w),
                "plain": lambda: paged_attention_ref(q, kp, vp, tbl, ln, window=w),
                "library": sdpa,
            },
            200,
            nbytes,
            2 * 2 * D * H * live,
            launches["paged_attention"],
            errs["paged_attention"],
            "F.scaled_dot_product_attention on K/V gathered beforehand, the window as attn_mask",
            shape=dict(B=B, H=H, G=G, D=D, block_size=bs, lengths=lens, window=w),
            path=cfg.name + "-window",
            queued=True,
        )
    )
    del pool, kp, vp, kg, vg, mask

    S = 8192
    q = _cuda_randn(gen, (1, S, H, D), bf16)
    k, v = (_cuda_randn(gen, (1, S, G, D), bf16) for _ in range(2))
    qt = q.transpose(1, 2).contiguous()
    kt, vt = (t.transpose(1, 2).repeat_interleave(H // G, dim=1).contiguous() for t in (k, v))
    amask = attention_mask(S, S, causal=True, window=w, device="cuda")
    sdpa = lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=amask)
    check(
        _max_err(sdpa().transpose(1, 2), flash_attention_ref(q, k, v, window=w)) <= 2e-2,
        "windowed flash yardstick",
    )
    pairs = w * (w + 1) // 2 + (S - w) * w  # live (q, k) pairs
    rows.append(
        _timing_row(
            "flash_attention",
            {
                "kernel": lambda: flash_attention(q, k, v, window=w),
                "plain": lambda: flash_attention_ref(q, k, v, window=w),
                "library": sdpa,
            },
            10,
            S * (H + G) * 2 * D * 2,
            4 * D * H * pairs,
            launches["flash_attention"],
            errs["flash_attention"],
            "F.scaled_dot_product_attention with the window as attn_mask (K/V repeated per head)",
            shape=dict(B=1, S=S, H=H, G=G, D=D, causal=True, window=w),
            path=cfg.name + "-window",
            queued=True,
        )
    )
    del q, k, v, qt, kt, vt, amask
    torch.cuda.empty_cache()
    return rows


def _serving_path(
    arch: str,
    phase: str,
    *,
    temper: bool,
    f32_forcing: bool = True,
    mix: str = "FULL",
    model=None,
    cfg=None,
) -> dict:
    """One serving path at full width through ``repro_torch.launch.serve``
    on the request mix ``mix`` (``serve.MIXES``); returns what the later
    phases need (model, prompts, launch counts, host time per decode step).
    ``f32_forcing``: also teacher force a float32 model through the kernels
    and the plain path.  ``model``: a bf16 model of ``arch`` already built
    (and tempered where ``temper``), in place of a new one.  ``cfg``:
    ``arch``'s config with a stated cut (``serve.cut``), in place of the
    registry's."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.launch import serve
    from repro_torch.models import model as M
    from repro_torch.serving.record import KVAccessRecorder

    cfg, spec = cfg or get_config(arch), serve.MIXES[mix]
    moe = bool(cfg.moe_num_experts)
    t0 = time.perf_counter()
    built = model is None
    model = M.init_params(cfg, 0) if built else model
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    prompts = serve.make_prompts(cfg, spec, seed=0)
    serve.check_mix(cfg, spec, prompts)
    score_std = {}
    if temper and built:
        if cfg.use_mla or cfg.is_encoder_decoder:
            score_std["untempered"] = _score_std(model, prompts[0])
        model = _tempered(model)
        if cfg.use_mla or cfg.is_encoder_decoder:
            score_std["tempered"] = _score_std(model, prompts[0])
    engine_cls = _serving_engine_cls()

    # prediction: the traffic-only engine runs the same control flow
    plan_rec = KVAccessRecorder()
    plan, _ = serve.new_engine(None, None, spec, prompts, recorder=plan_rec)
    plan.run()
    # attention calls a prefill and a decode step: one a layer; whisper also
    # each encoder layer's at prefill and each decoder layer's cross-attention
    La = cfg.num_attn_layers
    L_prefill = La + (cfg.num_encoder_layers + La if cfg.is_encoder_decoder else 0)
    L_decode = La * (2 if cfg.is_encoder_decoder else 1)
    want = {
        "flash_attention": L_prefill * plan.stats.admissions,
        "banked_copy": plan.stats.admissions,
        "paged_attention": L_decode * plan.stats.decode_steps,
        # the bf16 latent call merges inside its one launch
        "paged_attention_merge": 0 if cfg.use_mla else L_decode * plan.stats.decode_steps,
        "bank_arbiter": 0,
    }

    recorder = KVAccessRecorder()
    eng, reqs = serve.new_engine(
        cfg, model, spec, prompts, engine_cls=engine_cls, recorder=recorder
    )
    first_wave = reqs[: spec.max_batch]
    eng.record = frozenset(r.rid for r in first_wave)
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    with _routes_logged() as kernel_routes:
        t0 = time.perf_counter()
        while eng.queue or any(r is not None for r in eng.slot_req):
            eng.step()
            check(eng.pool.check_isolation(), f"pool isolation broken at step {eng.steps}")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = {k: LAUNCHES[k] for k in want}
    summary = serve.summarize(eng, reqs, wall)
    check(launches == want, f"{arch} serving launches {launches}, predicted {want}")
    check(eng.steps == plan.steps, f"{eng.steps} engine steps, traffic-only run took {plan.steps}")
    n_moe = sum(cfg.is_moe_layer(i) for i in range(cfg.num_layers))
    routes_want = n_moe * (plan.stats.admissions + plan.stats.decode_steps)
    check(len(kernel_routes) == routes_want, f"{len(kernel_routes)} route calls, {routes_want} due")
    record = recorder.record
    check(
        record.events_key() == plan_rec.record.events_key(),
        "the serving run's KV access record differs from the traffic-only engine's",
    )
    check(
        all(r.done and len(r.out_tokens) == spec.max_new_tokens for r in reqs),
        "a request did not finish with its token count",
    )
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    kernel_logits = eng.logits
    forced = {r.rid: list(r.out_tokens) for r in first_wave}
    ssm_bytes = 0 if eng.ssm is None else eng.ssm.nbytes()
    cross_bytes = 0 if eng.cross is None else eng.cross.nbytes()
    del eng

    # teacher forcing: the first wave again, fed the kernel run's tokens, on
    # the same batches, blocks and GEMM shapes, through the plain attention
    # path in bf16, and through kernels and plain path in float32; MLA also
    # through the plain non-absorbed decode
    def forced_run(m, impl, absorbed=True):
        m.impl = impl
        reset_launches()
        tf, _ = serve.new_engine(cfg, m, spec, prompts[: spec.max_batch], engine_cls=engine_cls)
        tf.record, tf.forced = frozenset(forced), forced
        with _routes_logged() as routes, _patched(M, "decode_step", _decode_form(absorbed)):
            tf.run()
        m.impl = "kernel"
        ran = sum(LAUNCHES.values())
        check((ran > 0) == (impl == "kernel"), f"{impl} path launched {ran} kernels")
        check(set(tf.logits) == set(kernel_logits), "teacher-forced run saw other tokens")
        return tf.logits, routes

    plain_logits, plain_routes = forced_run(model, "ref")
    forcing = {"bf16_kernel_vs_plain": _logits_gap(kernel_logits, plain_logits)}
    routes = {"bf16_kernel_vs_plain": (kernel_routes, plain_routes)}
    if f32_forcing:
        model32 = M.init_params(cfg, 0, compute_dtype=torch.float32, kv_dtype=torch.float32)
        if temper:
            model32 = _tempered(model32)
        kernel32, kernel32_routes = forced_run(model32, "kernel")
        plain32, plain32_routes = forced_run(model32, "ref")
        del model32
        forcing["f32_kernel_vs_plain"] = _logits_gap(kernel32, plain32)
        forcing["bf16_kernel_vs_f32_plain"] = _logits_gap(kernel_logits, plain32)
        routes["f32_kernel_vs_plain"] = (kernel32_routes, plain32_routes)
        routes["bf16_kernel_vs_f32_plain"] = (kernel_routes, plain32_routes)
    if cfg.use_mla:
        na_logits, na_routes = forced_run(model, "ref", absorbed=False)
        forcing["bf16_plain_absorbed_vs_non_absorbed"] = _logits_gap(plain_logits, na_logits)
        routes["bf16_plain_absorbed_vs_non_absorbed"] = (plain_routes, na_routes)
    if moe:
        forcing["routes"] = {k: _route_agreement(*v) for k, v in routes.items()}
    del kernel_routes, plain_routes, routes
    if score_std:
        forcing["score_std_by_layer"] = score_std
    emit(phase.replace("serving", "teacher_forcing"), tokens=len(kernel_logits), **forcing)
    # tolerances and their reasons are stated in PERF.md (Findings) before their first run
    bounds = {f"{k}_kernel_vs_plain": (k, v) for k, v in FORCING_BOUNDS[arch].items()}
    if cfg.use_mla:
        bounds["bf16_plain_absorbed_vs_non_absorbed"] = ("bf16", MLA_FORMS_BOUND)
    for key, (name, (max_gap, agreement)) in bounds.items():
        gap = forcing[key]
        check(
            gap["max"] <= max_gap and gap["argmax_agreement"] >= agreement,
            f"{arch} {key} teacher forcing: the two paths differ: {gap}",
        )
        if moe:
            agree = forcing["routes"][key]
            check(
                agree["agreement"] >= ROUTE_AGREEMENT[name],
                f"{arch} {key} teacher forcing: routing decisions differ: {agree}",
            )
    emit(
        phase,
        arch=cfg.name,
        mix=mix,
        params=cfg.num_params(),
        init_s=init_s,
        **{k: summary[k] for k in ("requests", "done", "out_tokens", "steps", "wall_s")},
        prompt_tokens=summary["stats"]["prefill_tokens"],
        prefill_tokens_per_s=summary["prefill_tokens_per_s"],
        decode_ms_per_step=summary["decode_ms_per_step"],
        out_tokens_per_s=summary["out_tokens_per_s"],
        pool_imbalance=summary["pool_imbalance"],
        peak_memory_gb=peak_gb,
        ssm_state_mb_per_slot=ssm_bytes / spec.max_batch / 1e6,
        cross_kv_mb_per_slot=cross_bytes / spec.max_batch / 1e6,
        launches=launches,
        predicted=want,
        stats=summary["stats"],
        teacher_forcing=forcing,
        kv_access_record=record.summary(),
    )
    return dict(
        model=model,
        spec=spec,
        prompts=prompts,
        launches=launches,
        decode_ms_per_step=summary["decode_ms_per_step"],
        phase=phase,
        plan_stats=plan.stats,
    )


def phase_serving_profile(serving: dict) -> None:
    """Where a decode step's time goes: 8 decode-only steps of the first wave
    under ``torch.profiler`` against the unprofiled host time per step.  On
    an MoE path, also the expert products of one decode step (every layer's
    batched matmuls at the step's shapes) against their weight-read bound."""
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
    paged = ("paged_split", "paged_latent", "paged_merge")
    paged_us = sum(v for k, v in by_name.items() if any(n in k for n in paged))
    host_us = serving["decode_ms_per_step"] * 1e3
    del eng
    moe = _expert_products(serving, busy_us / steps) if serving["model"].cfg.moe_num_experts else {}
    emit(
        serving["phase"] + "_profile",
        decode_steps=steps,
        device_kernels_per_step=len(kernels) / steps,
        device_busy_us_per_step=busy_us / steps,
        host_us_per_step_unprofiled=host_us,
        device_idle_share=1 - busy_us / steps / host_us if busy_us else None,
        paged_attention_us_per_step=paged_us / steps,
        paged_attention_share_of_device_time=paged_us / busy_us if busy_us else None,
        top_kernels_us_per_step={k[:80]: v / steps for k, v in top},
        profiled_wall_s=wall,
        **moe,
    )


def _expert_products(serving: dict, busy_us_per_step: float) -> dict:
    """Device time of one decode step's expert products: ``expert_products``
    of every layer on that layer's weights at the step's shapes (8 groups of
    one token, capacity 8 each: 64 rows per expert), timed by the profiler
    over 5 steps' worth and between CUDA events; beside it the bound, every
    expert's weights read once (bytes) or the products' operations."""
    import torch

    from repro_torch.models.moe import MoE, expert_capacity, expert_products

    model, spec = serving["model"], serving["spec"]
    cfg = model.cfg
    layers = [m for m in model.modules() if isinstance(m, MoE)]
    E, d, f, L = cfg.moe_num_experts, cfg.d_model, cfg.moe_d_ff or cfg.d_ff, len(layers)
    rows = spec.max_batch * expert_capacity(cfg, 1)
    gen = torch.Generator(device="cuda").manual_seed(2)
    buf = _cuda_randn(gen, (E, rows, d), model.embed.dtype)

    def one_step():
        for m in layers:
            expert_products(buf, m.w_gate, m.w_up, m.w_down)

    dev = device_ms(one_step, 5)
    call = time_ms(one_step, 10, warmup=2)
    esize = buf.element_size()
    nbytes = L * (3 * E * d * f + 2 * E * rows * d) * esize
    ops = L * 2 * 3 * E * rows * d * f
    bytes_ms, ops_ms = nbytes / HBM_BYTES_PER_S * 1e3, ops / BF16_OPS_PER_S * 1e3
    del buf
    return {
        "expert_products": {
            "rows_per_expert": rows,
            "device_us_per_step": None if dev is None else dev * 1e3,
            "call_us_per_step": call * 1e3,
            "weight_bytes_per_step": L * 3 * E * d * f * esize,
            "bound_us": max(bytes_ms, ops_ms) * 1e3,
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "share_of_decode_busy": None if dev is None else dev * 1e3 / busy_us_per_step,
        }
    }


def _timing_row(
    name, fns, iters, nbytes, ops, launches, err, library, shape=None, path=None, queued=False
):
    """Device and call times of kernel / plain / library and the bound, on
    the path ``path``.  The row's times are the profiler's device time, or
    with ``queued`` the device time of queued calls between CUDA events
    (``queued_ms``): the training path's kernels launch three kernels per
    call from ctypes, and the profiler's per-call sessions drop some of
    them (in a profiled train step it records them all); banked_copy's
    rows and flash's serving rows too (the profiler read stablelm-3b's
    flash at 8.69 us a call where its queued calls take 35.9)."""
    call_ms = {k: time_ms(fn, iters, warmup=2 if queued else 20) for k, fn in fns.items()}
    dev_ms = {k: device_ms(fn, max(5, iters // 5)) for k, fn in fns.items()}
    ms = {k: dev_ms[k] if dev_ms[k] is not None else call_ms[k] for k in fns}
    if queued:
        q_ms = {k: queued_ms(fn, iters) for k, fn in fns.items()}
        ms = {k: q_ms[k] if q_ms[k] is not None else call_ms[k] for k in fns}
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / BF16_OPS_PER_S * 1e3
    emit(
        "timing",
        kernel=name,
        path=path,
        shape=shape,
        device_us={k: None if v is None else v * 1e3 for k, v in dev_ms.items()},
        call_us={k: v * 1e3 for k, v in call_ms.items()},
        row_us={k: v * 1e3 for k, v in ms.items()},
        bytes=nbytes,
        ops=ops,
        bound_us=max(bytes_ms, ops_ms) * 1e3,
        library=library,
    )
    return {
        "name": name,
        "path": path,
        "route": "cuda",
        "source": f"src/repro_torch/kernels/{name}/csrc/{name}.cu",
        "replaces": {
            "banked_copy": "src/repro/kernels/banked_copy/kernel.py:29",
            "paged_attention": "src/repro/kernels/paged_attention/kernel.py:65",
            "flash_attention": "src/repro/kernels/flash_attention/kernel.py:72",
            "flash_attention_bwd": "src/repro/models/attention.py:214",
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


#: phase marks of the bf16 latent kernel (``LAT_MARK`` in paged_attention.cu)
#: read by ``_latent_timing``: (name, from mark, to mark)
LATENT_PHASES = (
    ("start: length, table, cluster barrier", 0, 1),
    ("q multicast in", 1, 2),
    ("stage 0 in", 2, 3),
    ("S, stage 0", 3, 4),
    ("softmax, stage 0", 4, 5),
    ("P V, stage 0", 5, 6),
    ("the rest of the stages", 6, 8),
    ("merge: cluster barrier", 8, 9),
    ("merge: weights", 9, 10),
    ("merge: loads from the cluster", 10, 11),
    ("merge: stores and the last barrier", 11, 12),
)


def _latent_timing(q, kp, tbl, ln, scale) -> None:
    """Row 3m apart: the bf16 latent call (one launch) as queued calls; its
    work (the split: start to the last stage) and its merge per CTA from the
    build with phase marks, with the stages and live CTAs; and the float32
    route's split and merge, each as queued calls."""
    import ctypes

    import torch

    from repro_torch.kernels.paged_attention import ops

    B, mb, bs = q.shape[0], tbl.shape[1], kp.shape[1]
    lens = ln.tolist()
    C = ops.LATENT_CLUSTER
    chunks = [-(-n // C) for n in lens]
    live = sum(-(-n // c) for n, c in zip(lens, chunks) if c)
    stages = max(-(-c // ops.LATENT_STAGE_ROWS) for c in chunks)
    call = lambda: ops.paged_attention(q, kp, kp[..., :512], tbl, ln, scale=scale)
    call_us = queued_ms(call, 200) * 1e3

    lib = ctypes.CDLL(MARKED["paged_attention"])
    fn = lib.paged_attention_latent
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 3 + [ctypes.c_longlong] * 2
    fn.argtypes += [ctypes.c_float, ctypes.c_void_p]
    lib.paged_attention_latent_marks.argtypes = [ctypes.c_void_p]
    out = torch.empty((B, 16, 512), dtype=q.dtype, device="cuda")
    args = (q.data_ptr(), kp.data_ptr(), tbl.data_ptr(), ln.data_ptr(), out.data_ptr(), None)
    args += (B, mb, bs)  # None: no log-sum-exp output
    args += (kp.stride(0), kp.stride(1), scale, torch.cuda.current_stream().cuda_stream)
    marked = lambda: check(fn(*args) == 0, "marked latent launch")
    marks = torch.zeros((B * C, 16), dtype=torch.int64, device="cuda")
    marked_us = queued_ms(marked, 200) * 1e3  # marks off
    check(lib.paged_attention_latent_marks(marks.data_ptr()) == 0, "latent marks buffer")
    for _ in range(3):
        marked()
    torch.cuda.synchronize()
    check(lib.paged_attention_latent_marks(None) == 0, "latent marks buffer")
    check(torch.equal(out, call()), "the marked build's output differs from the kernel's")
    m = marks.cpu().double()
    t0 = m[:, 0].min()

    def median_us(a, b):
        return float((m[:, b] - m[:, a]).median()) / 1e3

    work = m[:, 8] - t0  # each CTA's split done, from the first CTA's start
    end = m[:, 12] - t0

    # the float32 route (the check path): split and merge apart
    q32, kv32 = q.float(), kp.float()
    fns = ops._kernel_fns()
    bps = ops.blocks_per_split(bs, latent=True)
    nsplit = -(-mb // bps)
    part_acc = torch.empty((B, 16, nsplit, 512), dtype=torch.float32, device="cuda")
    part_ms = torch.empty((B, 16, nsplit, 2), dtype=torch.float32, device="cuda")
    out32 = torch.empty((B, 16, 512), dtype=torch.float32, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    parts = (part_acc.data_ptr(), part_ms.data_ptr())
    split_args = (q32.data_ptr(), kv32.data_ptr(), tbl.data_ptr(), ln.data_ptr(), *parts, B, mb)
    split_args += (bs, bps, kv32.stride(0), kv32.stride(1), scale, stream)
    merge_args = (*parts, ln.data_ptr(), out32.data_ptr(), B, 16, 512, mb, bs, bps, 0, 0, None)
    merge_args += (stream,)  # None: no log-sum-exp output
    split32 = lambda: check(fns["latent_split"](*split_args) == 0, "f32 split")
    merge32 = lambda: check(fns["merge"](*merge_args) == 0, "f32 merge")
    split32()
    emit(
        "latent_timing",
        lengths=lens,
        cluster=C,
        live_ctas=live,
        stages_per_cta_at_most=stages,
        row_bytes=sum(lens) * kp.shape[-1] * kp.element_size(),
        partial_bytes_in_device_memory=0,
        partial_bytes_through_the_cluster=B * C * (16 * 512 * 4 + 16 * 8),
        bf16_call_queued_us=call_us,
        bf16_marked_build_queued_us=marked_us,
        bf16_split_us={"median": float(work.median()) / 1e3, "max": float(work.max()) / 1e3},
        bf16_merge_us=median_us(8, 12),
        bf16_end_us={"median": float(end.median()) / 1e3, "max": float(end.max()) / 1e3},
        bf16_phase_median_us={name: median_us(a, b) for name, a, b in LATENT_PHASES},
        bf16_sms=len({int(x) for x in m[:, 15].tolist()}),
        f32_split_queued_us=queued_ms(split32, 200) * 1e3,
        f32_merge_queued_us=queued_ms(merge32, 200) * 1e3,
        f32_splits_live=sum(-(-n // (bps * bs)) for n in lens),
    )


def phase_llm_timing(
    serving: dict, errs: dict, flash_lengths=(128, 517, 1024), copy_blocks: int = 64
) -> list:
    """Timing rows of the serving kernels at a serving path's shapes (bf16;
    stablelm-1.6b, olmoe-1b-7b or deepseek-v2-lite-16b): flash at the longest
    prompt (S = 1024; shorter ``flash_lengths`` on timing lines of their
    own), paged attention over 8 slots at the first wave's mid-decode
    lengths, banked_copy of a ``copy_blocks``-block burst into the
    2048-block pool.  MLA's flash has QK width 192 and V width 128 at scale
    192^-0.5, and its paged call is the latent one (16 heads, K rows of 576,
    V their first 512 columns).  On whisper's path half of the paged
    launches are the cross-attention's (``_whisper_timing``): this row
    counts the self-attention's."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.banked_copy.ops import banked_copy, floor_launch
    from repro_torch.kernels.banked_copy.ref import banked_copy_ref
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref
    from repro_torch.kernels.paged_attention.ops import paged_attention
    from repro_torch.kernels.paged_attention.ref import paged_attention_ref

    model, spec, launches = serving["model"], serving["spec"], serving["launches"]
    cfg = model.cfg
    H, G, D, L = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim, cfg.num_layers
    Dk, Dv, scale = D, D, None
    if cfg.use_mla:  # prefill: one KV head per query head; decode: the latent call
        Dk, Dv = cfg.qk_nope_dim + cfg.qk_rope_dim, cfg.v_head_dim
        scale = Dk**-0.5
    NB, bs, mb = 2048, spec.block_size, spec.max_len // spec.block_size
    bf16, gen = torch.bfloat16, torch.Generator(device="cuda").manual_seed(1)
    rows = []

    # flash at the short prompts (timing lines only, where a 64-row tile
    # leaves the card underfilled) and at the longest (the kernels line)
    for S in flash_lengths:
        q, k = _cuda_randn(gen, (1, S, H, Dk), bf16), _cuda_randn(gen, (1, S, G, Dk), bf16)
        v = _cuda_randn(gen, (1, S, G, Dv), bf16)
        qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        gqa = dict(enable_gqa=True) if G != H else {}  # chameleon-34b: 64 query heads, 8 KV

        def sdpa():
            return F.scaled_dot_product_attention(qt, kt, vt, is_causal=True, scale=scale, **gqa)

        lib = sdpa().transpose(1, 2)
        want = flash_attention_ref(q, k, v, scale=scale)
        check(_max_err(lib, want) <= 2e-2, "SDPA yardstick disagrees")
        fns = {
            "kernel": lambda: flash_attention(q, k, v, scale=scale),
            "plain": lambda: flash_attention_ref(q, k, v, scale=scale),
            "library": sdpa,
        }
        row = _timing_row(
            "flash_attention",
            fns,
            100,
            S * (H + G) * (Dk + Dv) * 2,
            (Dk + Dv) * H * S * (S + 1),
            launches["flash_attention"],
            errs["flash_attention"],
            "F.scaled_dot_product_attention(is_causal=True)",
            shape=dict(B=1, S=S, H=H, G=G, D=Dk, Dv=Dv, causal=True),
            path=cfg.name,
            queued=True,
        )
        if S == 1024:
            # flash against SDPA: device time of queued calls, alternating rounds
            pairs = [
                (queued_ms(fns["kernel"], 100), queued_ms(fns["library"], 100))
                for _ in range(FLASH_ROUNDS)
            ]
            done = [p for p in pairs if None not in p]
            if done:
                row["queued_median_ms"] = statistics.median(a for a, _ in done)
                row["library_queued_median_ms"] = statistics.median(b for _, b in done)
            emit(
                "flash_vs_sdpa",
                path=cfg.name,
                S=S,
                rounds_us=[[None if x is None else x * 1e3 for x in p] for p in pairs],
                flash_faster_rounds=sum(a < b for a, b in done),
            )
            rows.append(row)
        del q, k, v, qt, kt, vt, lib

    B = spec.max_batch
    lens = [len(p) + spec.max_new_tokens // 2 for p in serving["prompts"][:B]]
    tbl = _unique_tables(gen, B, mb, NB, [-(-n // bs) for n in lens])
    ln = torch.tensor(lens, dtype=torch.int32, device="cuda")
    tokens = sum(lens)
    idx = tbl.long().clamp(min=0)
    pool = _cuda_randn(gen, (NB, bs, *model.kv_row_shape()), bf16)
    if cfg.use_mla:  # the latent call: V is K's first kv_lora_rank columns
        G, Dk, Dv = 1, cfg.latent_dim, cfg.kv_lora_rank
        kp = pool[:, :, 0, None]
        vp = kp[..., :Dv]
        nbytes = tokens * Dk * 2  # each latent row read once
    else:
        kp, vp = pool[:, :, 0, 0], pool[:, :, 0, 1]
        nbytes = tokens * G * (Dk + Dv) * 2
    nbytes += B * H * (Dk + Dv) * 2 + B * mb * 4 + B * 4
    q = _cuda_randn(gen, (B, H, Dk), bf16)
    # yardstick: SDPA over K/V gathered beforehand (the gather is not timed;
    # MLA's one latent head broadcast to the 16 query heads as a view)
    kg = kp[idx].reshape(B, mb * bs, G, Dk).transpose(1, 2).contiguous()
    vg = vp[idx].reshape(B, mb * bs, G, Dv).transpose(1, 2).contiguous()
    if G in (1, H):
        kg, vg = kg.expand(B, H, -1, -1), vg.expand(B, H, -1, -1)
    else:  # GQA (chameleon-34b, 8 query heads a group): each group's rows repeated
        kg, vg = kg.repeat_interleave(H // G, dim=1), vg.repeat_interleave(H // G, dim=1)
    mask = (torch.arange(mb * bs, device="cuda")[None] < ln[:, None].long())[:, None, None]
    q4 = q[:, :, None]
    sdpa = lambda: F.scaled_dot_product_attention(q4, kg, vg, attn_mask=mask, scale=scale)
    lib = sdpa()[:, :, 0]
    want = paged_attention_ref(q, kp, vp, tbl, ln, scale=scale)
    check(_max_err(lib, want) <= 3e-2, "paged yardstick")
    rows.append(
        _timing_row(
            "paged_attention",
            {
                "kernel": lambda: paged_attention(q, kp, vp, tbl, ln, scale=scale),
                "plain": lambda: paged_attention_ref(q, kp, vp, tbl, ln, scale=scale),
                "library": sdpa,
            },
            200,
            nbytes,
            2 * (Dk + Dv) * H * tokens,
            launches["paged_attention"] // (2 if cfg.is_encoder_decoder else 1),
            errs["paged_attention"],
            "F.scaled_dot_product_attention on K/V gathered beforehand",
            shape=dict(B=B, H=H, G=G, D=Dk, Dv=Dv, block_size=bs, lengths=lens),
            path=cfg.name,
            queued=True,
        )
    )
    if cfg.use_mla:
        _latent_timing(q, kp, tbl, ln, scale)
    del pool, kp, vp, kg, vg, lib

    nblk, W = copy_blocks, model.kv_width()
    pool = _cuda_randn(gen, (NB, bs, W), bf16)
    burst = _cuda_randn(gen, (1, nblk, bs, W), bf16)
    tbl = _unique_tables(gen, 1, nblk, NB, [nblk])
    idx = tbl[0].long()
    # queued calls: the profiler's per-call sessions dropped 6 of this
    # kernel's 10 events at MLA's row width, below the byte bound (PERF.md);
    # the row's time is warm (the same burst into the same rows, from L2 for
    # a burst of a few MB), beside it the cold time and the floor
    row = _timing_row(
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
        path=cfg.name,
        queued=True,
    )
    t0 = time.perf_counter()
    row["cold_ms"] = copy_cold_ms(pool, burst, gen)
    row["floor_ms"] = queued_ms(lambda: floor_launch(pool, burst, tbl), 50)
    emit(
        "banked_copy_cold_floor",
        path=cfg.name,
        seconds=time.perf_counter() - t0,
        warm_us=row["ms"] * 1e3,
        cold_us=None if row["cold_ms"] is None else row["cold_ms"] * 1e3,
        floor_us=None if row["floor_ms"] is None else row["floor_ms"] * 1e3,
        bound_us=row["bound_ms"] * 1e3,
    )
    rows.append(row)
    del pool, burst
    return rows


#: bytes that a cold ``banked_copy`` timing rotates over: twice the H100's
#: 50 MB L2
COLD_COPY_BYTES = 2 * 50 * 2**20


def copy_cold_ms(pool, burst, gen, iters: int = 50) -> float | None:
    """Queued device time per call of ``banked_copy`` of a burst shaped as
    ``burst [1, nblk, bs, W]`` from cold, as the engine's admission finds it:
    the calls rotate over R distinct bursts (``burst`` and R - 1 drawn from
    ``gen``) into R disjoint sets of ``pool`` rows, R x (burst + its rows) at
    least ``COLD_COPY_BYTES``, so each call's bytes have left L2 since the
    call that last touched them.  None as ``queued_ms``."""
    import itertools

    import torch

    from repro_torch.kernels.banked_copy.ops import banked_copy

    nblk = burst.shape[1]
    R = -(-COLD_COPY_BYTES // (2 * burst.numel() * burst.element_size()))
    check(R * nblk <= pool.shape[0], f"cold banked_copy: {R} x {nblk} rows past the pool")
    bursts = [burst]
    if R > 1:
        more = _cuda_randn(gen, (R - 1, *burst.shape[1:]), burst.dtype)
        bursts += list(more.split(1))
    perm = torch.randperm(pool.shape[0], generator=gen, device="cuda")
    tables = perm[: R * nblk].int().view(R, 1, nblk)
    turn = itertools.cycle(range(R))

    def call():
        k = next(turn)
        banked_copy(pool, bursts[k], tables[k])

    return queued_ms(call, max(iters, 2 * R))


#: the training phase's bounds, stated in PERF.md before its first run on the
#: card: the backward kernel against its plain version as the largest abs
#: difference over the largest abs entry of dQ, dK, dV (summation order in
#: float32; one bf16 rounding of each output, 2^-8), the forward's output
#: likewise (the bf16 kernel also rounds P to bf16 before P V), the
#: forward's lse as an abs difference; the full-width step's kernel run
#: against its plain run (the bf16 forward kernel rounds P to bf16 before
#: P V where the plain path keeps float32, through 24 layers): |loss difference|, the relative
#: difference of the gradient norms and, per parameter leaf,
#: ||g_kernel - g_plain|| / ||g_plain||; the MoE steps' |loss difference| and
#: the least share of routing decisions that agree
TRAIN_BWD_REL_TOL = {"bf16": 1e-2, "f32": 1e-4}
TRAIN_OUT_REL_TOL = {"bf16": 1e-2, "f32": 1e-5}
TRAIN_LSE_TOL = {"bf16": 1e-3, "f32": 1e-4}
TRAIN_STEP_BOUNDS = {"loss_abs": 0.02, "grad_norm_rel": 0.05, "leaf_rel": 0.1}
TRAIN_MOE_BOUNDS = {"loss_abs": 0.05, "route_agreement": 0.9}
#: the full-width step's batch: the sequence length of ``RunConfig.shape``
#: (``train_4k``, 4096), its global batch of 256 cut to the 4 sequences one
#: card holds
TRAIN_B, TRAIN_S = 4, 4096
#: deepseek-v2-lite-16b's training run: 4 of its 27 layers (AdamW's float32
#: parameters, gradients and moments take ~260 GB at 27, ~44 GB at 4) and
#: train_4k's batch cut to 2 sequences of 4096
MLA_TRAIN_LAYERS, MLA_TRAIN_B = 4, 2
#: stablelm-3b's training run: train_4k's batch cut to the 4 sequences of
#: 4096 that fit at full depth beside AdamW's 44.8 GB of float32 state (the
#: peak predicted in PERF.md before the first run)
TRAIN_3B_B = 4
#: h2o-danube-1.8b's training run (full width and depth): at train_4k's S =
#: 4096 its 4096-token window never masks a key, so the sequences are 8192
#: long; kernel against plain at B 1 (the plain path's float32 scores of a
#: layer take 8.6 GB a sequence), a timed kernel run at B 2 (16384 tokens a
#: step, as train_4k's 4 x 4096 a card)
SWA_TRAIN_S, SWA_TRAIN_B, SWA_TIMED_B = 8192, 1, 2
#: depth cuts of earlier full-depth paths (the hybrid stack's phases pushed
#: the script past its 1050 s aim: 1143.1 s on one H100, PERF.md §4):
#: h2o-danube-1.8b served and trained at 12 of its 24 layers,
#: stablelm-3b trained at 16 of its 32; every kernel keeps its shapes
SWA_SERVE_LAYERS = SWA_TRAIN_LAYERS = 12
TRAIN_3B_LAYERS = 16
#: mamba2-1.3b's training run: full width and depth (AdamW's float32
#: parameters, gradients and moments 21.4 GB), train_4k's batch of 256 cut
#: to 4 sequences of 4096, the default run (LR 3e-4 after 20 warm-up steps)
#: on one batch three times: the first step's LR is 0, so the second step's
#: loss equals the first's, and the third reads the second step's update
#: (LR 1.5e-5) on the batch it was taken on, which must lower the loss.
#: (With one warm-up step, LR 3e-4 at the second step, the loss rose from
#: 11.24 to 14.40 at full width: Adam's first update moves every parameter
#: by the LR in its gradient's sign; PERF.md, Findings.)
SSM_TRAIN_B = 4
#: jamba's training run at a reduced width, stated before its first run: no
#: form of jamba trains on one card at full width (one super-block with 2
#: experts is 11.3 B parameters, ~90 GB of float32 parameters and gradients
#: under Adafactor), so one super-block at d 2048, 16 query heads over 2 KV
#: groups at 128 (jamba's 8 : 1), FFN and expert width 6144 (jamba's 3 x d),
#: 16 experts top-2, SSD heads of 64 at state 128 (64 heads), vocab 65536:
#: 3.0 B parameters; B 2 x S 4096 (train_4k's batch of 256 cut to 2)
HYBRID_TRAIN_WIDTHS = dict(
    num_layers=8, d_model=2048, num_heads=16, num_kv_heads=2, head_dim=128, d_ff=6144, moe_d_ff=6144
)
HYBRID_TRAIN_B = 2
#: whisper-base's training run at full width and depth, stated before its
#: first run: train_4k's 4096 decoder tokens a sequence beside 1500 frames
#: (the audio stub's input, drawn from a seeded generator), its batch of
#: 256 cut to 8 sequences (a first guess at what one card holds: the
#: logits, 8 x 4096 x 53248, are 3.5 GB in bf16 and twice that in float32
#: for the loss), AdamW, remat full
WHISPER_TRAIN_B = 8
#: deepseek-7b's training run, stated before its first run: full width (32
#: heads of 128, MHA) and 4 of its 30 layers (1.65 B parameters, 0.84 B of
#: them the embedding and head: AdamW's float32 parameters, gradients and
#: moments ~26 GB; all 30 layers would be ~111 GB), train_4k's batch of 256
#: cut to 2 sequences of 4096
DENSE7B_TRAIN_LAYERS, DENSE7B_TRAIN_B = 4, 2
#: chameleon-34b's training run, stated before its first run: full width (64
#: query heads over 8 groups at 128, QK-norm) and 2 of its 48 layers (2.46 B
#: parameters, ~39 GB of AdamW's float32 state; all 48 would be ~549 GB),
#: train_4k's batch cut to 1 sequence of 4096: the plain path's float32
#: scores take 4.3 GB a sequence and layer
VLM_TRAIN_LAYERS, VLM_TRAIN_B = 2, 1


def _window_pairs(S: int, window: int) -> int:
    """The (query, key) pairs a causal sequence of S attends to under a
    sliding window (0: none)."""
    w = min(window or S, S)
    return w * (w + 1) // 2 + (S - w) * w


def _rel_err(got, want) -> float:
    """Largest abs difference over the largest abs entry of ``want``."""
    want = want.double()
    return float((got.double() - want).abs().max() / want.abs().max().clamp_min(1e-30))


def _train_kernel_checks() -> dict:
    """The flash backward kernel and the forward's output and log-sum-exp
    against their plain versions on the card, at the square widths and at
    MLA's (q/k 192, v 128); two calls at each main path's shape bit for
    bit.  Returns ``{"bwd": {case: largest abs difference of
    dQ, dK, dV}, "fwd": {case: the output's}}``."""
    import torch

    from repro_torch.kernels.flash_attention.ops import (
        flash_attention,
        flash_attention_bwd,
        flash_attention_fwd,
    )
    from repro_torch.kernels.flash_attention.ref import (
        flash_attention_bwd_ref,
        flash_attention_fwd_ref,
    )

    gen = torch.Generator(device="cuda").manual_seed(7)
    f32, bf16 = torch.float32, torch.bfloat16
    cases = [  # name, B, S, T, H, G, D (q/k), Dv, causal, window, dtype
        ("stablelm_B4_S4096", TRAIN_B, TRAIN_S, TRAIN_S, 32, 32, 64, 64, True, 0, bf16),
        ("stablelm_S517", 1, 517, 517, 32, 32, 64, 64, True, 0, bf16),
        ("olmoe_B2_S2048", 2, 2048, 2048, 16, 16, 128, 128, True, 0, bf16),
        ("mla_B2_S4096", MLA_TRAIN_B, TRAIN_S, TRAIN_S, 16, 16, 192, 128, True, 0, bf16),
        ("mla_S517", 1, 517, 517, 16, 16, 192, 128, True, 0, bf16),
        ("mla_S300_T500_f32", 1, 300, 500, 16, 16, 192, 128, True, 0, f32),
        ("gqa4_S1000", 2, 1000, 1000, 16, 4, 64, 64, True, 0, bf16),
        ("gqa4_S1000_f32", 2, 1000, 1000, 16, 4, 64, 64, True, 0, f32),
        ("window64_d128_f32", 1, 300, 300, 8, 8, 128, 128, True, 64, f32),
        ("d16_S77_f32", 2, 77, 77, 8, 2, 16, 16, True, 0, f32),
        ("d32_T333_full", 1, 100, 333, 8, 1, 32, 32, False, 0, bf16),
        ("window128_d128_gqa4", 2, 600, 600, 8, 2, 128, 128, True, 128, bf16),
        ("window100_d32_full", 1, 400, 400, 4, 2, 32, 32, False, 100, bf16),
        ("gqa4_d128_S1000", 2, 1000, 1000, 16, 4, 128, 128, True, 0, bf16),
        ("causal_S300_T500", 1, 300, 500, 8, 2, 64, 64, True, 0, bf16),
        ("causal_S500_T300", 1, 500, 300, 8, 2, 64, 64, True, 0, bf16),
        ("causal_S500_T300_f32", 1, 500, 300, 8, 2, 64, 64, True, 0, f32),
        # stablelm-3b's heads, D = 80: B 2 x S 4096, ragged S and T, a window
        ("stablelm3b_B2_S4096", 2, TRAIN_S, TRAIN_S, 32, 32, 80, 80, True, 0, bf16),
        ("stablelm3b_S517", 1, 517, 517, 32, 32, 80, 80, True, 0, bf16),
        ("d80_S300_T500", 1, 300, 500, 8, 8, 80, 80, True, 0, bf16),
        ("d80_S300_T500_f32", 1, 300, 500, 8, 8, 80, 80, True, 0, f32),
        ("d80_S517_f32", 1, 517, 517, 32, 32, 80, 80, True, 0, f32),
        ("d80_window64_gqa4", 2, 600, 600, 8, 2, 80, 80, True, 64, bf16),
        ("d80_window64_gqa4_f32", 2, 600, 600, 8, 2, 80, 80, True, 64, f32),
        ("d80_T333_full_f32", 1, 100, 333, 8, 1, 80, 80, False, 0, f32),
        # h2o-danube-1.8b's training shapes: 32 heads over 8 groups at 80, S
        # 8192, its window of 4096 (the timed step's B 2, the checked B 1)
        ("h2o_B2_S8192_window4096", 2, 8192, 8192, 32, 8, 80, 80, True, 4096, bf16),
        ("h2o_S8192_window4096_f32", 1, 8192, 8192, 32, 8, 80, 80, True, 4096, f32),
    ]
    cases += [  # deepseek-7b's training heads (32 of 128, MHA) and chameleon-34b's
        # (64 over 8 groups at 128), B x 4096 as their steps run them
        ("dense7b_B2_S4096", DENSE7B_TRAIN_B, TRAIN_S, TRAIN_S, 32, 32, 128, 128, True, 0, bf16),
        ("vlm_B1_S4096", VLM_TRAIN_B, TRAIN_S, TRAIN_S, 64, 8, 128, 128, True, 0, bf16),
        ("vlm_S517_f32", 1, 517, 517, 64, 8, 128, 128, True, 0, f32),
    ]
    cases += [  # jamba's training heads: 16 over 2 groups at 128 (8 a group)
        ("jamba_B2_S4096", HYBRID_TRAIN_B, TRAIN_S, TRAIN_S, 16, 2, 128, 128, True, 0, bf16),
        ("jamba_S517", 1, 517, 517, 16, 2, 128, 128, True, 0, bf16),
        ("jamba_S517_f32", 1, 517, 517, 16, 2, 128, 128, True, 0, f32),
    ]
    wb, enc = WHISPER_TRAIN_B, 1500
    cases += [  # whisper's non-causal shapes, 8 heads of 64: the encoder over its
        # 1500 frames (no multiple of a tile), cross-attention over them
        ("whisper_enc_B8", wb, enc, enc, 8, 8, 64, 64, False, 0, bf16),
        ("whisper_enc_S1500", 1, enc, enc, 8, 8, 64, 64, False, 0, bf16),
        ("whisper_enc_S1500_f32", 1, enc, enc, 8, 8, 64, 64, False, 0, f32),
        ("whisper_cross_B8_S4096", wb, TRAIN_S, enc, 8, 8, 64, 64, False, 0, bf16),
        ("whisper_cross_S4096", 1, TRAIN_S, enc, 8, 8, 64, 64, False, 0, bf16),
        ("whisper_cross_S100", 1, 100, enc, 8, 8, 64, 64, False, 0, bf16),
        ("whisper_cross_S100_f32", 1, 100, enc, 8, 8, 64, 64, False, 0, f32),
    ]
    rows, worst, fwd_err, repeat = [], {}, {}, {}
    for name, B, S, T, H, G, D, Dv, causal, window, dtype in cases:
        q = _cuda_randn(gen, (B, S, H, D), dtype)
        k, v = _cuda_randn(gen, (B, T, G, D), dtype), _cuda_randn(gen, (B, T, G, Dv), dtype)
        dout = _cuda_randn(gen, (B, S, H, Dv), dtype)
        kw = dict(causal=causal, window=window)
        out, lse = flash_attention_fwd(q, k, v, **kw)
        got = flash_attention_bwd(q, k, v, out, lse, dout, **kw)
        torch.cuda.synchronize()
        out_ref, lse_ref = flash_attention_fwd_ref(q, k, v, **kw)
        want = flash_attention_bwd_ref(q, k, v, out, lse, dout, **kw)
        key = "f32" if dtype == f32 else "bf16"
        row = dict(
            case=name,
            dtype=key,
            widths=[D, Dv],
            out_max_abs_err=_max_err(out, out_ref),
            out_rel_err=_rel_err(out, out_ref),
            lse_max_abs_err=float((lse - lse_ref).abs().max()),
        )
        check(
            row["out_rel_err"] <= TRAIN_OUT_REL_TOL[key],
            f"flash_attention_fwd {name}: the output differs from the plain version: {row}",
        )
        for n, a, b in zip(("dq", "dk", "dv"), got, want):
            row[f"{n}_max_abs_err"] = _max_err(a, b)
            row[f"{n}_rel_err"] = _rel_err(a, b)
            check(
                row[f"{n}_rel_err"] <= TRAIN_BWD_REL_TOL[key],
                f"flash_attention_bwd {name}: {n} differs from the plain version: {row}",
            )
        check(row["lse_max_abs_err"] <= TRAIN_LSE_TOL[key], f"flash lse {name}: {row}")
        worst[name] = max(row[f"{n}_max_abs_err"] for n in ("dq", "dk", "dv"))
        fwd_err[name] = row["out_max_abs_err"]
        if name in (
            "stablelm_B4_S4096",
            "olmoe_B2_S2048",
            "mla_B2_S4096",
            "stablelm3b_B2_S4096",
            "d80_S517_f32",
            "h2o_B2_S8192_window4096",
            "jamba_B2_S4096",
            "whisper_enc_B8",
            "whisper_cross_B8_S4096",
            "dense7b_B2_S4096",
            "vlm_B1_S4096",
        ):
            again = flash_attention_bwd(q, k, v, out, lse, dout, **kw)
            repeat[name] = all(torch.equal(a, b) for a, b in zip(got, again))
            serving_out = flash_attention(q, k, v, **kw)
            repeat[name + "_fwd_lse_vs_serving_fwd"] = torch.equal(out, serving_out)
        rows.append(row)
        del q, k, v, dout, out, lse, got, want, out_ref, lse_ref
    check(all(repeat.values()), f"a second call differs from the first: {repeat}")
    emit(
        "train_kernels",
        cases=rows,
        repeats_bit_for_bit=repeat,
        bounds={"bwd_rel": TRAIN_BWD_REL_TOL, "out_rel": TRAIN_OUT_REL_TOL, "lse": TRAIN_LSE_TOL},
    )
    return {"bwd": worst, "fwd": fwd_err}


#: how ``_flops_per_step`` counts, for the lines that report the share
FLOPS_SHARE_FORMULA = (
    "(6 * (costs.active_params - Vp * d [untied]) + 6 * La * H * (Dqk + Dv) * pairs / S) "
    "* tokens / step_s / 989e12"
)
#: the same for an encoder-decoder stack (``_flops_per_step``)
FLOPS_SHARE_FORMULA_ENCDEC = (
    "3 * costs.forward_flops(cfg, B, S, kind='train', triangular=True) / step_s / 989e12"
)


def _flops_per_step(cfg, tokens: int, seq: int) -> float:
    """Model FLOPs of one training step (no remat recompute): 6 N per token
    for the N active parameters of the matrix products (``analysis.costs.
    active_params``: MoE's top-k experts; all but the embedding table, which
    tied embeddings also use as the output matrix), and 6 La H (Dqk + Dv)
    pairs / S per token for attention's two products in the La attention
    layers over the live (query, key) pairs of a sequence (causal: S (S +
    1) / 2, about 3 La H (Dqk + Dv) S, counted as S^2 / 2; a sliding window
    fewer, ``_window_pairs``).  SSD's chunk products are not counted, as
    the reference's 6 N D yardstick counts none.  An encoder-decoder stack
    (whisper) reads its encoder's frames beside the tokens, so 6 N D does
    not apply: its model FLOPs are 3 forwards (forward and backward, no
    remat recompute) of ``analysis.costs.forward_flops`` with the causal
    triangle, the reference's encoder-decoder terms (the encoder over
    ``encoder_seq_len`` frames a sequence, cross-attention in every decoder
    layer)."""
    from repro_torch.analysis import costs
    from repro_torch.analysis.costs import active_params

    if cfg.is_encoder_decoder:
        B = tokens // seq
        return 3 * costs.forward_flops(cfg, B, seq, kind="train", triangular=True)

    n = active_params(cfg) - (0 if cfg.tie_embeddings else cfg.padded_vocab * cfg.d_model)
    La = cfg.num_attn_layers
    if cfg.use_mla:
        dqk, dv = cfg.qk_nope_dim + cfg.qk_rope_dim, cfg.v_head_dim
    else:
        dqk = dv = cfg.resolved_head_dim
    pairs = _window_pairs(seq, cfg.sliding_window) if cfg.sliding_window else seq * seq / 2
    attn = 6 * La * cfg.num_heads * (dqk + dv) * pairs / seq
    return float((6 * n + attn) * tokens)


def _train_step_check() -> dict:
    """stablelm-1.6b at full width: one step's gradients through the kernels
    and through the plain attention path from one state and batch, then the
    main path, three steps through ``make_train_step`` with the launches
    counted, timed and measured."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.configs.base import SHAPES_BY_NAME, RunConfig
    from repro_torch.data.pipeline import TokenPipeline
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.optim import global_norm
    from repro_torch.train import step as S
    from repro_torch.tree import leaves_with_path

    cfg, run = get_config("stablelm-1.6b"), RunConfig(remat_policy="full")
    check(TRAIN_S == SHAPES_BY_NAME[run.shape].seq_len, f"TRAIN_S is not {run.shape}'s")
    t0 = time.perf_counter()
    state = S.init_train_state(cfg, run, seed=0)
    _tempered(state.model)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    pipe = TokenPipeline(cfg.vocab_size, batch=TRAIN_B, seq_len=TRAIN_S, seed=0)
    batches = [next(pipe) for _ in range(4)]
    grad_fn = S.make_grad_fn(cfg, run)

    def grads_of(impl):
        state.model.impl = impl
        reset_launches()
        t = time.perf_counter()
        grads, m = grad_fn(state, batches[0])
        torch.cuda.synchronize()
        return grads, {k: float(x) for k, x in m.items()}, time.perf_counter() - t

    grads, m_kernel, s_kernel = grads_of("kernel")
    kept = [(p, g.clone()) for p, g in leaves_with_path(grads)]
    norm_kernel = float(global_norm([g for _, g in kept]))
    grads, m_plain, s_plain = grads_of("ref")
    check(sum(LAUNCHES.values()) == 0, f"the plain path launched kernels: {LAUNCHES}")
    norm_plain = float(global_norm(grads))
    leaf_rel = {
        p: float((a - b).norm() / b.norm().clamp_min(1e-30))
        for (p, a), (_, b) in zip(kept, leaves_with_path(grads))
    }
    del kept
    torch.cuda.empty_cache()
    compare = {
        "loss_kernel": m_kernel["loss"],
        "loss_plain": m_plain["loss"],
        "loss_abs_diff": abs(m_kernel["loss"] - m_plain["loss"]),
        "grad_norm_kernel": norm_kernel,
        "grad_norm_plain": norm_plain,
        "grad_norm_rel_diff": abs(norm_kernel - norm_plain) / norm_plain,
        "leaf_rel_diff_max": max(leaf_rel.values()),
        "leaf_rel_diff": leaf_rel,
        "grad_s_kernel": s_kernel,
        "grad_s_plain": s_plain,
        "bounds": TRAIN_STEP_BOUNDS,
    }
    emit("train_step_kernel_vs_plain", **compare)
    summary = {k: v for k, v in compare.items() if k != "leaf_rel_diff"}
    check(
        compare["loss_abs_diff"] <= TRAIN_STEP_BOUNDS["loss_abs"]
        and compare["grad_norm_rel_diff"] <= TRAIN_STEP_BOUNDS["grad_norm_rel"]
        and compare["leaf_rel_diff_max"] <= TRAIN_STEP_BOUNDS["leaf_rel"],
        f"full-width step: kernel and plain paths differ: {summary}",
    )

    # the main path: three train steps through the kernels
    state.model.impl = "kernel"
    step = S.make_train_step(cfg, run, total_steps=run.steps)
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    times, metrics = [], []
    for b in batches[1:]:
        t = time.perf_counter()
        state, m = step(state, b)
        metrics.append({k: float(x) for k, x in m.items()})
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t)
    launches = {k: LAUNCHES[k] for k in ("flash_attention", "flash_attention_bwd")}
    L, tokens = cfg.num_layers, TRAIN_B * TRAIN_S
    want = {"flash_attention": 3 * 2 * L, "flash_attention_bwd": 3 * L}
    check(launches == want, f"train steps launched {launches}, due {want} (full remat)")
    check(
        all(math.isfinite(v) for m in metrics for v in m.values()), f"train metrics: {metrics}"
    )
    step_s = statistics.median(times)
    flops = _flops_per_step(cfg, tokens, TRAIN_S)
    out = {
        "arch": cfg.name,
        "params": cfg.num_params(),
        "batch": TRAIN_B,
        "seq": TRAIN_S,
        "tokens_per_step": tokens,
        "reduced": "train_4k's global batch of 256 cut to 4 sequences; full depth and width",
        "init_s": init_s,
        "step_s": times,
        "step_s_median": step_s,
        "tokens_per_s": tokens / step_s,
        "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
        "model_flops_per_step": flops,
        "model_flops_share": flops / step_s / BF16_OPS_PER_S,
        "model_flops_share_formula": FLOPS_SHARE_FORMULA_ENCDEC
        if cfg.is_encoder_decoder
        else FLOPS_SHARE_FORMULA,
        "metrics": metrics,
        "launches": launches,
        "predicted": want,
    }
    emit("train_step", **out)
    return dict(out, state=state, step=step, batch=batches[0], cfg=cfg, run=run)


def _train_profile(t: dict) -> None:
    """One profiled step of the main path: device time by kernel family,
    the idle share; the optimizer (update and apply) and the cross-entropy
    (forward and backward at the step's logits shape) timed apart between
    CUDA events."""
    import torch

    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.models.layers import cross_entropy
    from repro_torch.optim import lr_schedule, make_optimizer
    from repro_torch.tree import leaves

    state, step, cfg, run = t["state"], t["step"], t["cfg"], t["run"]

    def profiled_step():
        reset_launches()  # device_kernels may run it again: count the last session
        step(state, t["batch"])

    kernels, wall = device_kernels(profiled_step)
    launches = {k: LAUNCHES[k] for k in ("flash_attention", "flash_attention_bwd")}
    check(all(launches.values()), f"the profiled step launched no flash kernel: {launches}")
    fam = {"flash_fwd": 0.0, "flash_bwd": 0.0, "gemm": 0.0, "other": 0.0}
    count = dict.fromkeys(fam, 0)
    for e in kernels:
        n = e.name.lower()
        k = next((f for f in ("flash_fwd", "flash_bwd") if f in n), None)
        if k is None:
            k = "gemm" if any(s in n for s in ("gemm", "nvjet", "cutlass", "xmma")) else "other"
        fam[k] += e.time_range.elapsed_us()
        count[k] += 1
    busy = sum(fam.values())

    _, opt_update = make_optimizer(run.optimizer)
    lr = lr_schedule(
        state.step, base_lr=run.learning_rate, warmup_steps=run.warmup_steps, total_steps=run.steps
    )

    def optimizer():
        updates, _ = opt_update(state.grads, state.opt, state.params, lr)
        with torch.no_grad():
            for p, u in zip(leaves(state.params), leaves(updates)):
                p.sub_(u)

    opt_ms = time_ms(optimizer, 3, warmup=1)
    gen = torch.Generator(device="cuda").manual_seed(8)
    logits = _cuda_randn(gen, (TRAIN_B, TRAIN_S, cfg.padded_vocab), torch.bfloat16)
    logits.requires_grad_(True)
    labels = torch.randint(0, cfg.vocab_size, (TRAIN_B, TRAIN_S), generator=gen, device="cuda")
    ce_ms = time_ms(lambda: cross_entropy(logits, labels, cfg.vocab_size).backward(), 3, warmup=1)
    del logits
    emit(
        "train_profile",
        device_kernels=len(kernels),
        device_busy_ms=busy / 1e3,
        wall_ms_profiled=wall * 1e3,
        device_idle_share=1 - busy / 1e3 / (wall * 1e3) if busy else None,
        flash_fwd_ms=fam["flash_fwd"] / 1e3,
        flash_fwd_us_per_launch=fam["flash_fwd"] / launches["flash_attention"],
        flash_bwd_ms=fam["flash_bwd"] / 1e3,
        flash_bwd_us_per_launch=fam["flash_bwd"] / launches["flash_attention_bwd"],
        flash_bwd_kernels=count["flash_bwd"],
        launches_per_step=launches,
        gemm_ms=fam["gemm"] / 1e3,
        gemm_kernels=count["gemm"],
        other_ms=fam["other"] / 1e3,
        other_kernels=count["other"],
        optimizer_ms_apart=opt_ms,
        cross_entropy_fwd_bwd_ms_apart=ce_ms,
    )


def _train_launcher(arch: str = "stablelm-1.6b", *args: str) -> dict:
    """``python -m repro_torch.launch.train --arch ARCH --steps 16 [args]``
    at full width on the card, in a process of its own; it asserts that the
    loss fell, as the reference launcher does."""
    import os

    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    cmd = [sys.executable, "-m", "repro_torch.launch.train", "--arch", arch]
    cmd += ["--steps", "16", *args]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True, text=True, timeout=900)
    wall = time.perf_counter() - t0
    check(proc.returncode == 0, f"train launcher:\n{proc.stdout[-2000:]}{proc.stderr[-4000:]}")
    line = proc.stdout.strip().splitlines()[-1]
    fields = dict(f.split("=", 1) for f in line.split() if "=" in f)
    out = {
        "command": " ".join(cmd[1:]),
        "output": line,
        "loss_first": float(fields["loss[0]"]),
        "loss_last": float(fields["loss[-1]"]),
        "wall_s": wall,
    }
    check(out["loss_last"] < out["loss_first"], f"the launcher's loss did not fall: {line}")
    emit("train_launcher", **out)
    return out


def _train_crash_resume() -> dict:
    """Crash and resume at full width with 2 of 24 layers (a full-depth
    checkpoint is 19.7 GB of npz): 8 steps uninterrupted; then a run that
    checkpoints at step 4 and fails at step 6, and a run that resumes from
    the checkpoint; the resumed losses against the uninterrupted ones.  The
    checkpoints go to a temporary directory, removed afterwards."""
    import tempfile

    import torch

    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.configs import get_config
    from repro_torch.configs.base import RunConfig
    from repro_torch.train.loop import train_loop

    cfg = replace(get_config("stablelm-1.6b"), num_layers=2)
    run = RunConfig(checkpoint_every=4)
    t0 = time.perf_counter()
    whole = train_loop(cfg, run, steps=8)
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        ck = CheckpointManager(Path(tmp) / "ck", keep=1)
        crashed = False
        try:
            train_loop(cfg, run, steps=8, ckpt=ck, fail_at_step=6)
        except RuntimeError:
            crashed = True
        ck.wait()
        torch.cuda.empty_cache()
        ck_bytes = sum(f.stat().st_size for f in (Path(tmp) / "ck").rglob("*") if f.is_file())
        res = train_loop(cfg, run, steps=8, ckpt=ck)
    torch.cuda.empty_cache()
    check(crashed, "the injected failure did not raise")
    check(res.resumed_from == 4, f"resumed from {res.resumed_from}, not 4")
    diff = max(abs(a - b) for a, b in zip(res.losses, whole.losses[4:]))
    out = {
        "layers": cfg.num_layers,
        "reduced": "2 of 24 layers: a full-depth checkpoint is 19.7 GB of npz",
        "resumed_from": res.resumed_from,
        "losses_resumed": res.losses,
        "losses_uninterrupted": whole.losses[4:],
        "bit_for_bit": res.losses == whole.losses[4:],
        "max_abs_diff": diff,
        "checkpoint_bytes": ck_bytes,
        "wall_s": time.perf_counter() - t0,
    }
    emit("train_crash_resume", **out)
    check(len(res.losses) == 4 and diff <= 1e-5 * abs(whole.losses[-1]), f"resume: {out}")
    return out


def _steps_kernel_vs_plain(
    cfg, B: int, S: int, *, temper: bool, impls=("kernel", "ref"), run=None, batches=None
) -> dict:
    """Three steps of ``run`` (default: AdamW, remat "full") of ``cfg``
    through the kernels and three through the plain attention path
    (``impls``), each from the same seeded init (``wq`` and ``wk``/``w_uk``
    x 1/8 where ``temper``) and the same batches of B x S tokens (the
    pipeline's first three, or ``batches``); per run the metrics, step
    seconds, routing decisions (call for call), launches (the training
    kernels', and every kernel's) and peak memory."""
    import torch

    from repro_torch.configs.base import RunConfig
    from repro_torch.data.pipeline import TokenPipeline
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.train import step as S_

    if batches is None:
        pipe = TokenPipeline(cfg.vocab_size, batch=B, seq_len=S, seed=0)
        batches = [next(pipe) for _ in range(3)]
    runs = {}
    run = run or RunConfig(remat_policy="full")
    for impl in impls:
        t0 = time.perf_counter()
        state = S_.init_train_state(cfg, run, seed=0)
        if temper:
            _tempered(state.model)
        state.model.impl = impl
        step = S_.make_train_step(cfg, run, total_steps=run.steps)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        t0 = time.perf_counter()
        times, metrics = [], []
        with _routes_logged() as routes:
            for b in batches:
                t = time.perf_counter()
                state, m = step(state, b)
                metrics.append({k: float(x) for k, x in m.items()})
                torch.cuda.synchronize()
                times.append(time.perf_counter() - t)
        runs[impl] = dict(
            metrics=metrics,
            routes=routes,
            init_s=init_s,
            step_s=times,
            wall_s=time.perf_counter() - t0,
            peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9,
            launches={k: LAUNCHES[k] for k in ("flash_attention", "flash_attention_bwd")},
            all_launches=dict(LAUNCHES),
        )
        del state, step
        torch.cuda.empty_cache()
    return runs


def _kernel_vs_plain_summary(cfg, runs: dict, B: int, S: int, reduced: str) -> dict:
    """The two runs of ``_steps_kernel_vs_plain`` side by side, checked:
    launches (3 steps x 2 forward and 1 backward per attention layer through the
    kernels, whisper's encoder layers and cross-attentions counted as
    attention layers; none through the plain path), finite metrics; for MoE a
    positive aux loss, the losses and routing decisions within
    ``TRAIN_MOE_BOUNDS``; for a dense stack the losses within
    ``TRAIN_STEP_BOUNDS``."""
    k, p = runs["kernel"], runs["ref"]
    L = cfg.num_attn_layers
    if cfg.is_encoder_decoder:  # each encoder layer's and each cross-attention
        L += cfg.num_encoder_layers + cfg.num_layers
    moe = bool(cfg.moe_num_experts)
    want = {"flash_attention": 3 * 2 * L, "flash_attention_bwd": 3 * L}
    loss_diff = [abs(a["loss"] - b["loss"]) for a, b in zip(k["metrics"], p["metrics"])]
    agreement = _route_agreement(k["routes"], p["routes"]) if moe else None
    bounds = TRAIN_MOE_BOUNDS if moe else {"loss_abs": TRAIN_STEP_BOUNDS["loss_abs"]}
    step_s = statistics.median(k["step_s"])
    flops = _flops_per_step(cfg, B * S, S)
    out = {
        "arch": cfg.name,
        "layers": cfg.num_layers,
        "attention_layers": L,
        "params": cfg.num_params(),
        "reduced": reduced,
        "batch": B,
        "seq": S,
        "metrics_kernel": k["metrics"],
        "metrics_plain": p["metrics"],
        "loss_abs_diff": loss_diff,
        "routes": agreement,
        "init_s": {"kernel": k["init_s"], "plain": p["init_s"]},
        "wall_s": {"kernel": k["wall_s"], "plain": p["wall_s"]},
        "step_s": {"kernel": k["step_s"], "plain": p["step_s"]},
        "step_s_median": step_s,
        "tokens_per_s": B * S / step_s,
        "peak_memory_gb": {"kernel": k["peak_memory_gb"], "plain": p["peak_memory_gb"]},
        "model_flops_per_step": flops,
        "model_flops_share": flops / step_s / BF16_OPS_PER_S,
        "model_flops_share_formula": FLOPS_SHARE_FORMULA_ENCDEC
        if cfg.is_encoder_decoder
        else FLOPS_SHARE_FORMULA,
        "launches": k["launches"],
        "predicted": want,
        "bounds": bounds,
    }
    check(k["launches"] == want, f"{cfg.name} train launches {k['launches']}, due {want}")
    check(sum(p["launches"].values()) == 0, f"the plain {cfg.name} run launched {p['launches']}")
    check(
        all(math.isfinite(v) for m in k["metrics"] + p["metrics"] for v in m.values()),
        f"{cfg.name} train metrics not finite",
    )
    check(max(loss_diff) <= bounds["loss_abs"], f"{cfg.name} losses differ: {loss_diff}")
    if moe:
        check(all(m["aux_loss"] > 0 for m in k["metrics"]), f"{cfg.name} aux loss is not positive")
        check(
            agreement["agreement"] >= bounds["route_agreement"],
            f"{cfg.name} routing differs: {agreement}",
        )
    return out


def _train_moe() -> dict:
    """olmoe-1b-7b at full width with 4 of 16 layers (AdamW's float32 state
    of all 16 is 111 GB), B = 2 x S = 2048: three steps through the kernels
    and three through the plain attention path from one state (the same
    seeded init) and batches; routing decisions compared call for call."""
    from repro_torch.configs import get_config

    cfg = replace(get_config("olmoe-1b-7b"), num_layers=4)
    runs = _steps_kernel_vs_plain(cfg, 2, 2048, temper=False)
    reduced = "4 of 16 layers: AdamW's float32 state of all 16 is 111 GB"
    out = _kernel_vs_plain_summary(cfg, runs, 2, 2048, reduced)
    emit("train_moe", **out)
    return out


def _train_mla() -> dict:
    """deepseek-v2-lite-16b at full width (MLA at QK 192 / V 128, 64 experts
    top-6 plus 2 shared) with ``MLA_TRAIN_LAYERS`` of its 27 layers, B =
    ``MLA_TRAIN_B`` x S = 4096 (train_4k's sequence length), ``wq`` and
    ``w_uk`` tempered as ``serving_mla`` tempers them: three steps through
    the kernels and three through the plain attention path from one state
    and batches; routing decisions compared call for call."""
    from repro_torch.configs import get_config

    cfg = replace(get_config("deepseek-v2-lite-16b"), num_layers=MLA_TRAIN_LAYERS)
    runs = _steps_kernel_vs_plain(cfg, MLA_TRAIN_B, TRAIN_S, temper=True)
    reduced = (
        f"{MLA_TRAIN_LAYERS} of 27 layers (AdamW's float32 parameters, gradients and moments: "
        f"~260 GB at 27, ~44 GB at 4); train_4k's batch of 256 cut to {MLA_TRAIN_B}"
    )
    out = _kernel_vs_plain_summary(cfg, runs, MLA_TRAIN_B, TRAIN_S, reduced)
    emit("train_mla", **out)
    return out


def _train_3b() -> dict:
    """stablelm-3b at full width (32 heads of 80) and ``TRAIN_3B_LAYERS`` of
    its 32 layers (at 32, 2.80 B parameters, AdamW's float32 parameters,
    gradients and moments 44.8 GB), B = ``TRAIN_3B_B`` x S = 4096
    (train_4k's sequence length), ``wq`` and ``wk`` tempered as its serving
    run tempers them: three steps through
    the kernels (the flash forward with lse and the backward at D = 80) and
    three through the plain attention path from one state and batches."""
    from repro_torch.configs import get_config

    cfg = replace(get_config("stablelm-3b"), num_layers=TRAIN_3B_LAYERS)
    runs = _steps_kernel_vs_plain(cfg, TRAIN_3B_B, TRAIN_S, temper=True)
    reduced = (
        f"train_4k's batch of 256 cut to {TRAIN_3B_B}; {TRAIN_3B_LAYERS} of 32 layers (a cut "
        "of the script's time); full width"
    )
    out = _kernel_vs_plain_summary(cfg, runs, TRAIN_3B_B, TRAIN_S, reduced)
    emit("train_3b", **out)
    return out


def _train_dense7b() -> dict:
    """deepseek-7b at full width (32 heads of 128, MHA) with
    ``DENSE7B_TRAIN_LAYERS`` of its 30 layers, B = ``DENSE7B_TRAIN_B`` x S =
    4096, ``wq``/``wk`` tempered as ``serving_dense7b`` tempers them: three
    steps through the kernels and three through the plain attention path
    from one state and batches."""
    from repro_torch.configs import get_config

    cfg = replace(get_config("deepseek-7b"), num_layers=DENSE7B_TRAIN_LAYERS)
    runs = _steps_kernel_vs_plain(cfg, DENSE7B_TRAIN_B, TRAIN_S, temper=True)
    reduced = (
        f"{DENSE7B_TRAIN_LAYERS} of 30 layers (AdamW's float32 parameters, gradients and "
        f"moments: ~111 GB at 30, ~26 GB at 4); train_4k's batch of 256 cut to {DENSE7B_TRAIN_B}"
    )
    out = _kernel_vs_plain_summary(cfg, runs, DENSE7B_TRAIN_B, TRAIN_S, reduced)
    emit("train_dense7b", **out)
    return out


def _train_vlm() -> dict:
    """chameleon-34b at full width (64 query heads over 8 groups at 128 with
    QK-norm) with ``VLM_TRAIN_LAYERS`` of its 48 layers, B =
    ``VLM_TRAIN_B`` x S = 4096, untempered as ``serving_vlm`` runs it: three
    steps through the kernels and three through the plain attention path
    from one state and batches."""
    from repro_torch.configs import get_config

    cfg = replace(get_config("chameleon-34b"), num_layers=VLM_TRAIN_LAYERS)
    runs = _steps_kernel_vs_plain(cfg, VLM_TRAIN_B, TRAIN_S, temper=False)
    reduced = (
        f"{VLM_TRAIN_LAYERS} of 48 layers (AdamW's float32 parameters, gradients and moments: "
        f"~549 GB at 48, ~39 GB at 2); train_4k's batch of 256 cut to {VLM_TRAIN_B} (the "
        "plain path's float32 scores: 4.3 GB a sequence and layer)"
    )
    out = _kernel_vs_plain_summary(cfg, runs, VLM_TRAIN_B, TRAIN_S, reduced)
    emit("train_vlm", **out)
    return out


def _train_swa() -> dict:
    """h2o-danube-1.8b at full width (GQA 32:8 at 80, window 4096) and
    ``SWA_TRAIN_LAYERS`` of its 24 layers (at 24, 1.84 B parameters and
    29.4 GB of AdamW's float32 state), remat
    full, ``wq``/``wk`` tempered as its serving run tempers them, sequences
    of ``SWA_TRAIN_S`` = 8192 (at train_4k's 4096 the window never masks):
    three steps through the kernels and three through the plain path at B
    ``SWA_TRAIN_B`` from one state and batches, then three timed kernel
    steps at B ``SWA_TIMED_B`` (tokens/s, model-FLOPs share over the
    window's live pairs, peak memory)."""
    from repro_torch.configs import get_config

    cfg = replace(get_config("h2o-danube-1.8b"), num_layers=SWA_TRAIN_LAYERS)
    S = SWA_TRAIN_S
    runs = _steps_kernel_vs_plain(cfg, SWA_TRAIN_B, S, temper=True)
    reduced = (
        f"S {S} in place of train_4k's 4096 (its window of 4096 masks nothing there); kernel "
        f"against plain at B {SWA_TRAIN_B}, timed at B {SWA_TIMED_B} (train_4k's batch of 256 "
        f"cut); {SWA_TRAIN_LAYERS} of 24 layers (a cut of the script's time); "
        "full width"
    )
    out = _kernel_vs_plain_summary(cfg, runs, SWA_TRAIN_B, S, reduced)
    timed = _steps_kernel_vs_plain(cfg, SWA_TIMED_B, S, temper=True, impls=("kernel",))["kernel"]
    step_s = statistics.median(timed["step_s"])
    flops = _flops_per_step(cfg, SWA_TIMED_B * S, S)
    L = cfg.num_layers
    check(
        timed["launches"] == {"flash_attention": 3 * 2 * L, "flash_attention_bwd": 3 * L},
        f"timed h2o-danube launches {timed['launches']}",
    )
    out["timed"] = {
        "batch": SWA_TIMED_B,
        "seq": S,
        "step_s": timed["step_s"],
        "step_s_median": step_s,
        "tokens_per_s": SWA_TIMED_B * S / step_s,
        "model_flops_per_step": flops,
        "model_flops_share": flops / step_s / BF16_OPS_PER_S,
        "peak_memory_gb": timed["peak_memory_gb"],
        "launches": timed["launches"],
        "losses": [m["loss"] for m in timed["metrics"]],
        "window_pairs_per_sequence": _window_pairs(S, cfg.sliding_window),
        "causal_pairs_per_sequence": S * (S + 1) // 2,
    }
    emit("train_swa", **out)
    return out


def _train_ssm() -> dict:
    """mamba2-1.3b at full width and depth (48 SSD layers, tied embeddings,
    1.34 B parameters; AdamW's float32 state 21.4 GB), the default run
    (remat full), B ``SSM_TRAIN_B`` x S 4096: three steps through
    ``make_train_step`` on one batch (``SSM_TRAIN_B`` says why) with no
    kernel launch (SSD has no TPU kernel), finite losses and the third
    below the first two (which read the same parameters); step time,
    tokens/s, model-FLOPs share and peak memory."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import RunConfig
    from repro_torch.data.pipeline import TokenPipeline

    cfg = get_config("mamba2-1.3b")
    run = RunConfig()
    batch = next(TokenPipeline(cfg.vocab_size, batch=SSM_TRAIN_B, seq_len=TRAIN_S, seed=0))
    r = _steps_kernel_vs_plain(
        cfg, SSM_TRAIN_B, TRAIN_S, temper=False, impls=("kernel",), run=run, batches=[batch] * 3
    )["kernel"]
    losses = [m["loss"] for m in r["metrics"]]
    step_s = statistics.median(r["step_s"])
    flops = _flops_per_step(cfg, SSM_TRAIN_B * TRAIN_S, TRAIN_S)
    out = {
        "arch": cfg.name,
        "layers": cfg.num_layers,
        "params": cfg.num_params(),
        "reduced": f"train_4k's batch of 256 cut to {SSM_TRAIN_B}; full width and depth",
        "batch": SSM_TRAIN_B,
        "seq": TRAIN_S,
        "optimizer": run.optimizer,
        "warmup_steps": run.warmup_steps,
        "batches": "one batch, three times",
        "first_two_losses_equal": losses[0] == losses[1],
        "metrics": r["metrics"],
        "init_s": r["init_s"],
        "step_s": r["step_s"],
        "step_s_median": step_s,
        "tokens_per_s": SSM_TRAIN_B * TRAIN_S / step_s,
        "peak_memory_gb": r["peak_memory_gb"],
        "model_flops_per_step": flops,
        "model_flops_share": flops / step_s / BF16_OPS_PER_S,
        "model_flops_share_formula": FLOPS_SHARE_FORMULA_ENCDEC
        if cfg.is_encoder_decoder
        else FLOPS_SHARE_FORMULA,
        "launches": r["all_launches"],
    }
    emit("train_ssm", **out)
    check(sum(r["all_launches"].values()) == 0, f"mamba2 training launched {r['all_launches']}")
    check(
        all(math.isfinite(v) for m in r["metrics"] for v in m.values()), "mamba2 metrics not finite"
    )
    check(losses[2] < min(losses[:2]), f"mamba2's loss did not fall: {losses}")
    return out


def _train_hybrid() -> dict:
    """jamba's super-block at the reduced width ``HYBRID_TRAIN_WIDTHS`` (one
    attention layer, 7 SSD layers, 4 dense FFNs and 4 MoE layers of 16
    experts top-2; 3.0 B parameters), the reference's per-arch defaults
    (Adafactor, remat full: each position's mixer and FFN checkpointed),
    ``wq``/``wk`` tempered, B ``HYBRID_TRAIN_B`` x S 4096: three steps
    through the kernels and three through the plain path from one state and
    batches (launches 6 / 3, losses within ``TRAIN_MOE_BOUNDS``, routing
    agreement), step time and peak memory."""
    from repro_torch.configs import get_config
    from repro_torch.launch.train import default_run_config

    arch = "jamba-1.5-large-398b"
    cfg = replace(get_config(arch), **HYBRID_TRAIN_WIDTHS)
    run = default_run_config(arch)
    runs = _steps_kernel_vs_plain(cfg, HYBRID_TRAIN_B, TRAIN_S, temper=True, run=run)
    reduced = (
        "one super-block at d 2048, 16 heads over 2 groups at 128, FFN and expert width 6144, "
        "16 experts top-2, SSD heads of 64 at state 128, vocab 65536 (no form of jamba trains "
        f"on one card at full width); train_4k's batch of 256 cut to {HYBRID_TRAIN_B}"
    )
    out = _kernel_vs_plain_summary(cfg, runs, HYBRID_TRAIN_B, TRAIN_S, reduced)
    out["optimizer"], out["remat_policy"] = run.optimizer, run.remat_policy
    emit("train_hybrid", **out)
    return out


def _train_whisper() -> dict:
    """whisper-base at full width and depth, B ``WHISPER_TRAIN_B`` x 4096
    decoder tokens, each sequence beside 1500 frames drawn from a seeded
    generator (the audio stub's input), AdamW, remat full (each encoder
    layer checkpointed on its own, weight products saved, as the
    reference's), every attention's ``wq``/``wk`` tempered as in serving:
    three steps through the kernels and three through the plain path from
    one state and batches (launches 108 / 54: 18 attentions a step, each
    forward twice under remat), losses within ``TRAIN_STEP_BOUNDS``, step
    time, tokens/s, model-FLOPs share, peak memory."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import TokenPipeline

    cfg, B = get_config("whisper-base"), WHISPER_TRAIN_B
    pipe = TokenPipeline(cfg.vocab_size, batch=B, seq_len=TRAIN_S, seed=0)
    gen = torch.Generator(device="cuda").manual_seed(1500)
    shape = (B, cfg.encoder_seq_len, cfg.d_model)
    batches = []
    for _ in range(3):
        batch = dict(next(pipe))
        batch["frames"] = torch.randn(shape, generator=gen, device="cuda")
        batches.append(batch)
    runs = _steps_kernel_vs_plain(cfg, B, TRAIN_S, temper=True, batches=batches)
    reduced = f"train_4k's batch of 256 cut to {B}; full width and depth"
    out = _kernel_vs_plain_summary(cfg, runs, B, TRAIN_S, reduced)
    out["frames_per_sequence"] = cfg.encoder_seq_len
    emit("train_whisper", **out)
    return out


def _train_timing_whisper(wh: dict, errs: dict) -> list:
    """Rows 4te / 5e (the encoder's forward with its log-sum-exp and the
    backward: B ``WHISPER_TRAIN_B`` x S = T = 1500, non-causal) and 4tx /
    5x (cross-attention: B x S 4096 over T 1500), 8 heads of 64, bf16,
    against their plain versions and SDPA (the backward under autograd);
    bounds by operations over the S x T pairs."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention.ops import flash_attention_bwd, flash_attention_fwd
    from repro_torch.kernels.flash_attention.ref import (
        flash_attention_bwd_ref,
        flash_attention_fwd_ref,
    )

    from repro_torch.configs import get_config

    cfg = get_config("whisper-base")
    gen = torch.Generator(device="cuda").manual_seed(27)
    bf16, rows, kw = torch.bfloat16, [], dict(causal=False)
    B, H, G, D = WHISPER_TRAIN_B, cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    T, launches, path = cfg.encoder_seq_len, wh["launches"], "whisper-base-train"
    # backward launches of each kind in the 3 steps: one a layer a step
    per_kind = {"encoder": cfg.num_encoder_layers * 3, "cross": cfg.num_layers * 3}
    check(
        launches["flash_attention_bwd"] == per_kind["encoder"] + 2 * per_kind["cross"],
        f"whisper train launches {launches}: the rows count a third of them each",
    )
    cases = (("encoder", T, "whisper_enc_B8"), ("cross", TRAIN_S, "whisper_cross_B8_S4096"))
    for kind, S, case in cases:
        q, dout = (_cuda_randn(gen, (B, S, H, D), bf16) for _ in range(2))
        k, v = (_cuda_randn(gen, (B, T, G, D), bf16) for _ in range(2))
        out, lse = flash_attention_fwd(q, k, v, **kw)
        qt = q.transpose(1, 2).contiguous().requires_grad_(True)
        kt, vt = (t.transpose(1, 2).contiguous().requires_grad_(True) for t in (k, v))
        o = F.scaled_dot_product_attention(qt, kt, vt)
        dot = dout.transpose(1, 2).contiguous()
        check(_rel_err(o.detach().transpose(1, 2), out) <= 2e-2, f"SDPA yardstick, {kind}")
        shape = dict(B=B, S=S, T=T, H=H, G=G, D=D, causal=False)
        nbytes, ops = _flash_bytes_ops(B, S, T, H, G, D, lse=True)
        fwd = {
            "kernel": lambda: flash_attention_fwd(q, k, v, **kw),
            "plain": lambda: flash_attention_fwd_ref(q, k, v, **kw),
            "library": lambda: F.scaled_dot_product_attention(qt, kt, vt),
        }
        row = _timing_row(
            "flash_attention",
            fwd,
            10,
            nbytes,
            ops,
            2 * per_kind[kind],
            errs["fwd"][case],
            "F.scaled_dot_product_attention (non-causal)",
            shape=dict(shape, lse=True),
            path=f"{path}-{kind}",
            queued=True,
        )
        row["bound_share"] = row["bound_ms"] / row["ms"]
        rows.append(row)
        nbytes, ops = _flash_bytes_ops(B, S, T, H, G, D, bwd=True)
        bwd = {
            "kernel": lambda: flash_attention_bwd(q, k, v, out, lse, dout, **kw),
            "plain": lambda: flash_attention_bwd_ref(q, k, v, out, lse, dout, **kw),
            "library": lambda: torch.autograd.grad(o, (qt, kt, vt), dot, retain_graph=True),
        }
        row = _timing_row(
            "flash_attention_bwd",
            bwd,
            10,
            nbytes,
            ops,
            per_kind[kind],
            errs["bwd"][case],
            "torch.autograd.grad of F.scaled_dot_product_attention (non-causal)",
            shape=shape,
            path=f"{path}-{kind}",
            queued=True,
        )
        row["tflops_7_products"] = 14 * D * B * H * S * T / (row["ms"] * 1e-3) / 1e12
        row["bound_share"] = row["bound_ms"] / row["ms"]
        rows.append(row)
        del q, k, v, dout, out, lse, qt, kt, vt, o, dot
        torch.cuda.empty_cache()
    return rows


def _train_timing_heads(
    path: str,
    case: str,
    launches: dict,
    errs: dict,
    B: int,
    H: int,
    G: int,
    D: int,
    seed: int,
    **shape,
) -> list:
    """Timing rows of the training forward with its log-sum-exp and of the
    backward at B x 4096, H query heads over G groups of D, causal, bf16,
    against their plain versions and SDPA (K/V repeated per query head where
    G < H; the backward under autograd); bounds by operations over the
    causal pairs.  ``shape`` adds notes to each row's shape."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention.ops import flash_attention_bwd, flash_attention_fwd
    from repro_torch.kernels.flash_attention.ref import (
        flash_attention_bwd_ref,
        flash_attention_fwd_ref,
    )

    gen = torch.Generator(device="cuda").manual_seed(seed)
    bf16, rows, S = torch.bfloat16, [], TRAIN_S
    q, dout = (_cuda_randn(gen, (B, S, H, D), bf16) for _ in range(2))
    k, v = (_cuda_randn(gen, (B, S, G, D), bf16) for _ in range(2))
    out, lse = flash_attention_fwd(q, k, v)
    qt = q.transpose(1, 2).contiguous().requires_grad_(True)
    kt, vt = (
        t.transpose(1, 2).repeat_interleave(H // G, dim=1).contiguous().requires_grad_(True)
        for t in (k, v)
    )
    o = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)
    dot = dout.transpose(1, 2).contiguous()
    check(_rel_err(o.detach().transpose(1, 2), out) <= 2e-2, f"SDPA forward yardstick at {path}")
    repeated = ", K/V repeated per head" if G < H else ""
    pairs = B * H * S * (S + 1) // 2
    shape = dict(B=B, S=S, H=H, G=G, D=D, causal=True, **shape)
    fwd = {
        "kernel": lambda: flash_attention_fwd(q, k, v),
        "plain": lambda: flash_attention_fwd_ref(q, k, v),
        "library": lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True),
    }
    row = _timing_row(
        "flash_attention",
        fwd,
        10,
        2 * B * S * (H + 2 * G) * D + 2 * B * S * H * D + 4 * B * H * S,
        4 * D * pairs,
        launches["flash_attention"],
        errs["fwd"][case],
        "F.scaled_dot_product_attention(is_causal=True)" + repeated,
        shape=dict(shape, lse=True),
        path=path,
        queued=True,
    )
    row["bound_share"] = row["bound_ms"] / row["ms"]
    rows.append(row)
    bwd = {
        "kernel": lambda: flash_attention_bwd(q, k, v, out, lse, dout),
        "plain": lambda: flash_attention_bwd_ref(q, k, v, out, lse, dout),
        "library": lambda: torch.autograd.grad(o, (qt, kt, vt), dot, retain_graph=True),
    }
    row = _timing_row(
        "flash_attention_bwd",
        bwd,
        10,
        2 * B * S * (2 * H + 2 * G) * D * 2 + 4 * B * H * S,
        10 * D * pairs,
        launches["flash_attention_bwd"],
        errs["bwd"][case],
        "torch.autograd.grad of F.scaled_dot_product_attention(is_causal=True)",
        shape=shape,
        path=path,
        queued=True,
    )
    row["tflops_7_products"] = 14 * D * pairs / (row["ms"] * 1e-3) / 1e12
    row["bound_share"] = row["bound_ms"] / row["ms"]
    rows.append(row)
    del q, k, v, dout, out, lse, qt, kt, vt, o, dot
    torch.cuda.empty_cache()
    return rows


def _train_timing_hybrid(hyb: dict, errs: dict) -> list:
    """Rows 4tj and 5j: the hybrid run's shape, B 2 x S 4096, 16 heads over
    2 groups at 128 (8 a group)."""
    return _train_timing_heads(
        "jamba-1.5-large-398b-train",
        "jamba_B2_S4096",
        hyb["launches"],
        errs,
        HYBRID_TRAIN_B,
        16,
        2,
        128,
        17,
    )


def _train_timing_swa(swa: dict, errs: dict) -> list:
    """Timing rows of the training forward with its log-sum-exp (row 4tw) and
    of the backward (row 5w) at h2o-danube's timed shape, B 2 x S 8192, 32
    heads over 8 groups at 80, window 4096: against their plain versions and
    SDPA with the window as ``attn_mask`` (K/V repeated per query head);
    bounds over the window's live (query, key) pairs."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention.ops import flash_attention_bwd, flash_attention_fwd
    from repro_torch.kernels.flash_attention.ref import (
        attention_mask,
        flash_attention_bwd_ref,
        flash_attention_fwd_ref,
    )

    gen = torch.Generator(device="cuda").manual_seed(13)
    bf16, rows = torch.bfloat16, []
    B, S, H, G, D, w = SWA_TIMED_B, SWA_TRAIN_S, 32, 8, 80, 4096
    case, launches = "h2o_B2_S8192_window4096", swa["timed"]["launches"]
    q, dout = (_cuda_randn(gen, (B, S, H, D), bf16) for _ in range(2))
    k, v = (_cuda_randn(gen, (B, S, G, D), bf16) for _ in range(2))
    out, lse = flash_attention_fwd(q, k, v, window=w)
    qt = q.transpose(1, 2).contiguous().requires_grad_(True)
    kt, vt = (
        t.transpose(1, 2).repeat_interleave(H // G, dim=1).contiguous().requires_grad_(True)
        for t in (k, v)
    )
    amask = attention_mask(S, S, causal=True, window=w, device="cuda")
    o = F.scaled_dot_product_attention(qt, kt, vt, attn_mask=amask)
    dot = dout.transpose(1, 2).contiguous()
    check(_rel_err(o.detach().transpose(1, 2), out) <= 2e-2, "SDPA windowed forward yardstick")
    pairs = B * H * _window_pairs(S, w)
    fwd = {
        "kernel": lambda: flash_attention_fwd(q, k, v, window=w),
        "plain": lambda: flash_attention_fwd_ref(q, k, v, window=w),
        "library": lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=amask),
    }
    row = _timing_row(
        "flash_attention",
        fwd,
        10,
        2 * B * S * (H + 2 * G) * D + 2 * B * S * H * D + 4 * B * H * S,
        4 * D * pairs,
        launches["flash_attention"],
        errs["fwd"][case],
        "F.scaled_dot_product_attention with the window as attn_mask (K/V repeated per head)",
        shape=dict(B=B, S=S, H=H, G=G, D=D, causal=True, window=w, lse=True),
        path="h2o-danube-1.8b-train",
        queued=True,
    )
    row["bound_share"] = row["bound_ms"] / row["ms"]
    rows.append(row)
    bwd = {
        "kernel": lambda: flash_attention_bwd(q, k, v, out, lse, dout, window=w),
        "plain": lambda: flash_attention_bwd_ref(q, k, v, out, lse, dout, window=w),
        "library": lambda: torch.autograd.grad(o, (qt, kt, vt), dot, retain_graph=True),
    }
    row = _timing_row(
        "flash_attention_bwd",
        bwd,
        10,
        2 * B * S * (2 * H + 2 * G) * D * 2 + 4 * B * H * S,
        10 * D * pairs,
        launches["flash_attention_bwd"],
        errs["bwd"][case],
        "torch.autograd.grad of F.scaled_dot_product_attention with the window as attn_mask",
        shape=dict(B=B, S=S, H=H, G=G, D=D, causal=True, window=w),
        path="h2o-danube-1.8b-train",
        queued=True,
    )
    row["tflops_7_products"] = 14 * D * pairs / (row["ms"] * 1e-3) / 1e12
    row["bound_share"] = row["bound_ms"] / row["ms"]
    rows.append(row)
    del q, k, v, dout, out, lse, qt, kt, vt, o, dot, amask
    torch.cuda.empty_cache()
    return rows


def _train_timing(main: dict, moe: dict, dense3b: dict, errs: dict) -> list:
    """Timing rows of the flash backward at stablelm-1.6b's, olmoe-1b-7b's
    and stablelm-3b's training shapes (bf16, causal) against its plain
    version and the backward of ``scaled_dot_product_attention`` under
    autograd on the same tensors; the forward with its log-sum-exp at the
    two stablelm shapes against the serving forward (no lse), the plain
    version and SDPA."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention.ops import (
        flash_attention,
        flash_attention_bwd,
        flash_attention_fwd,
    )
    from repro_torch.kernels.flash_attention.ref import (
        flash_attention_bwd_ref,
        flash_attention_fwd_ref,
    )

    gen = torch.Generator(device="cuda").manual_seed(9)
    bf16, rows = torch.bfloat16, []
    shapes = [
        ("stablelm-1.6b-train", TRAIN_B, TRAIN_S, 32, 64, main["launches"], "stablelm_B4_S4096"),
        ("olmoe-1b-7b-train", 2, 2048, 16, 128, moe["launches"], "olmoe_B2_S2048"),
        (
            "stablelm-3b-train",
            TRAIN_3B_B,
            TRAIN_S,
            32,
            80,
            dense3b["launches"],
            "stablelm3b_B2_S4096",
        ),
    ]
    for path, B, S, H, D, launches, case in shapes:
        q, k, v, dout = (_cuda_randn(gen, (B, S, H, D), bf16) for _ in range(4))
        out, lse = flash_attention_fwd(q, k, v)
        qt, kt, vt = (x.transpose(1, 2).contiguous().requires_grad_(True) for x in (q, k, v))
        o = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)
        dot = dout.transpose(1, 2).contiguous()
        lib = torch.autograd.grad(o, (qt, kt, vt), dot, retain_graph=True)
        want = flash_attention_bwd_ref(q, k, v, out, lse, dout)
        for a, b in zip(lib, want):
            check(_rel_err(a.transpose(1, 2), b) <= 2e-2, f"SDPA backward yardstick at {path}")
        fns = {
            "kernel": lambda: flash_attention_bwd(q, k, v, out, lse, dout),
            "plain": lambda: flash_attention_bwd_ref(q, k, v, out, lse, dout),
            "library": lambda: torch.autograd.grad(o, (qt, kt, vt), dot, retain_graph=True),
        }
        row = _timing_row(
            "flash_attention_bwd",
            fns,
            10,
            2 * 8 * B * S * H * D + 4 * B * H * S,
            10 * D * H * B * S * (S + 1) // 2,
            launches["flash_attention_bwd"],
            errs["bwd"][case],
            "torch.autograd.grad of F.scaled_dot_product_attention(is_causal=True)",
            shape=dict(B=B, S=S, H=H, G=H, D=D, causal=True),
            path=path,
            queued=True,
        )
        # the kernel's own work: S and dP in both passes, 7 products in all
        work = 14 * D * H * B * S * (S + 1) // 2
        row["tflops_7_products"] = work / (row["ms"] * 1e-3) / 1e12
        row["bound_share"] = row["bound_ms"] / row["ms"]
        rows.append(row)
        if path.startswith("stablelm"):
            fwd = {
                "kernel": lambda: flash_attention_fwd(q, k, v),
                "plain": lambda: flash_attention_fwd_ref(q, k, v),
                "library": lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True),
            }
            row = _timing_row(
                "flash_attention",
                fwd,
                10,
                2 * 4 * B * S * H * D + 4 * B * H * S,
                4 * D * H * B * S * (S + 1) // 2,
                launches["flash_attention"],
                errs["fwd"][case],
                "F.scaled_dot_product_attention(is_causal=True)",
                shape=dict(B=B, S=S, H=H, G=H, D=D, causal=True, lse=True),
                path=path,
                queued=True,
            )
            # with and without lse in alternating rounds of queued calls
            pairs = [
                (queued_ms(fwd["kernel"], 10), queued_ms(lambda: flash_attention(q, k, v), 10))
                for _ in range(FLASH_ROUNDS)
            ]
            done = [p for p in pairs if None not in p]
            row["no_lse_ms"] = statistics.median(b for _, b in done) if done else None
            emit(
                "train_flash_lse",
                path=path,
                rounds_ms=pairs,
                with_lse_median_ms=statistics.median(a for a, _ in done) if done else None,
                without_lse_median_ms=row["no_lse_ms"],
            )
            rows.append(row)
        del q, k, v, dout, out, lse, qt, kt, vt, o, dot, lib, want
        torch.cuda.empty_cache()
    return rows


def _sdpa_for_mla(qt, kt, vt, dot, scale):
    """The first of SDPA's backends that runs forward and backward with V
    narrower than Q and K (``[B, H, S, D]`` operands): ``(its name, the
    forward, the output under autograd, V as SDPA takes it)``.  Where none
    does, V padded with zeros to Q's width, the output cut back to V's,
    under PyTorch's own choice of backend."""
    import torch
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    names = ("FLASH_ATTENTION", "EFFICIENT_ATTENTION", "CUDNN_ATTENTION")
    for name in names:
        backend = getattr(SDPBackend, name, None)
        if backend is None:
            continue

        def fwd(backend=backend):
            with sdpa_kernel([backend]):
                return F.scaled_dot_product_attention(qt, kt, vt, is_causal=True, scale=scale)

        try:
            o = fwd()
            torch.autograd.grad(o, (qt, kt, vt), dot, retain_graph=True)
            torch.cuda.synchronize()
        except RuntimeError:
            continue
        return name, fwd, o, vt
    pad = qt.shape[-1] - vt.shape[-1]
    vp = F.pad(vt.detach(), (0, pad)).requires_grad_(True)

    def padded():
        o = F.scaled_dot_product_attention(qt, kt, vp, is_causal=True, scale=scale)
        return o[..., : vt.shape[-1]]

    return f"none takes Dv != Dk: V padded with zeros to {qt.shape[-1]}", padded, padded(), vp


def _train_timing_mla(mla: dict, errs: dict) -> list:
    """Rows 4tm and 5m: the forward with its log-sum-exp and the backward at
    deepseek-v2-lite-16b's training shape (``MLA_TRAIN_B`` x 4096, 16 heads,
    q/k 192, v 128, causal, bf16) against their plain versions and SDPA
    (forward; backward under autograd) on the same tensors, bounded by
    operations: 2 (Dqk + Dv) FLOP per unmasked pair forward, 2 (3 Dqk +
    2 Dv) backward (five products)."""
    import torch

    from repro_torch.kernels.flash_attention.ops import flash_attention_bwd, flash_attention_fwd
    from repro_torch.kernels.flash_attention.ref import (
        flash_attention_bwd_ref,
        flash_attention_fwd_ref,
    )

    gen = torch.Generator(device="cuda").manual_seed(10)
    bf16 = torch.bfloat16
    B, S, H, Dk, Dv = MLA_TRAIN_B, TRAIN_S, 16, 192, 128
    q, k = (_cuda_randn(gen, (B, S, H, Dk), bf16) for _ in range(2))
    v, dout = (_cuda_randn(gen, (B, S, H, Dv), bf16) for _ in range(2))
    scale = Dk**-0.5
    out, lse = flash_attention_fwd(q, k, v, scale=scale)
    qt, kt, vt = (x.transpose(1, 2).contiguous().requires_grad_(True) for x in (q, k, v))
    dot = dout.transpose(1, 2).contiguous()
    backend, lib_fwd, o, v_lib = _sdpa_for_mla(qt, kt, vt, dot, scale)
    lib = torch.autograd.grad(o, (qt, kt, v_lib), dot, retain_graph=True)
    want = flash_attention_bwd_ref(q, k, v, out, lse, dout, scale=scale)
    check(_rel_err(o.transpose(1, 2), out) <= 2e-2, "SDPA forward yardstick at (192, 128)")
    for a, b in zip(lib, want):
        a = a[..., : b.shape[-1]]  # a padded V's gradient: its first Dv columns
        check(_rel_err(a.transpose(1, 2), b) <= 2e-2, "SDPA backward yardstick at (192, 128)")
    pairs = B * H * S * (S + 1) // 2
    shape = dict(B=B, S=S, H=H, G=H, D=Dk, Dv=Dv, causal=True)
    path, case = "deepseek-v2-lite-16b-train", "mla_B2_S4096"
    fwd = {
        "kernel": lambda: flash_attention_fwd(q, k, v, scale=scale),
        "plain": lambda: flash_attention_fwd_ref(q, k, v, scale=scale),
        "library": lib_fwd,
    }
    row_f = _timing_row(
        "flash_attention",
        fwd,
        10,
        2 * B * S * H * (2 * Dk + 2 * Dv) + 4 * B * H * S,
        2 * (Dk + Dv) * pairs,
        mla["launches"]["flash_attention"],
        errs["fwd"][case],
        f"F.scaled_dot_product_attention(is_causal=True), backend {backend}",
        shape=dict(shape, lse=True),
        path=path,
        queued=True,
    )
    bwd = {
        "kernel": lambda: flash_attention_bwd(q, k, v, out, lse, dout, scale=scale),
        "plain": lambda: flash_attention_bwd_ref(q, k, v, out, lse, dout, scale=scale),
        "library": lambda: torch.autograd.grad(o, (qt, kt, v_lib), dot, retain_graph=True),
    }
    row_b = _timing_row(
        "flash_attention_bwd",
        bwd,
        10,
        2 * B * S * H * (4 * Dk + 4 * Dv) + 4 * B * H * S,
        2 * (3 * Dk + 2 * Dv) * pairs,
        mla["launches"]["flash_attention_bwd"],
        errs["bwd"][case],
        f"torch.autograd.grad of F.scaled_dot_product_attention(is_causal=True), backend {backend}",
        shape=shape,
        path=path,
        queued=True,
    )
    # the kernel's own work: dQ pass S, dP, dQ; dK/dV pass S^T twice, dP^T, dV, dK
    row_b["tflops_8_products"] = 2 * (5 * Dk + 3 * Dv) * pairs / (row_b["ms"] * 1e-3) / 1e12
    row_b["bound_share"] = row_b["bound_ms"] / row_b["ms"]
    row_f["bound_share"] = row_f["bound_ms"] / row_f["ms"]
    del q, k, v, dout, out, lse, qt, kt, vt, o, dot, lib, want, v_lib
    torch.cuda.empty_cache()
    return [row_f, row_b]


def phase_training() -> list:
    """The training path on the card; returns its kernels-line rows."""
    import torch

    t0 = time.perf_counter()
    errs = _train_kernel_checks()
    main = _train_step_check()
    _train_profile(main)
    del main["state"], main["step"]
    torch.cuda.empty_cache()
    _train_launcher()
    _train_launcher("deepseek-v2-lite-16b", "--layers", str(MLA_TRAIN_LAYERS))
    _train_crash_resume()
    moe = _train_moe()
    mla = _train_mla()
    t3b = time.perf_counter()
    dense3b = _train_3b()
    emit("train_3b_seconds", seconds=time.perf_counter() - t3b)
    tswa = time.perf_counter()
    swa = _train_swa()
    emit("train_swa_seconds", seconds=time.perf_counter() - tswa)
    t = time.perf_counter()
    _train_ssm()
    emit("train_ssm_seconds", seconds=time.perf_counter() - t)
    t = time.perf_counter()
    hyb = _train_hybrid()
    emit("train_hybrid_seconds", seconds=time.perf_counter() - t)
    t = time.perf_counter()
    wh = _train_whisper()
    emit("train_whisper_seconds", seconds=time.perf_counter() - t)
    t = time.perf_counter()
    d7 = _train_dense7b()
    emit("train_dense7b_seconds", seconds=time.perf_counter() - t)
    t = time.perf_counter()
    vlm = _train_vlm()
    emit("train_vlm_seconds", seconds=time.perf_counter() - t)
    rows = _train_timing(main, moe, dense3b, errs) + _train_timing_mla(mla, errs)
    rows += _train_timing_swa(swa, errs) + _train_timing_hybrid(hyb, errs)
    rows += _train_timing_whisper(wh, errs)
    # rows 4tk / 5k and 4tc / 5c
    rows += _train_timing_heads(
        "deepseek-7b-train", "dense7b_B2_S4096", d7["launches"], errs, DENSE7B_TRAIN_B, 32, 32,
        128, 19,
    )
    rows += _train_timing_heads(
        "chameleon-34b-train", "vlm_B1_S4096", vlm["launches"], errs, VLM_TRAIN_B, 64, 8, 128,
        23, qk_norm=True,
    )
    emit("training", seconds=time.perf_counter() - t0)
    return rows


#: olmoe-1b-7b's MoE layer on the expert-parallel path in ``multi_device``:
#: full width (64 experts of 1024, top-8, d 2048), bf16, B x S tokens
MULTI_MOE_B, MULTI_MOE_S = 4, 1024


def phase_multi_device() -> dict:
    """The multi-device layer on one card: a one-rank NCCL group (an
    in-memory store) and a 1 x 1 ``DeviceMesh("cuda")``.  Every collective
    of a world of one is the identity, so each check is bit for bit against
    the unsharded path: ``simulate_batch(shard=True)`` on the golden batch
    (its lanes gathered by NCCL) against ``shard=False``; olmoe-1b-7b's MoE
    layer at full width on the expert-parallel path (DTensor weights laid
    out by the rules, TP-only and FSDP) against ``moe_ffn`` with no mesh, and
    the collectives it issues (``analysis.collectives``); ``build_cell`` for
    stablelm-1.6b at train_4k, whose per-rank state bytes must equal the
    whole state's; the sharded decode step against the unsharded one
    (``_multi_device_decode``); the SSD mixer split over its heads
    (``_multi_device_ssd``).  The group is torn down at the end, failure
    or not."""
    import numpy as np
    import torch
    import torch.distributed as dist
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    from repro_torch.analysis.collectives import CollectiveCounter
    from repro_torch.configs import get_config
    from repro_torch.core.simulator import simulate_batch
    from repro_torch.data import golden_batch
    from repro_torch.distributed import sharding as SH
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.specs import build_cell, tree_shard_nbytes
    from repro_torch.models import moe
    from repro_torch.models.sharding_hooks import set_activation_sharder

    out = {}
    check(not dist.is_initialized(), "a process group is already initialised")
    torch.cuda.set_device(0)
    dist.init_process_group(
        "nccl", store=dist.HashStore(), rank=0, world_size=1, device_id=torch.device("cuda", 0)
    )
    try:
        mesh = make_host_mesh()
        traces, prms = golden_batch()
        sharded = simulate_batch(traces, prms, shard=True)
        plain = simulate_batch(traces, prms, shard=False)
        bad = [k for k in plain if not np.array_equal(sharded[k], plain[k])]
        check(not bad and set(sharded) == set(plain), f"sharded golden batch differs: {bad}")
        out["sim"] = {"lanes": len(prms), "keys": len(plain), "bit_for_bit": not bad}

        cfg = get_config("olmoe-1b-7b")
        gen = torch.Generator(device="cuda").manual_seed(2048)
        bf16 = torch.bfloat16
        p = {
            k: (_cuda_randn(gen, s.shape, bf16) * s.shape[-2] ** -0.5).to(bf16)
            for k, s in moe.moe_specs(cfg).items()
        }
        x = _cuda_randn(gen, (MULTI_MOE_B, MULTI_MOE_S, cfg.d_model), bf16)
        want, want_aux = moe.moe_ffn(cfg, p, x)
        out["moe"] = {}
        for fsdp in (False, True):
            rules = SH.param_rules(cfg, mesh, fsdp=fsdp)
            specs = {
                k: SH.spec_for_param(s.axes, s.shape, rules, mesh)
                for k, s in moe.moe_specs(cfg).items()
            }
            pd = {k: distribute_tensor(p[k], mesh, SH.placements(specs[k], mesh)) for k in p}
            xd = distribute_tensor(x, mesh, [Shard(0), Replicate()])
            set_activation_sharder(None, mesh=mesh, fsdp=fsdp)
            try:
                with CollectiveCounter() as counter:
                    got, aux = moe.moe_ffn(cfg, pd, xd)
                    placed = [str(pl) for pl in got.placements]
                    got, aux = got.full_tensor(), aux.full_tensor()
                torch.cuda.synchronize()
            finally:
                set_activation_sharder(None)
            same = torch.equal(got, want) and torch.equal(aux, want_aux)
            name = "fsdp" if fsdp else "tp"
            out["moe"][name] = {
                "bit_for_bit": same,
                "max_abs_err": float((got.float() - want.float()).abs().max()),
                "out_placements": placed,
                "collectives": counter.stats(),
                "records": counter.records,
            }
            check(same, f"expert-parallel olmoe layer ({name}) differs from the unsharded path")
        del p, x, want, pd, xd, got
        torch.cuda.empty_cache()
        out["decode"] = _multi_device_decode(mesh)
        out["ssd"] = timed_phase("multi_device_ssd", _multi_device_ssd, mesh)

        cell = build_cell("stablelm-1.6b", "train_4k", mesh)
        set_activation_sharder(None)
        (state_abs, batch_abs), (state_sh, batch_sh) = cell.args, cell.in_shardings
        per_rank = tree_shard_nbytes(state_abs, state_sh)
        whole = sum(t.numel() * t.element_size() for t in _leaves(state_abs))
        out["cell"] = {
            "arch": "stablelm-1.6b",
            "shape": "train_4k",
            "state_bytes_per_rank": per_rank,
            "state_bytes_whole": whole,
            "batch_bytes_per_rank": tree_shard_nbytes(batch_abs, batch_sh),
            "meta": cell.meta,
        }
        check(per_rank == whole, f"train_4k state on the 1 x 1 mesh: {per_rank} B, whole {whole} B")
    finally:
        dist.destroy_process_group()
    emit("multi_device", **out)
    return out


#: the sharded decode step in ``multi_device``: stablelm-1.6b at full width,
#: 2 of its 24 layers, B 2, a 256-token prompt in a 272-slot cache
MULTI_DECODE_LAYERS, MULTI_DECODE_S, MULTI_DECODE_T = 2, 256, 272


def _multi_device_decode(mesh) -> dict:
    """The sharded decode step (``distributed.serve``) on the 1 x 1 mesh,
    the cache laid out by decode_32k's rules (the sequence over ``model``),
    against the unsharded cache step on the same cache: logits and the
    cache after the step, and the collectives it issues."""
    import torch

    from repro_torch.analysis.collectives import CollectiveCounter
    from repro_torch.configs import get_config
    from repro_torch.configs.base import SHAPES_BY_NAME, RunConfig
    from repro_torch.distributed.serve import make_sharded_decode, shard_cache
    from repro_torch.distributed.train import shard_train_state
    from repro_torch.launch import serve
    from repro_torch.launch.dryrun import _State
    from repro_torch.models import model as M

    cfg = serve.cut(get_config("stablelm-1.6b"), layers=MULTI_DECODE_LAYERS)
    B, S, T = 2, MULTI_DECODE_S, MULTI_DECODE_T
    model = _tempered(M.init_params(cfg, 0))
    gen = torch.Generator(device="cuda").manual_seed(1)
    tokens = torch.randint(0, cfg.vocab_size, (B, S), generator=gen, device="cuda")
    _, cache = M.prefill_cache(model, tokens, M.init_cache(cfg, B, T))
    tok = torch.randint(0, cfg.vocab_size, (B, 1), generator=gen, device="cuda")
    sharded = shard_cache(cfg, mesh, SHAPES_BY_NAME["decode_32k"], cache, B, T)
    placed = {k: str(v.placements) for k, v in sharded.items()}
    smodel = _tempered(M.init_params(cfg, 0))
    smodel = shard_train_state(_State(smodel), RunConfig(), mesh, fsdp=False).model
    want, cache = M.decode_step_cache(model, cache, tok, S)
    with CollectiveCounter() as counter:
        got, sharded = make_sharded_decode(cfg, mesh)(smodel, sharded, tok, S)
        torch.cuda.synchronize()
    err = _max_err(got, want)
    same_cache = all(torch.equal(sharded[k].full_tensor(), cache[k]) for k in cache)
    check(err <= 3e-2 and same_cache, f"sharded decode step: {err}, cache alike {same_cache}")
    return {"arch": cfg.name, "layers": cfg.num_layers, "batch": B, "pos": S, "slots": T,
            "bit_for_bit": torch.equal(got, want), "max_abs_err": err,
            "cache_bit_for_bit": same_cache, "cache_placements": placed,
            "collectives": counter.stats()}


#: the SSD mixer split over its heads in ``multi_device``: mamba2-1.3b at
#: full width, 2 of its 48 layers, B 2 x 512 prompts prefilled into the
#: contiguous cache, then 8 decode steps
MULTI_SSD_LAYERS, MULTI_SSD_B, MULTI_SSD_S, MULTI_SSD_STEPS = 2, 2, 512, 8
#: the split mixer against the unsharded step: logits within this (bf16
#: compute; the gated norm's sum of squares is taken per rank and
#: all-reduced, a float32 sum that may round another way: one bf16 step of
#: a norm's output moves the logits by ~1e-2), the state within this share
#: of its largest entry, the bf16 conv window within one bf16 step
MULTI_SSD_LOGIT_TOL, MULTI_SSD_STATE_TOL = 3e-2, 1e-2


def _multi_device_ssd(mesh) -> dict:
    """mamba2-1.3b's sharded prefill and decode steps (``distributed.serve``)
    on the 1 x 1 mesh, the cache laid out by decode_32k's rules (the state
    over its heads, the conv window over its channels): the mixer runs split
    over its heads (``models.ssm.SSMBlock._mix_heads``, counted here as the
    kernel wrappers count their launches), held to the unsharded cache
    steps on the same weights, tokens and cache, call by call; and one
    decode step's collectives."""
    import torch

    from repro_torch.analysis.collectives import CollectiveCounter
    from repro_torch.configs import get_config
    from repro_torch.configs.base import SHAPES_BY_NAME, RunConfig
    from repro_torch.distributed.serve import make_sharded_decode, make_sharded_prefill, shard_cache
    from repro_torch.distributed.train import shard_train_state
    from repro_torch.launch import serve
    from repro_torch.launch.dryrun import _State
    from repro_torch.models import model as M
    from repro_torch.models import ssm

    cfg = serve.cut(get_config("mamba2-1.3b"), layers=MULTI_SSD_LAYERS)
    check(ssm.heads_split(cfg, mesh), "the 1 x 1 mesh does not split mamba2's heads")
    B, S, steps = MULTI_SSD_B, MULTI_SSD_S, MULTI_SSD_STEPS
    gen = torch.Generator(device="cuda").manual_seed(3)
    prompt = torch.randint(0, cfg.vocab_size, (B, S), generator=gen, device="cuda")
    toks = torch.randint(0, cfg.vocab_size, (steps, B, 1), generator=gen, device="cuda")
    model = M.init_params(cfg, 0)
    logits, cache = M.prefill_cache(model, prompt, M.init_cache(cfg, B, S))
    want = [logits]
    for i in range(steps):
        logits, cache = M.decode_step_cache(model, cache, toks[i], S + i)
        want.append(logits)
    del model
    smodel = shard_train_state(_State(M.init_params(cfg, 0)), RunConfig(), mesh, fsdp=False).model
    scache = shard_cache(
        cfg, mesh, SHAPES_BY_NAME["decode_32k"], M.init_cache(cfg, B, S), B, S
    )
    placed = {k: str(v.placements) for k, v in scache.items()}
    calls = [0]
    split = ssm.SSMBlock._mix_heads

    def counted(self, *args, **kwargs):
        calls[0] += 1
        return split(self, *args, **kwargs)

    ssm.SSMBlock._mix_heads = counted
    try:
        logits, scache = make_sharded_prefill(cfg, mesh)(smodel, {"tokens": prompt}, scache)
        got = [logits]
        decode = make_sharded_decode(cfg, mesh)
        for i in range(steps):
            if i == steps - 1:
                with CollectiveCounter() as counter:
                    logits, scache = decode(smodel, scache, toks[i], S + i)
                    torch.cuda.synchronize()
            else:
                logits, scache = decode(smodel, scache, toks[i], S + i)
            got.append(logits)
    finally:
        ssm.SSMBlock._mix_heads = split
    want_calls = MULTI_SSD_LAYERS * (1 + steps)
    check(calls[0] == want_calls, f"split SSD mixer ran {calls[0]} times, want {want_calls}")
    errs = [_max_err(g, w) for g, w in zip(got, want)]
    state = {k: scache[k].full_tensor() for k in cache}
    state_err = _max_err(state["ssm"], cache["ssm"]) / float(cache["ssm"].abs().max())
    conv_ok = torch.allclose(state["conv"].float(), cache["conv"].float(), rtol=2**-7, atol=0)
    check(
        max(errs) <= MULTI_SSD_LOGIT_TOL and state_err <= MULTI_SSD_STATE_TOL and conv_ok,
        f"split SSD mixer: logits {max(errs)}, state {state_err}, conv window {conv_ok}",
    )
    return {
        "arch": cfg.name, "layers": cfg.num_layers, "batch": B, "prompt": S, "steps": steps,
        "split_calls": calls[0],
        "bit_for_bit": all(torch.equal(g, w) for g, w in zip(got, want)),
        "max_abs_err": max(errs), "max_abs_err_by_call": errs,
        "cache_bit_for_bit": all(torch.equal(state[k], cache[k]) for k in cache),
        "state_rel_err": state_err, "cache_placements": placed,
        "decode_collectives": counter.stats(),
    }


def _leaves(tree) -> list:
    if isinstance(tree, dict):
        return [x for k in tree for x in _leaves(tree[k])]
    return [tree]


def timed_phase(name: str, fn, *args):
    """``fn(*args)``, printing the host seconds it took as ``<name>_seconds``."""
    t0 = time.perf_counter()
    out = fn(*args)
    emit(f"{name}_seconds", seconds=time.perf_counter() - t0)
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        msg = "chip_smoke: torch.cuda.is_available() is false; this needs a CUDA card"
        print(msg, file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    import repro_torch  # noqa: F401  (fails outside a checkout of the repository)
    from repro_torch.analysis import costs

    global HBM_BYTES_PER_S, BF16_OPS_PER_S
    HBM_BYTES_PER_S, BF16_OPS_PER_S = costs.HBM_BW, costs.PEAK_FLOPS

    t_start = time.perf_counter()
    phase_build()
    max_abs_err = timed_phase("kernels", phase_kernels)
    timed_phase("golden", phase_golden)
    main_path = timed_phase("fig4_table1", phase_full_width)
    timed_phase("profile", phase_profile, main_path)
    kernel = timed_phase("timing", phase_timing, main_path["launches"], max_abs_err)
    llm_errs = timed_phase("llm_kernels", phase_llm_kernels)
    timed_phase("moe_whitening", phase_moe_whitening)
    rows = []
    for phase, lengths in (
        (phase_serving, (128, 517, 1024)),
        (phase_serving_moe, (1024,)),
        (phase_serving_mla, (128, 517, 1024)),
        (phase_serving_dense7b, (1024,)),
        (phase_serving_vlm, (1024,)),
        (phase_serving_3b, (1024,)),
    ):
        t0 = time.perf_counter()
        serving = phase()
        phase_serving_profile(serving)
        rows += phase_llm_timing(serving, llm_errs, flash_lengths=lengths)
        emit(serving["phase"] + "_seconds", seconds=time.perf_counter() - t0)
        del serving
        torch.cuda.empty_cache()
    rows += phase_serving_swa_ssm(llm_errs)
    rows += phase_serving_hybrid(llm_errs)
    rows += phase_serving_whisper(llm_errs)
    rows += timed_phase("serving_cache", phase_serving_cache, llm_errs)
    rows += phase_training()
    torch.cuda.empty_cache()
    timed_phase("multi_device", phase_multi_device)
    torch.cuda.empty_cache()
    # the scale path last: its profiled windows hold ~10^5 kernel records each
    sweep = timed_phase("sweep", phase_sweep)
    cosim = {
        **timed_phase("cosim", phase_cosim),
        **timed_phase("cosim_scale", phase_cosim_scale),
        **timed_phase("fuzz", phase_fuzz),
    }
    kernel["launches_by_path"] = {
        "fig4_x16": main_path["launches"],
        **{f"sweep_{k}": v["arbiter_launches"] for k, v in sweep.items()},
        **{f"cosim_{k}": v["arbiter_launches"] for k, v in cosim.items()},
    }
    kernel["sweep_device_us_by_lanes"] = {
        f"{k} (B={v['lanes']})": v["arbiter_device_us_mean"] for k, v in sweep.items()
    }
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
