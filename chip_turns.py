#!/usr/bin/env python3
"""Serving throughput of several checkouts of the port, in turns, on one card.

    python3 chip_turns.py PARENT/src CHANGE/src CHANGE/src PARENT/src
    python3 chip_turns.py --latent PARENT/src CHANGE/src CHANGE/src PARENT/src

Each argument is the ``src`` directory of a checkout; each runs in a process
of its own, in the order given (parent, change, change, parent compares two
commits on one card).  A process builds its checkout's serving kernels
first, then serves stablelm-1.6b and olmoe-1b-7b at full width with
``launch.serve.FULL`` (random weights and prompts from seed 0, as
``chip_smoke.py``'s serving phases) and prints one JSON line: prompt tokens
per second, ms per decode step and output tokens per second per model.

With ``--stream`` a process instead runs the streaming sweep of
``chip_smoke.py``'s scale grid (48 points on one shared schedule, chunks of
32 lanes, the P² percentiles streamed) with its checkout's simulator and
arbiter kernel: a warm-up run, then three counted runs (lane-cycles per
host second, ``chip_smoke.counted``) and ``chip_smoke.steady_window`` at
B = 32 (device kernels, busy time and idle share of a steady cycle).

    python3 chip_turns.py --stream PARENT/src CHANGE/src CHANGE/src PARENT/src

With ``--latent`` a process instead times MLA's latent paged call at
``PERF.md``'s row 3m (deepseek-v2-lite-16b's first wave at mid-decode,
``chip_smoke._mla_lengths``; bf16 q [8, 16, 576] over a layer view of a
2048-block pool of 27 latent rows a token, from seed 1) with its checkout's
kernels: five rounds of 200 queued calls (``chip_smoke.queued_ms``) and the
profiler's device time per call by kernel name.

With ``--copy`` a process instead times ``banked_copy`` at ``PERF.md``'s
seven rows (bf16 bursts of 16-token blocks into a 2048-block pool, from seed
1): five rounds of 50 queued calls warm (the same burst into the same rows)
and cold (``chip_smoke.copy_cold_ms``: bursts and rows rotated over twice
L2), and the queued floor of an empty kernel of the launch shape where the
checkout has one:

    python3 chip_turns.py --copy PARENT/src CHANGE/src CHANGE/src PARENT/src
"""

import subprocess
import sys
from pathlib import Path

RUN = r"""
import json, sys
sys.path.insert(0, sys.argv[1])
import torch
from repro_torch.configs import get_config
from repro_torch.kernels import _build
from repro_torch.launch import serve
from repro_torch.models import model as M

_build.build(["banked_copy", "paged_attention", "flash_attention"])  # before any timing
out = {"src": sys.argv[1], "card": torch.cuda.get_device_name(0)}
for arch in ("stablelm-1.6b", "olmoe-1b-7b"):
    cfg = get_config(arch)
    model = M.init_params(cfg, 0)
    eng, reqs = serve.new_engine(cfg, model, serve.FULL, serve.make_prompts(cfg, serve.FULL))
    s = serve.serve(eng, reqs)
    keys = ("prefill_tokens_per_s", "decode_ms_per_step", "out_tokens_per_s", "steps")
    out[arch] = {k: s[k] for k in keys}
    del model, eng
    torch.cuda.empty_cache()
print(json.dumps(out))
"""


RUN_LATENT = r"""
import json, statistics, sys
sys.path.insert(0, sys.argv[1])
sys.path.insert(1, sys.argv[2])
import torch
from chip_smoke import _cuda_randn, _mla_lengths, _unique_tables, device_kernels, queued_ms
from repro_torch.kernels import _build
from repro_torch.kernels.paged_attention.ops import paged_attention

_build.build(["paged_attention"])  # before any timing
gen = torch.Generator(device="cuda").manual_seed(1)
lens = _mla_lengths()
pool = _cuda_randn(gen, (2048, 16, 27, 576), torch.bfloat16)
kv = pool[:, :, 0, None]
tbl = _unique_tables(gen, 8, 128, 2048, [-(-n // 16) for n in lens])
ln = torch.tensor(lens, dtype=torch.int32, device="cuda")
q = _cuda_randn(gen, (8, 16, 576), torch.bfloat16)
call = lambda: paged_attention(q, kv, kv[..., :512], tbl, ln, scale=192**-0.5)
call()
rounds = [queued_ms(call, 200) * 1e3 for _ in range(5)]
kernels, _ = device_kernels(lambda: [call() for _ in range(50)])
by_name = {}
for e in kernels:
    by_name[e.name[:60]] = by_name.get(e.name[:60], 0.0) + e.time_range.elapsed_us() / 50
out = {"src": sys.argv[1], "card": torch.cuda.get_device_name(0), "lengths": lens}
out.update(queued_us=rounds, queued_median_us=statistics.median(rounds))
out["device_us_per_call_by_kernel"] = by_name
print(json.dumps(out))
"""


RUN_STREAM = r"""
import json, sys
from dataclasses import replace
sys.path.insert(0, sys.argv[1])
sys.path.insert(1, sys.argv[2])
import torch
from chip_smoke import counted, steady_window
from repro_torch.core.simulator import SCHEDULE_PIPELINE, SimParams, batch_envelope, simulate_batch
from repro_torch.data import scale_grid_fields
from repro_torch.kernels import _build
from repro_torch.scenarios import urban_perception

_build.build(["bank_arbiter"])  # before any timing
sched = urban_perception().compile().schedule()
grid = [SimParams(stages=SCHEDULE_PIPELINE, **f) for f in scale_grid_fields()]
env = batch_envelope(grid)
pin = dict(slots_override=env.slots_per_master, inflight_override=env.inflight_slots)
run = lambda: simulate_batch([sched], grid, chunk=32)
run()
rates = []
for _ in range(3):
    _, wall, launches, stepped = counted(run)
    rates.append(stepped * 32 / wall)
window = steady_window(
    lambda n: simulate_batch(
        [sched], [replace(p, max_cycles=n, early_exit=False, **pin) for p in grid[:32]]
    )
)
out = {"src": sys.argv[1], "card": torch.cuda.get_device_name(0), "lanes": 32}
out.update(lane_cycles_per_s=rates, stepped_cycles=stepped, **window)
print(json.dumps(out))
"""


RUN_COPY = r"""
import json, statistics, sys
sys.path.insert(0, sys.argv[1])
sys.path.insert(1, sys.argv[2])
import torch
from chip_smoke import COPY_BURSTS, _cuda_randn, _unique_tables, copy_cold_ms, queued_ms
from repro_torch.kernels import _build
from repro_torch.kernels.banked_copy import ops

_build.build(["banked_copy"])  # before any timing
# PERF.md's banked_copy rows: (blocks, W), bf16, blocks of 16 tokens
ROWS = {row: (nblk, W) for row, nblk, W, *_ in COPY_BURSTS.values()}
floor = getattr(ops, "floor_launch", None)
gen = torch.Generator(device="cuda").manual_seed(1)
out = {"src": sys.argv[1], "card": torch.cuda.get_device_name(0), "rows": {}}
for name, (nblk, W) in ROWS.items():
    pool = torch.empty((2048, 16, W), dtype=torch.bfloat16, device="cuda")
    burst = _cuda_randn(gen, (1, nblk, 16, W), torch.bfloat16)
    tbl = _unique_tables(gen, 1, nblk, 2048, [nblk])
    want = pool.clone()
    want[tbl[0].long()] = burst[0]
    ops.banked_copy(pool, burst, tbl)
    same = torch.equal(pool.view(torch.int16), want.view(torch.int16))
    assert same, f"row {name}: the kernel disagrees with the burst"
    del want
    warm = lambda: ops.banked_copy(pool, burst, tbl)
    us = lambda ms: None if ms is None else ms * 1e3
    rounds = [(us(queued_ms(warm, 50)), us(copy_cold_ms(pool, burst, gen))) for _ in range(5)]
    row = dict(warm_us=[w for w, _ in rounds], cold_us=[c for _, c in rounds])
    for key in ("warm_us", "cold_us"):
        done = [x for x in row[key] if x is not None]
        row[key.replace("_us", "_median_us")] = statistics.median(done) if done else None
    if floor is not None:
        row["floor_us"] = us(queued_ms(lambda: floor(pool, burst, tbl), 50))
    out["rows"][name] = row
    del pool, burst
    torch.cuda.empty_cache()
print(json.dumps(out))
"""


def main(argv) -> int:
    modes = (["--latent"], ["--stream"], ["--copy"])
    mode = argv[0] if argv[:1] in modes else None
    srcs = argv[1:] if mode else argv
    here = str(Path(__file__).resolve().parent)
    for src in srcs:
        script = {
            "--latent": [RUN_LATENT, src, here],
            "--stream": [RUN_STREAM, src, here],
            "--copy": [RUN_COPY, src, here],
        }.get(mode, [RUN, src])
        r = subprocess.run([sys.executable, "-c", *script], capture_output=True, text=True)
        if r.returncode != 0:
            print(r.stderr[-4000:], file=sys.stderr)
            return r.returncode
        print(r.stdout.strip().splitlines()[-1], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
