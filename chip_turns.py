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

With ``--latent`` a process instead times MLA's latent paged call at
``PERF.md``'s row 3m (deepseek-v2-lite-16b's first wave at mid-decode,
``chip_smoke._mla_lengths``; bf16 q [8, 16, 576] over a layer view of a
2048-block pool of 27 latent rows a token, from seed 1) with its checkout's
kernels: five rounds of 200 queued calls (``chip_smoke.queued_ms``) and the
profiler's device time per call by kernel name.
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


def main(argv) -> int:
    latent = argv[:1] == ["--latent"]
    srcs = argv[1:] if latent else argv
    here = str(Path(__file__).resolve().parent)
    for src in srcs:
        script = [RUN_LATENT, src, here] if latent else [RUN, src]
        r = subprocess.run([sys.executable, "-c", *script], capture_output=True, text=True)
        if r.returncode != 0:
            print(r.stderr[-4000:], file=sys.stderr)
            return r.returncode
        print(r.stdout.strip().splitlines()[-1], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
