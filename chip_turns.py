#!/usr/bin/env python3
"""Serving throughput of several checkouts of the port, in turns, on one card.

    python3 chip_turns.py PARENT/src CHANGE/src CHANGE/src PARENT/src

Each argument is the ``src`` directory of a checkout; each runs in a process
of its own, in the order given (parent, change, change, parent compares two
commits on one card).  A process builds its checkout's serving kernels
first, then serves stablelm-1.6b and olmoe-1b-7b at full width with
``launch.serve.FULL`` (random weights and prompts from seed 0, as
``chip_smoke.py``'s serving phases) and prints one JSON line: prompt tokens
per second, ms per decode step and output tokens per second per model.
"""

import json
import subprocess
import sys

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


def main(srcs) -> int:
    for src in srcs:
        r = subprocess.run([sys.executable, "-c", RUN, src], capture_output=True, text=True)
        if r.returncode != 0:
            print(r.stderr[-4000:], file=sys.stderr)
            return r.returncode
        print(r.stdout.strip().splitlines()[-1], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
