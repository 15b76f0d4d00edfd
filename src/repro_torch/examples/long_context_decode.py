"""Sub-quadratic long-context decode: a Mamba2 (SSD) smoke model decodes with
an O(1) state while an equivally-sized attention model's cache grows
linearly; the port's copy of ``examples/long_context_decode.py``.

  PYTHONPATH=src python -m repro_torch.examples.long_context_decode [--device cpu]

The state's bytes are summed over the port's cache tensors after the
prefill; the decode is a plain loop over ``decode_step_cache``, which
updates the cache in place (the script jits its step and donates the cache).
"""

from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs import get_config, smoke
from repro_torch.examples import device_arg
from repro_torch.models import model as M

#: sequences, prompt tokens and decode steps of the script
B, PROMPT, STEPS = 2, 8, 64


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    return [tree]


def run(*, device=None) -> dict:
    """``smoke(mamba2-1.3b)`` (weights from seed 0): a prompt of zeros,
    then ``STEPS`` greedy decode steps; the cache's bytes after the prefill."""
    cfg = smoke(get_config("mamba2-1.3b"))
    model = M.init_params(cfg, 0, device=device)
    cache = M.init_cache(cfg, B, PROMPT, device=model.device)
    tokens = torch.zeros((B, PROMPT), dtype=torch.int32, device=model.device)
    _, cache = M.prefill_cache(model, tokens, cache)
    state_bytes = sum(x.numel() * x.element_size() for x in _leaves(cache))
    tok = torch.zeros((B, 1), dtype=torch.int32, device=model.device)
    t0 = time.time()
    for i in range(PROMPT, PROMPT + STEPS):
        lg, cache = M.decode_step_cache(model, cache, tok, i)
        tok = torch.argmax(lg[:, -1:], -1).to(torch.int32)[:, 0:1] if lg.ndim == 3 else tok
    if model.device.type == "cuda":
        torch.cuda.synchronize(model.device)
    return {"tokens": STEPS, "seconds": time.time() - t0, "state_bytes": state_bytes}


def text(result: dict) -> str:
    r = result
    return (
        f"decoded {r['tokens']} tokens in {r['seconds']:.2f}s with a constant "
        f"{r['state_bytes'] / 1024:.1f} KiB recurrent state "
        f"(an attention cache would grow linearly with context)\n"
    )


def check(result: dict) -> None:
    """The script asserts nothing."""


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.examples.long_context_decode")
    device_arg(ap)
    args = ap.parse_args(argv)
    result = run(device=args.device)
    print(text(result), end="")
    check(result)


if __name__ == "__main__":
    main()
