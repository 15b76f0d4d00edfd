"""Batched serving with the BankedKVPool: continuous batching, QoS-isolated
KV blocks, deterministic round-robin admission; the port's copy of
``examples/serve_batch.py``.

  PYTHONPATH=src python -m repro_torch.examples.serve_batch [--arch mamba2-1.3b] [--device cpu]
"""

from __future__ import annotations

import argparse
import time

import numpy as np

from repro_torch.configs import get_config, smoke
from repro_torch.examples import device_arg
from repro_torch.models import model as M
from repro_torch.serving.engine import ServingEngine

#: the script's engine: 4 slots of 64 tokens in blocks of 8
ENGINE = dict(max_batch=4, max_len=64, block_size=8)


def run(*, arch: str = "stablelm-1.6b", requests: int = 8, device=None) -> dict:
    """``requests`` prompts of 4..15 tokens (seed 0), 8 new tokens each,
    served by ``smoke(arch)`` with weights from seed 0."""
    cfg = smoke(get_config(arch))
    params = M.init_params(cfg, 0, device=device)
    eng = ServingEngine(cfg, params, **ENGINE)
    rng = np.random.default_rng(0)
    reqs = [
        eng.submit(rng.integers(0, cfg.vocab_size, int(rng.integers(4, 16))), max_new_tokens=8)
        for _ in range(requests)
    ]
    t0 = time.time()
    eng.run(max_steps=500)
    return {
        "arch": arch,
        "done": sum(r.done for r in reqs),
        "requests": len(reqs),
        "tokens": sum(len(r.out_tokens) for r in reqs),
        "seconds": time.time() - t0,
        "imbalance": eng.pool.imbalance(),
        "isolation": eng.pool.check_isolation(),
    }


def text(result: dict) -> str:
    r = result
    return (
        f"{r['arch']}: {r['done']}/{r['requests']} requests done, {r['tokens']} tokens in "
        f"{r['seconds']:.1f}s; pool imbalance "
        f"{r['imbalance']:.2f}, isolation "
        f"{'OK' if r['isolation'] else 'VIOLATED'}\n"
    )


def check(result: dict) -> None:
    assert result["done"] == result["requests"]


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.examples.serve_batch")
    ap.add_argument("--arch", default="stablelm-1.6b")
    ap.add_argument("--requests", type=int, default=8)
    device_arg(ap)
    args = ap.parse_args(argv)
    result = run(arch=args.arch, requests=args.requests, device=args.device)
    print(text(result), end="")
    check(result)


if __name__ == "__main__":
    main()
