"""Quickstart: train a reduced config end-to-end on the card; the port's copy
of ``examples/quickstart.py``.

  PYTHONPATH=src python -m repro_torch.examples.quickstart [--arch stablelm-1.6b] [--device cpu]

The run writes no checkpoint: the port's ``RunConfig`` defaults
``checkpoint_dir`` to ``""`` (the reference's names ``/tmp/repro_ckpt``),
and, as in the script, the loop is given no checkpoint manager.
"""

from __future__ import annotations

import argparse
import time

import numpy as np

from repro_torch.configs import get_config, smoke
from repro_torch.configs.base import RunConfig
from repro_torch.examples import device_arg
from repro_torch.train.loop import train_loop


def run(*, arch: str = "stablelm-1.6b", steps: int = 40, device=None) -> dict:
    """``steps`` training steps of ``smoke(arch)`` under the default
    ``RunConfig``; the mean loss of the first and of the last five."""
    cfg = smoke(get_config(arch))
    t0 = time.time()
    res = train_loop(cfg, RunConfig(arch=arch), steps=steps, device=device)
    return {
        "arch": arch,
        "loss_head": float(np.mean(res.losses[:5])),
        "loss_tail": float(np.mean(res.losses[-5:])),
        "steps_run": res.steps_run,
        "seconds": time.time() - t0,
    }


def text(result: dict) -> str:
    r = result
    return (
        f"{r['arch']}: loss {r['loss_head']:.3f} -> {r['loss_tail']:.3f} "
        f"in {r['steps_run']} steps ({r['seconds']:.1f}s)\n"
    )


def check(result: dict) -> None:
    assert result["loss_tail"] < result["loss_head"], "training did not reduce the loss"


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.examples.quickstart")
    ap.add_argument("--arch", default="stablelm-1.6b")
    ap.add_argument("--steps", type=int, default=40)
    device_arg(ap)
    args = ap.parse_args(argv)
    result = run(arch=args.arch, steps=args.steps, device=args.device)
    print(text(result), end="")
    check(result)


if __name__ == "__main__":
    main()
