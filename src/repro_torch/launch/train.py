"""Training launcher.

    PYTHONPATH=src python -m repro_torch.launch.train --smoke --device cpu --steps 50
    PYTHONPATH=src python -m repro_torch.launch.train --arch stablelm-1.6b --steps 16
    PYTHONPATH=src python -m repro_torch.launch.train --arch deepseek-v2-lite-16b --layers 4
    PYTHONPATH=src python -m repro_torch.launch.train --arch stablelm-3b --steps 16
    PYTHONPATH=src python -m repro_torch.launch.train --arch h2o-danube-1.8b --steps 16

``--smoke`` trains the reduced config; without it the full config trains on
the one CUDA card (stablelm-1.6b: 1.64 B float32 parameters with their AdamW
moments, 26.3 GB; stablelm-3b: 2.80 B, 44.8 GB), where the reference
launcher refuses for lack of a TPU runtime.  ``--arch`` takes any of
``repro_torch.configs.list_archs()`` but mamba2-1.3b, whose SSM training
comes with the hybrid stacks (the training forward refuses it): h2o-danube-
1.8b trains with its 4096-token sliding window (1.84 B parameters, 29.4 GB
with AdamW's moments).  ``--layers N`` cuts the stack to its
first N layers at full width: deepseek-v2-lite-16b's float32 parameters,
gradients and AdamW moments take ~260 GB at its 27 layers, ~44 GB at 4;
deepseek-7b's ~111 GB at 30 layers, chameleon-34b's ~549 GB at 48.  The loop
is the reference's: sequences of 64 tokens, batches of ``max(2, 2 *
microbatches)``, checkpoints every ``max(10, steps // 4)`` steps into
``--ckpt-dir`` (none without it), auto-resume.  Attention runs through the
hand-written kernels (on the CPU, their plain versions).  It asserts that the
loss fell, as the reference launcher does.
"""

from __future__ import annotations

import argparse
import dataclasses
import time

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs import get_config, smoke
from repro_torch.configs.base import RunConfig
from repro_torch.train.loop import train_loop


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="stablelm-1.6b", help="one of configs.list_archs()")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--layers", type=int, default=0, help="cut the stack to N layers (0: all)")
    ap.add_argument("--ckpt-dir", default=RunConfig.checkpoint_dir)
    ap.add_argument("--optimizer", default="adamw")
    ap.add_argument("--grad-compression", default="none")
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--device", default=None, help="default: the CUDA card; 'cpu' for the host")
    args = ap.parse_args(argv)

    run = RunConfig(
        arch=args.arch,
        steps=args.steps,
        optimizer=args.optimizer,
        grad_compression=args.grad_compression,
        microbatches=args.microbatches,
        checkpoint_dir=args.ckpt_dir,
        checkpoint_every=max(10, args.steps // 4),
    )
    cfg = get_config(run.arch)
    if args.smoke:
        cfg = smoke(cfg)
    if args.layers:
        cfg = dataclasses.replace(cfg, num_layers=args.layers)
    ckpt = CheckpointManager(run.checkpoint_dir) if run.checkpoint_dir else None
    t0 = time.time()
    res = train_loop(cfg, run, steps=args.steps, ckpt=ckpt, device=args.device)
    dt = time.time() - t0
    print(
        f"arch={cfg.name} steps={res.steps_run} "
        f"loss[0]={res.losses[0]:.4f} loss[-1]={res.losses[-1]:.4f} "
        f"({dt:.1f}s, resumed_from={res.resumed_from})"
    )
    assert res.losses[-1] < res.losses[0], "loss did not decrease"


if __name__ == "__main__":
    main()
