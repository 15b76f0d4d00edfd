"""Fault-tolerant training loop: the reference's ``train/loop.py``.

  * auto-resume: on start, restore the newest checkpoint (params, optimizer,
    step, data-iterator state) and continue exactly
  * periodic async checkpoints (atomic publish; a crash mid-save is harmless)
  * failure injection (``fail_at_step``) to test the restart path
  * NaN guard: a step whose loss is not finite is left out of the losses
Eager PyTorch (the reference jits the step); one device.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs.base import ModelConfig, RunConfig
from repro_torch.data.pipeline import TokenPipeline
from repro_torch.interop import load_train_state
from repro_torch.train import step as step_mod


@dataclass
class LoopResult:
    steps_run: int
    final_step: int
    losses: list
    resumed_from: Optional[int]


def train_loop(
    cfg: ModelConfig,
    run: RunConfig,
    *,
    steps: int,
    ckpt: Optional[CheckpointManager] = None,
    fail_at_step: Optional[int] = None,
    device=None,
) -> LoopResult:
    """``steps`` steps on the reference's data shape (sequences of 64,
    ``max(2, 2 * microbatches)`` per batch) on ``device`` (default: CUDA)."""
    pipe = TokenPipeline(
        cfg.vocab_size, batch=max(2, run.microbatches * 2), seq_len=64, seed=run.seed
    )
    state = step_mod.init_train_state(cfg, run, seed=run.seed, device=device)
    resumed = None
    if ckpt is not None and ckpt.latest_step() is not None:
        (tree, pipe_state), manifest = ckpt.restore((state.tree(), pipe.checkpoint()))
        load_train_state(state, tree)
        pipe.restore({k: int(v) for k, v in pipe_state.items()})
        resumed = manifest["step"]

    fn = step_mod.make_train_step(cfg, run, total_steps=steps)
    losses = []
    start = int(state.step)
    for i in range(start, steps):
        if fail_at_step is not None and i == fail_at_step:
            raise RuntimeError(f"injected failure at step {i}")
        state, metrics = fn(state, next(pipe))
        loss = float(metrics["loss"])
        if not np.isfinite(loss):  # NaN guard: drop the step
            continue
        losses.append(loss)
        if ckpt is not None and (i + 1) % max(1, run.checkpoint_every) == 0:
            ckpt.save(i + 1, (state.tree(), pipe.checkpoint()))
    if ckpt is not None:
        ckpt.save(steps, (state.tree(), pipe.checkpoint()))
        ckpt.wait()
    return LoopResult(
        steps_run=len(losses), final_step=int(state.step), losses=losses, resumed_from=resumed
    )
