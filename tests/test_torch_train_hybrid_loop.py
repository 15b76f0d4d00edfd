"""Training a hybrid stack (jamba-1.5-large-398b) in the port against the JAX
package on the CPU: the training loop at ``smoke(jamba, num_layers=16)``.
Crash and resume in the port, exact; a checkpoint the reference's loop
wrote when it crashed restores into the port's loop, which continues to the
reference's uninterrupted losses within 1e-5; ``python -m
repro_torch.launch.train --arch jamba-1.5-large-398b --smoke --device
cpu`` with the reference's per-arch defaults (Adafactor, remat ``full``)
and a falling loss.  The configs and bounds are
``tests/test_torch_train_hybrid.py``'s."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.checkpoint.manager import CheckpointManager as RefCheckpointManager  # noqa: E402
from repro.configs.base import RunConfig as RefRunConfig  # noqa: E402
from repro.launch.specs import default_run_config as ref_default_run_config  # noqa: E402
from repro.train.loop import train_loop as ref_train_loop  # noqa: E402
from repro_torch.checkpoint.manager import CheckpointManager  # noqa: E402
from repro_torch.configs.base import RunConfig  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.train.loop import train_loop  # noqa: E402
from test_torch_train_hybrid import ARCH, LOSS_TOL, _cfgs  # noqa: E402


def test_crash_resume_exact(tmp_path):
    cfg, _ = _cfgs()
    run = RunConfig(
        optimizer="adafactor", checkpoint_every=4, learning_rate=1e-3, warmup_steps=3
    )
    whole = train_loop(cfg, run, steps=8, device="cpu")
    ck = CheckpointManager(tmp_path / "ck")
    with pytest.raises(RuntimeError):
        train_loop(cfg, run, steps=8, ckpt=ck, fail_at_step=6, device="cpu")
    ck.wait()
    res = train_loop(cfg, run, steps=8, ckpt=ck, device="cpu")
    assert res.resumed_from == 4
    assert res.losses == whole.losses[4:]


def test_reference_checkpoint_restores_and_continues(tmp_path):
    cfg, rcfg = _cfgs()
    run_kw = dict(
        optimizer="adafactor",
        checkpoint_every=2,
        compute_dtype="float32",
        learning_rate=1e-3,
        warmup_steps=2,
    )
    whole = ref_train_loop(rcfg, RefRunConfig(**run_kw), steps=4)
    ref_ck = RefCheckpointManager(tmp_path / "ck")
    with pytest.raises(RuntimeError):
        ref_train_loop(rcfg, RefRunConfig(**run_kw), steps=4, ckpt=ref_ck, fail_at_step=3)
    ref_ck.wait()
    ck = CheckpointManager(tmp_path / "ck")
    res = train_loop(cfg, RunConfig(**run_kw), steps=4, ckpt=ck, device="cpu")
    assert res.resumed_from == 2 and res.final_step == 4
    np.testing.assert_allclose(res.losses, whole.losses[2:], rtol=LOSS_TOL)
    jax.clear_caches()


def test_launcher_trains_jamba_with_the_reference_defaults(capsys):
    ours, theirs = launch_train.default_run_config(ARCH), ref_default_run_config(ARCH)
    assert (ours.optimizer, ours.remat_policy) == (theirs.optimizer, theirs.remat_policy)
    assert (ours.optimizer, ours.remat_policy) == ("adafactor", "full")
    assert launch_train.default_run_config("mamba2-1.3b").optimizer == "adamw"
    launch_train.main(["--arch", ARCH, "--smoke", "--device", "cpu", "--steps", "30"])
    line = capsys.readouterr().out.strip().splitlines()[-1]
    fields = dict(f.split("=", 1) for f in line.split() if "=" in f)
    assert fields["arch"] == f"{ARCH}-smoke" and fields["steps"] == "30"
    assert float(fields["loss[-1]"]) < float(fields["loss[0]"])
