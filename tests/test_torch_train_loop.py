"""The port's training loop, data pipeline and checkpoints, on the CPU:

  * ``TokenPipeline`` batch for batch equal to the reference's, across a
    checkpoint taken with batches still in the prefetch queue, and two hosts
    reading disjoint examples;
  * a checkpoint round trip (leaf paths and dtypes as the reference writes
    them) and its garbage collection;
  * a checkpoint that the reference's ``CheckpointManager`` wrote when the
    reference's loop crashed restores into the port's loop, which continues
    to the reference's uninterrupted losses within 1e-5 (float32 compute);
  * the loss falls, and crash-resume in the port is exact, as
    ``tests/test_system.py`` holds the reference to.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.checkpoint.manager import CheckpointManager as RefCheckpointManager  # noqa: E402
from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.configs import smoke as ref_smoke  # noqa: E402
from repro.configs.base import RunConfig as RefRunConfig  # noqa: E402
from repro.data.pipeline import TokenPipeline as RefTokenPipeline  # noqa: E402
from repro.train.loop import train_loop as ref_train_loop  # noqa: E402
from repro_torch.checkpoint.manager import CheckpointManager  # noqa: E402
from repro_torch.configs import get_config, smoke  # noqa: E402
from repro_torch.configs.base import RunConfig  # noqa: E402
from repro_torch.data.pipeline import TokenPipeline  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.train import step as S  # noqa: E402
from repro_torch.train.loop import train_loop  # noqa: E402
from repro_torch.tree import leaves_with_path  # noqa: E402

ARCH = "stablelm-1.6b"


def _cfg():
    return smoke(get_config(ARCH))


def _same_batches(a, b, n):
    for _ in range(n):
        x, y = next(a), next(b)
        assert sorted(x) == sorted(y) == ["labels", "tokens"]
        for k in x:
            assert x[k].dtype == y[k].dtype == np.int32
            np.testing.assert_array_equal(x[k], y[k])


def test_pipeline_matches_reference_with_resume_and_hosts():
    kw = dict(batch=3, seq_len=17, seed=5, num_shards=4, examples_per_shard=4)
    port, ref = TokenPipeline(300, **kw), RefTokenPipeline(300, **kw)
    _same_batches(port, ref, 7)  # past an epoch (16 examples)
    ck = port.checkpoint()
    assert ck == ref.checkpoint()
    _same_batches(port, ref, 2)
    port2, ref2 = TokenPipeline(300, **kw), RefTokenPipeline(300, **kw)
    port2.restore(ck)
    ref2.restore(ck)
    _same_batches(port2, ref2, 3)
    resumed = TokenPipeline(300, **kw)
    resumed.restore(ck)
    fresh = TokenPipeline(300, **kw)
    for _ in range(7):
        next(fresh)
    _same_batches(resumed, fresh, 3)  # resume is exact

    rows = {}
    for host in range(2):
        p = TokenPipeline(300, host_id=host, num_hosts=2, **kw)
        r = RefTokenPipeline(300, host_id=host, num_hosts=2, **kw)
        _same_batches(p, r, 2)
        p.restore({"epoch": 0, "index": 0})
        rows[host] = {tuple(row) for _ in range(2) for row in next(p)["tokens"]}
    assert not rows[0] & rows[1]


def test_checkpoint_round_trip_and_gc(tmp_path):
    cfg = _cfg()
    state = S.init_train_state(cfg, RunConfig(grad_compression="int8_ef"), 0, device="cpu")
    pipe = TokenPipeline(cfg.vocab_size, batch=2, seq_len=8)
    next(pipe)
    ck = CheckpointManager(tmp_path / "ck", keep=2)
    for step in (1, 2, 3):
        ck.save(step, (state.tree(), pipe.checkpoint()))
    ck.wait()
    assert ck.all_steps() == [2, 3] and ck.latest_step() == 3
    (tree, pipe_state), manifest = ck.restore((state.tree(), pipe.checkpoint()))
    assert manifest["step"] == 3 and pipe_state == {"epoch": 0, "index": 2}  # one queued
    paths = [p for p, _ in leaves_with_path((state.tree(), pipe.checkpoint()))]
    assert manifest["paths"] == paths
    assert manifest["paths"][:2] == ["[0]['ef']['embed']", "[0]['ef']['final_norm']['bias']"]
    assert manifest["paths"][-3:] == ["[0]['step']", "[1]['epoch']", "[1]['index']"]
    want = dict(leaves_with_path((state.tree(), pipe.checkpoint())))
    for path, x in leaves_with_path((tree, pipe_state)):
        got, exp = np.asarray(x), want[path]
        exp = exp.numpy() if torch.is_tensor(exp) else np.asarray(exp)
        assert got.dtype == exp.dtype, path
        np.testing.assert_array_equal(got, exp, err_msg=path)


def test_reference_checkpoint_restores_and_continues(tmp_path):
    run_kw = dict(checkpoint_every=4, compute_dtype="float32", learning_rate=1e-3, warmup_steps=2)
    rcfg = ref_smoke(ref_get_config(ARCH))
    rrun = RefRunConfig(**run_kw)
    whole = ref_train_loop(rcfg, rrun, steps=6)
    ref_ck = RefCheckpointManager(tmp_path / "ck")
    with pytest.raises(RuntimeError):
        ref_train_loop(rcfg, rrun, steps=6, ckpt=ref_ck, fail_at_step=5)
    ref_ck.wait()
    ck = CheckpointManager(tmp_path / "ck")
    res = train_loop(_cfg(), RunConfig(**run_kw), steps=6, ckpt=ck, device="cpu")
    assert res.resumed_from == 4 and res.final_step == 6
    np.testing.assert_allclose(res.losses, whole.losses[4:], rtol=1e-5)
    jax.clear_caches()


def test_loss_falls():
    run = RunConfig(learning_rate=1e-3, warmup_steps=3)
    res = train_loop(_cfg(), run, steps=16, device="cpu")
    assert res.steps_run == 16 and res.final_step == 16
    assert np.mean(res.losses[-4:]) < np.mean(res.losses[:4])


def test_crash_resume_exact(tmp_path):
    cfg, run = _cfg(), RunConfig(checkpoint_every=4, learning_rate=1e-3, warmup_steps=3)
    whole = train_loop(cfg, run, steps=12, device="cpu")
    ck = CheckpointManager(tmp_path / "ck")
    with pytest.raises(RuntimeError):
        train_loop(cfg, run, steps=12, ckpt=ck, fail_at_step=10, device="cpu")
    ck.wait()  # the accepted async save (step 8) publishes despite the crash
    res = train_loop(cfg, run, steps=12, ckpt=ck, device="cpu")
    assert res.resumed_from == 8
    assert res.losses == whole.losses[8:]


def test_launcher_smoke_on_cpu(capsys):
    launch_train.main(["--smoke", "--device", "cpu", "--steps", "50"])
    assert "loss[-1]" in capsys.readouterr().out


def test_run_config_matches_reference_fields():
    ours = {f.name: f.default for f in dataclasses.fields(RunConfig)}
    theirs = {f.name: f.default for f in dataclasses.fields(RefRunConfig)}
    assert sorted(ours) == sorted(theirs)
    # the port's kernels by default, and no fixed checkpoint directory
    assert {k for k in ours if ours[k] != theirs[k]} == {"attn_impl", "checkpoint_dir"}
    assert RunConfig().checkpoint_dir == ""
    assert RunConfig(attn_impl="jnp").impl == "ref" and RunConfig().impl == "kernel"
