"""Helper of the port's multi-device tests (not a test file): run a
function on N gloo ranks of one host, each a process of its own
(``torch.multiprocessing.spawn``), and hand back what rank 0 returns.

``run_ranks(world, body, tmp_path, timeout)`` writes ``body`` (source that
defines ``main(rank, world, tmp)``) into a script under ``tmp_path``, starts
it with ``world`` ranks over a ``FileStore`` there (no port, no network),
and unpickles rank 0's result.  The ranks see ``src`` only: they import the
port, never JAX or the reference.  ``TRAIN_BODY`` is the sharded-train-step
tests' rank code, ``reference_train_steps`` the reference's steps they are
held to (in the test's own process).
"""

import os
import pickle
import subprocess
import sys
import textwrap
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]

_TEMPLATE = """
import os
import pickle
import sys

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

torch.set_num_threads(1)

@BODY@


def _entry(rank, world, tmp):
    store = dist.FileStore(os.path.join(tmp, "store"), world)
    dist.init_process_group("gloo", store=store, rank=rank, world_size=world)
    try:
        out = main(rank, world, tmp)
        if rank == 0:
            with open(os.path.join(tmp, "out.pkl"), "wb") as f:
                pickle.dump(out, f)
        dist.barrier()
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    mp.spawn(_entry, args=(int(sys.argv[1]), sys.argv[2]), nprocs=int(sys.argv[1]))
"""


def run_ranks(world: int, body: str, tmp_path: Path, timeout: float = 120):
    script = tmp_path / "ranks.py"
    script.write_text(_TEMPLATE.replace("@BODY@", textwrap.dedent(body)))
    env = {
        "PYTHONPATH": str(REPO / "src"),
        "PATH": os.environ.get("PATH", "/usr/bin:/bin"),
        "OMP_NUM_THREADS": "1",
        "HOME": os.environ.get("HOME", str(tmp_path)),
        "TMPDIR": str(tmp_path),
    }
    res = subprocess.run(
        [sys.executable, str(script), str(world), str(tmp_path)],
        env=env,
        capture_output=True,
        text=True,
        timeout=timeout,
        cwd=tmp_path,
    )
    assert res.returncode == 0, res.stderr[-6000:]
    return pickle.loads((tmp_path / "out.pkl").read_bytes())


#: ``main`` of the sharded-train-step tests: ``job.txt`` under ``tmp`` holds
#: ``([arch, ...], mesh shape (data, model), steps, [seq_parallel, ...])``
#: and ``batch.npz`` the batch; every rank lays each arch's seeded smoke
#: state out by the rules (``distributed.train``) and takes the steps; rank 0
#: returns, per arch and ``seq_parallel``, the last step's metrics, gradients
#: and parameters whole, the initial parameters and the placements.
TRAIN_BODY = """
import numpy as np
from torch.distributed.device_mesh import init_device_mesh

from repro_torch.configs import get_config, smoke
from repro_torch.configs.base import RunConfig
from repro_torch.distributed.train import make_sharded_train_step, shard_train_state
from repro_torch.train import step as S_
from repro_torch.tree import leaves_with_path


def main(rank, world, tmp):
    archs, shape, steps, sps = eval(open(tmp + "/job.txt").read())
    d = np.load(tmp + "/batch.npz")
    batch = {k: torch.from_numpy(d[k]) for k in d.files}
    mesh = init_device_mesh("cpu", shape, mesh_dim_names=("data", "model"))
    out = {}
    for arch, sp in [(a, sp) for a in archs for sp in sps]:
        cfg = smoke(get_config(arch))
        run = RunConfig(remat_policy="none", attn_impl="jnp", compute_dtype="float32", seq_parallel=sp)
        state = shard_train_state(S_.init_train_state(cfg, run, seed=0, device="cpu"), run, mesh)
        placements = {p: str(x.placements) for p, x in leaves_with_path(state.params)}
        initial = {p: x.full_tensor().numpy().copy() for p, x in leaves_with_path(state.params)}
        step = make_sharded_train_step(cfg, run, total_steps=10, mesh=mesh)
        for _ in range(steps):
            state, metrics = step(state, batch)
        full = lambda t: {p: x.full_tensor().numpy() for p, x in leaves_with_path(t)}
        out.setdefault(arch, {})[sp] = dict(
            metrics={k: float(v) for k, v in metrics.items()},
            grads=full(state.grads),
            params=full(state.params),
            placements=placements,
            initial=initial,
        )
    return out
"""


def reference_train_steps(arch: str, batch: dict, steps: int) -> dict:
    """The reference's jitted ``make_train_step`` (float32 compute, no remat)
    from the port's seeded initial state (``interop.train_state_to_reference``),
    ``steps`` steps on ``batch`` (whisper's ``frames`` too): the last
    step's metrics, its gradients as its update takes them (``jax.grad`` of
    the reference's loss, the MoE's weighted aux loss included, at the
    parameters the step started from, clipped by the global norm, as the
    port's step leaves ``state.grads``) and the parameters after it."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from repro.configs import get_config as ref_get_config
    from repro.configs import smoke as ref_smoke
    from repro.configs.base import RunConfig as RefRunConfig
    from repro.models import model as RM
    from repro.models.layers import cross_entropy
    from repro.optim import clip_by_global_norm
    from repro.train import step as RS
    from repro_torch.configs import get_config, smoke
    from repro_torch.configs.base import RunConfig
    from repro_torch.interop import train_state_to_reference
    from repro_torch.train import step as S
    from repro_torch.tree import leaves_with_path

    kw = dict(remat_policy="none", attn_impl="jnp", compute_dtype="float32")
    state = S.init_train_state(smoke(get_config(arch)), RunConfig(**kw), 0, device="cpu")
    rcfg = ref_smoke(ref_get_config(arch))
    rstate = jax.tree_util.tree_map(jnp.asarray, train_state_to_reference(state))
    rbatch = jax.tree_util.tree_map(jnp.asarray, batch)
    ref_step = jax.jit(RS.make_train_step(rcfg, RefRunConfig(**kw), total_steps=10))

    def loss(params):
        logits, aux = RM.forward_train(rcfg, params, rbatch, compute_dtype=jnp.float32,
                                       remat_policy="none")
        return cross_entropy(logits, rbatch["labels"], rcfg.vocab_size) + (
            rcfg.moe_aux_loss_weight * aux
        )

    for _ in range(steps):
        start = rstate["params"]
        rstate, metrics = ref_step(rstate, rbatch)
    grads, _ = clip_by_global_norm(jax.jit(jax.grad(loss))(start), RefRunConfig().grad_clip)
    return dict(
        metrics={k: float(v) for k, v in metrics.items()},
        grads={p: np.asarray(x) for p, x in leaves_with_path(grads)},
        params={p: np.asarray(x) for p, x in leaves_with_path(rstate["params"])},
    )
