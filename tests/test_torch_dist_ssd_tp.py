"""The SSD mixer split over its heads on ``model`` (``models.ssm.
SSMBlock._mix_heads``) on a 2 x 2 gloo mesh (``data`` x ``model``), each
rank a process of its own: smoke mamba2-1.3b (8 SSD heads, 4 a ``model``
rank) in the sharded train step (FSDP and sequence parallelism on), the
sharded prefill into the contiguous cache and 4 decode steps over it
(``distributed.serve``, decode_32k's layout), each step's collectives
counted by ``analysis.collectives.CollectiveCounter`` with the group each
ran over.  The same steps run again on the per-row path (the one where
``model`` does not divide the heads, ``SSMBlock._mix_rows``, reached here
by making ``models.ssm.heads_split`` answer no), from the same weights on
the same inputs.

  * No all-gather over ``model`` carries a block of ``w_z``, ``w_x``,
    ``w_dt``, ``conv_x`` or ``out_proj`` (a rank's block under the TP or
    the FSDP + TP layout), or of the SSD state, in any of the three steps;
    the per-row path's do (the check sees them).
  * The decode step moves fewer wire bytes a rank than the per-row path's
    (measured: 581,956 B against 817,636 B a rank, one decode step of 2
    layers at 2 rows a rank: the split's SSD layers move 3,472 B each, the
    per-row path's 121,312 B, the weights and the state gathered; both
    steps also gather the vocab-sharded embedding table, 524,288 B, where
    the serving steps index it).
  * The split path's logits within ``test_torch_dist_decode.py``'s
    ``LOGIT_TOL`` of the per-row path's at every call, its final cache
    within ``CACHE_TOL`` (the bf16 conv window within one bf16 step); its
    train step's metrics and gradients within ``test_torch_dist_train.py``'s
    ``REL_TOL`` and ``GRAD_TOL``; under remat ``full`` and ``minimal``
    (the checkpointed forward replays the split's collectives) the same
    values as without.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_dist_decode import CACHE_TOL, LOGIT_TOL  # noqa: E402
from test_torch_dist_train import GRAD_TOL, REL_TOL, _rel  # noqa: E402
from torch_dist import run_ranks  # noqa: E402

B, S, T, STEPS = 4, 32, 32, 4
REMATS = ("none", "full", "minimal")

BODY = """
import numpy as np
from torch.distributed.device_mesh import init_device_mesh

import torch.distributed as dist

from repro_torch.analysis.collectives import CollectiveCounter, group_ranks
from repro_torch.configs import get_config, smoke
from repro_torch.configs.base import SHAPES_BY_NAME, RunConfig
from repro_torch.distributed.serve import make_sharded_decode, make_sharded_prefill, shard_cache
from repro_torch.distributed.train import make_sharded_train_step, shard_train_state
from repro_torch.launch.dryrun import _State
from repro_torch.models import model as M
from repro_torch.models import ssm as SSM
from repro_torch.train import step as S_
from repro_torch.tree import leaves_with_path


def leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from leaves(v, (*prefix, k))
        else:
            yield (*prefix, k), v


def counted(c):
    return dict(records=c.records, groups=[group_ranks(g) for g in c.groups], stats=c.stats())


NAMES = ("data", "model")


def main(rank, world, tmp):
    B, T, steps, remats = eval(open(tmp + "/job.txt").read())
    d = np.load(tmp + "/inputs.npz")
    mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=NAMES)
    cfg = smoke(get_config("mamba2-1.3b"))
    split = SSM.heads_split
    out = {"groups": {n: tuple(dist.get_process_group_ranks(mesh.get_group(n))) for n in NAMES}}
    for path in ("split", "rows"):
        SSM.heads_split = split if path == "split" else (lambda cfg, mesh: False)
        res = {"train": {}}
        batch = {"tokens": torch.from_numpy(d["tokens"]), "labels": torch.from_numpy(d["labels"])}
        for remat in remats if path == "split" else ("none",):
            run = RunConfig(remat_policy=remat, attn_impl="jnp", compute_dtype="float32")
            state = S_.init_train_state(cfg, run, seed=0, device="cpu")
            state = shard_train_state(state, run, mesh)
            step = make_sharded_train_step(cfg, run, total_steps=10, mesh=mesh)
            with CollectiveCounter() as c:
                state, metrics = step(state, batch)
            res["train"][remat] = dict(
                counted(c),
                metrics={k: float(v) for k, v in metrics.items()},
                grads={p: x.full_tensor().numpy() for p, x in leaves_with_path(state.grads)},
            )
        model = M.init_params(
            cfg, 0, device="cpu", compute_dtype=torch.float32, kv_dtype=torch.float32
        )
        model = shard_train_state(_State(model), RunConfig(), mesh, fsdp=False).model
        cache = M.init_cache(cfg, B, T, torch.float32, device="cpu")
        cache = shard_cache(cfg, mesh, SHAPES_BY_NAME["decode_32k"], cache, B, T)
        placements = {k: str(v.placements) for k, v in leaves(cache)}
        with CollectiveCounter() as c:
            logits, cache = make_sharded_prefill(cfg, mesh)(
                model, {"tokens": torch.from_numpy(d["prompt"])}, cache
            )
        res["prefill"] = counted(c)
        res["logits"] = [logits.numpy()]
        decode = make_sharded_decode(cfg, mesh)
        res["decode"] = []
        for i in range(steps):
            tok, pos = torch.from_numpy(d["step_tokens"][i]), torch.from_numpy(d["pos"][i])
            with CollectiveCounter() as c:
                logits, cache = decode(model, cache, tok, pos)
            res["decode"].append(counted(c))
            res["logits"].append(logits.numpy())
        res["cache"] = {k: v.full_tensor().float().numpy() for k, v in leaves(cache)}
        res["placements"] = (placements, {k: str(v.placements) for k, v in leaves(cache)})
        out[path] = res
    SSM.heads_split = split
    return out
"""


def _inputs():
    rng = np.random.default_rng(13)
    tok = rng.integers(0, 256, (B, 17)).astype(np.int32)
    return dict(
        tokens=tok[:, :-1],
        labels=tok[:, 1:],
        prompt=rng.integers(0, 200, (B, S)).astype(np.int32),
        step_tokens=rng.integers(0, 200, (STEPS, B, 1)).astype(np.int32),
        pos=(S + np.arange(STEPS)[:, None] + np.zeros((1, B), np.int64)).astype(np.int64),
    )


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("ssd_tp4")
    np.savez(tmp / "inputs.npz", **_inputs())
    (tmp / "job.txt").write_text(repr((B, T, STEPS, REMATS)))
    return run_ranks(4, BODY, tmp, timeout=400)


def _blocks():
    """A rank's block of each of the five split weights, under the TP
    layout (serving) and the FSDP + TP layout (training, and either order
    of the two gathers), and of the SSD state: smoke mamba2-1.3b (d 64,
    d_inner 128, 8 heads of 16, state 16) on 2 x 2."""
    d, di, h, p, n = 64, 128, 8, 16, 16
    return {
        "w_z": {(d, di // 2), (d // 2, di // 2)},
        "w_x": {(d, di // 2), (d // 2, di // 2)},
        "w_dt": {(d, h // 2), (d // 2, h // 2)},
        "conv_x": {(4, di // 2)},
        "out_proj": {(di // 2, d), (di // 2, d // 2)},
        "state": {(B // 2, h // 2, p, n)},
    }


def _gathered(counted, group) -> set:
    """The names of ``_blocks`` whose block an all-gather over ``group``
    carried (the counter records the gathered result: its dim 0 is the
    block's times the group's 2 ranks)."""
    found = set()
    for (kind, _, shape), g in zip(counted["records"], counted["groups"]):
        if kind != "all-gather" or g != group:
            continue
        block = (shape[0] // 2, *shape[1:])
        found |= {name for name, shapes in _blocks().items() if block in shapes}
    return found


@pytest.mark.parametrize("step", ["train", "prefill", "decode"])
def test_no_model_gather_of_a_weight_or_state_shard(ranks, step):
    model = ranks["groups"]["model"]
    for path in ("split", "rows"):
        res = ranks[path]
        counts = {
            "train": [res["train"]["none"]],
            "prefill": [res["prefill"]],
            "decode": res["decode"],
        }[step]
        found = set().union(*(_gathered(c, model) for c in counts))
        if path == "split":
            assert found == set(), found
            assert any(g == model for c in counts for g in c["groups"])  # it ran over model
        else:  # the per-row path gathers them: the check sees what it asserts away
            assert {"w_z", "w_x", "out_proj"} <= found, found
            assert ("state" in found) == (step != "train"), found


def test_decode_moves_fewer_bytes_than_per_row(ranks):
    split = [c["stats"]["wire_bytes"] for c in ranks["split"]["decode"]]
    rows = [c["stats"]["wire_bytes"] for c in ranks["rows"]["decode"]]
    assert len(set(split)) == 1 and len(set(rows)) == 1, (split, rows)
    assert split[0] < rows[0], (split[0], rows[0])
    print("decode wire bytes a rank: split", split[0], "per row", rows[0])


def test_split_serving_matches_per_row(ranks):
    got, want = ranks["split"], ranks["rows"]
    for i, (g, w) in enumerate(zip(got["logits"], want["logits"])):
        np.testing.assert_allclose(g, w, rtol=0, atol=LOGIT_TOL, err_msg=f"call {i}")
    assert set(got["cache"]) == set(want["cache"])
    for k, w in want["cache"].items():
        atol = CACHE_TOL * max(1.0, float(np.abs(w).max()))
        rtol = 2**-7 if k[-1] == "conv" else 0
        np.testing.assert_allclose(got["cache"][k], w, rtol=rtol, atol=atol, err_msg=str(k))
    # the cache keeps the cell's layout: the state over its heads, the
    # window over its channels
    before, after = got["placements"]
    assert before == after
    assert after[("ssm",)] == "(Shard(dim=1), Shard(dim=2))"
    assert after[("conv",)] == "(Shard(dim=1), Shard(dim=3))"


@pytest.mark.parametrize("remat", REMATS)
def test_split_train_step_matches_per_row(ranks, remat):
    got, want = ranks["split"]["train"][remat], ranks["rows"]["train"]["none"]
    for k in ("loss", "grad_norm", "param_norm"):
        assert abs(got["metrics"][k] - want["metrics"][k]) <= REL_TOL * abs(want["metrics"][k])
    assert set(got["grads"]) == set(want["grads"])
    for p, x in want["grads"].items():
        assert _rel(got["grads"][p], x) <= GRAD_TOL, (p, _rel(got["grads"][p], x))
    if remat != "none":  # the checkpointed forward replays the same arithmetic
        base = ranks["split"]["train"]["none"]
        for p, x in base["grads"].items():
            assert _rel(got["grads"][p], x) <= 1e-6, (p, _rel(got["grads"][p], x))
