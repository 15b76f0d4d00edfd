"""The sharded serving steps (``distributed.serve``) on a 2 x 2 gloo mesh
(``data`` x ``model``), each rank a process of its own: a smoke config's
parameters laid out as a serving cell's, its contiguous cache by
``cache_shardings`` (the batch over ``data``, the sequence over ``model``;
``long_500k``'s cell over ``data`` and ``model``, batch 1), the prompt
prefilled with ``make_sharded_prefill`` and decode steps taken with
``make_sharded_decode``: the new token's K/V land on the rank that holds
its slot, each rank attends over its own slots and the ranks merge by
log-sum-exp.  Held to the single-process cache form (``prefill_cache``,
``decode_step_cache``) and to the reference's ``prefill``/``decode_step``
on the same weights and inputs, step by step, and the final cache leaf by
leaf.

Cases: dense (stablelm-1.6b, ``decode_32k``'s layout, pos ``[B]``),
windowed (h2o-danube-1.8b, window 16, ``long_500k``'s layout: a
two-window prompt rolled into 16 slots, 4 a rank, then 20 steps across
the wrap), MLA (deepseek-v2-lite-16b, both decode forms) and SSM
(mamba2-1.3b: no attention cache; its state split over the heads).

Tolerances (float32): logits within 1e-4 of the single-process step and
of the reference (the merge adds the ranks' partial softmax sums in
another order, and the products split over ``model`` sum in another
order); cache leaves within 1e-5 of each leaf's largest entry (an SSM's
bf16 conv window within one bf16 step), ``pos`` exactly.
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.models import model as RM  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from test_torch_cache import _leaves, port_tree  # noqa: E402
from test_torch_model import _np, _pair  # noqa: E402
from torch_dist import run_ranks  # noqa: E402

#: name: (arch, overrides, cell shape, batch, prompt, cache slots, steps, absorbed, pos0 offset)
CASES = {
    "dense": ("stablelm-1.6b", {"num_kv_heads": 2}, "decode_32k", 4, 8, 16, 4, False,
              [0, 0, -2, 0]),
    "windowed": ("h2o-danube-1.8b", {}, "long_500k", 1, 32, 16, 20, False, [0]),
    "mla": ("deepseek-v2-lite-16b", {}, "decode_32k", 2, 8, 16, 3, False, [0, -3]),
    "mla-absorbed": ("deepseek-v2-lite-16b", {}, "decode_32k", 2, 8, 16, 3, True, [0, 0]),
    "ssm": ("mamba2-1.3b", {}, "decode_32k", 2, 8, 8, 4, False, [0, 0]),
}
LOGIT_TOL = 1e-4
CACHE_TOL = 1e-5

BODY = """
import numpy as np
from torch.distributed.device_mesh import init_device_mesh

from repro_torch.configs import get_config, smoke
from repro_torch.configs.base import SHAPES_BY_NAME, RunConfig
from repro_torch.distributed.serve import make_sharded_decode, make_sharded_prefill, shard_cache
from repro_torch.distributed.train import shard_train_state
from repro_torch.launch.dryrun import _State
from repro_torch.models import model as M


def leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from leaves(v, (*prefix, k))
        else:
            yield (*prefix, k), v


def main(rank, world, tmp):
    jobs = eval(open(tmp + "/job.txt").read())
    mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
    out = {}
    for name, (arch, overrides, shape, B, S, T, steps, absorbed, _) in jobs.items():
        d = np.load(f"{tmp}/{name}.npz")
        cfg = smoke(get_config(arch), **overrides)
        model = M.init_params(
            cfg, 0, device="cpu", compute_dtype=torch.float32, kv_dtype=torch.float32
        )
        model = shard_train_state(_State(model), RunConfig(), mesh, fsdp=False).model
        cache = M.init_cache(cfg, B, T, torch.float32, device="cpu")
        cache = shard_cache(cfg, mesh, SHAPES_BY_NAME[shape], cache, B, T)
        placements = {k: str(v.placements) for k, v in leaves(cache)}
        logits, cache = make_sharded_prefill(cfg, mesh)(
            model, {"tokens": torch.from_numpy(d["prompt"])}, cache
        )
        got = [logits.numpy()]
        decode = make_sharded_decode(cfg, mesh, mla_absorbed=absorbed)
        for i in range(steps):
            tok, pos = torch.from_numpy(d["tokens"][i]), torch.from_numpy(d["pos"][i])
            logits, cache = decode(model, cache, tok, pos)
            got.append(logits.numpy())
        full = {k: v.full_tensor().float().numpy() for k, v in leaves(cache)}
        out[name] = dict(logits=got, cache=full, placements=placements)
    return out
"""


def _inputs(name):
    arch, overrides, shape, B, S, T, steps, absorbed, off = CASES[name]
    rng = np.random.default_rng(7)
    prompt = rng.integers(0, 200, (B, S)).astype(np.int32)
    tokens = rng.integers(0, 200, (steps, B, 1)).astype(np.int32)
    pos = (S + np.asarray(off))[None] + np.arange(steps)[:, None]
    return prompt, tokens, pos.astype(np.int64)


@pytest.fixture(scope="module")
def sharded(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("decode4")
    for name in CASES:
        prompt, tokens, pos = _inputs(name)
        np.savez(tmp / f"{name}.npz", prompt=prompt, tokens=tokens, pos=pos)
    (tmp / "job.txt").write_text(repr(CASES))
    return run_ranks(4, BODY, tmp, timeout=400)


@functools.cache
def _single_and_reference(name):
    """The single-process cache form's and the reference's logits per call
    and final caches (reference-shaped), on the same inputs."""
    arch, overrides, shape, B, S, T, steps, absorbed, _ = CASES[name]
    ref_cfg, ref_params, cfg, model = _pair(arch, overrides, "float32")
    prompt, tokens, pos = _inputs(name)
    cache = M.init_cache(cfg, B, T, torch.float32, device="cpu")
    got, cache = M.prefill_cache(model, torch.from_numpy(prompt), cache)
    single = [_np(got)]
    rprefill = jax.jit(functools.partial(RM.prefill, ref_cfg, compute_dtype=jnp.float32))
    rdecode = jax.jit(
        functools.partial(RM.decode_step, ref_cfg, compute_dtype=jnp.float32, mla_absorbed=absorbed)
    )
    want, rc = rprefill(
        ref_params, {"tokens": jnp.asarray(prompt)}, RM.init_cache(ref_cfg, B, T, jnp.float32)
    )
    ref = [_np(want)]
    for i in range(steps):
        got, cache = M.decode_step_cache(
            model, cache, torch.from_numpy(tokens[i]), torch.from_numpy(pos[i]),
            mla_absorbed=absorbed,
        )
        single.append(_np(got))
        want, rc = rdecode(ref_params, rc, jnp.asarray(tokens[i]), jnp.asarray(pos[i], jnp.int32))
        ref.append(_np(want))
    single_cache = {k: _np(v) for k, v in _leaves(cache)}
    ref_cache = {tuple(p.key for p in path): np.asarray(v)
                 for path, v in jax.tree_util.tree_leaves_with_path(rc)}
    return cfg, single, single_cache, ref, ref_cache


def _check_cache(got, want):
    assert set(got) == set(want)
    for k in want:
        if k[-1] == "pos":
            np.testing.assert_array_equal(got[k], want[k], err_msg=str(k))
            continue
        atol = CACHE_TOL * max(1.0, float(np.abs(want[k]).max()))
        rtol = 2**-7 if k[-1] == "conv" else 0
        np.testing.assert_allclose(got[k], want[k], rtol=rtol, atol=atol, err_msg=str(k))


@pytest.mark.parametrize("name", list(CASES))
def test_sharded_decode_matches_single_process(sharded, name):
    cfg, single, single_cache, _, _ = _single_and_reference(name)
    got = sharded[name]
    for i, (g, w) in enumerate(zip(got["logits"], single)):
        np.testing.assert_allclose(g, w, rtol=0, atol=LOGIT_TOL, err_msg=f"call {i}")
    _check_cache(got["cache"], single_cache)


@pytest.mark.parametrize("name", list(CASES))
def test_sharded_decode_matches_reference(sharded, name):
    cfg, _, _, ref, ref_cache = _single_and_reference(name)
    got = sharded[name]
    for i, (g, w) in enumerate(zip(got["logits"], ref)):
        np.testing.assert_allclose(g, w, rtol=0, atol=LOGIT_TOL, err_msg=f"call {i}")
    cache = {k: torch.from_numpy(v) for k, v in got["cache"].items()}
    nested: dict = {}
    for k, v in cache.items():
        node = nested
        for part in k[:-1]:
            node = node.setdefault(part, {})
        node[k[-1]] = v
    _check_cache({k: _np(v) for k, v in _leaves(port_tree(cfg, nested))}, ref_cache)


def test_cache_is_laid_out_by_the_cells(sharded):
    """The sequence over ``model`` (``long_500k``: ``data`` and ``model``),
    the batch over ``data``; an SSM state over its heads."""
    assert sharded["dense"]["placements"][("k",)] == "(Shard(dim=1), Shard(dim=2))"
    assert sharded["windowed"]["placements"][("k",)] == "(Shard(dim=2), Shard(dim=2))"
    assert sharded["mla"]["placements"][("latent",)] == "(Shard(dim=1), Shard(dim=2))"
    assert sharded["ssm"]["placements"][("ssm",)] == "(Shard(dim=1), Shard(dim=2))"
