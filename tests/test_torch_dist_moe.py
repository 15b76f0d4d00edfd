"""The expert-parallel MoE path (``models.moe._expert_parallel``) on 2 and 4
gloo ranks of one host, held to the single-process port and to the
reference's local path on the same numpy inputs (smoke olmoe-1b-7b: 4
experts, top-2, d 64).

Modes: 2 ranks (``model`` 2) with and without sequence parallelism and with
a shared expert; 4 ranks (``data`` 2 x ``model`` 2) with FSDP and SP (the
weights' d all-gathered over ``data``), without FSDP or SP, and the FSDP
partial-product mode at batch 1 (one decode token: the weights keep their
d-slice, the gate and up products summed over ``data``).  Each mode runs a
loss ``sum(out * w) + aux`` on DTensors and its gradients.

Tolerances: float32 bit for bit where the summation order is the same:
each (token, k) pair's contribution comes from one model rank and the
others add exact zeros, so the outputs of every mode but two equal the
single-process port's (asserted); the partial mode sums the gate and up
products over two d-halves, the shared expert's products run on DTensors
split over ``model`` (its ``mlp`` axis), and the gradients sum the ranks'
shares in another order, so those are held within 1e-5 of the largest entry
(measured at most 3.3e-7).  Against the reference: outputs and aux 1e-5
absolute, as ``tests/test_torch_moe.py`` holds the single-process port;
every gradient leaf and the tokens' gradient against ``jax.grad`` of the
reference's local path within 1e-5 of the leaf's largest entry (XLA sums
in another order; measured at most 8.5e-7, the router's in the partial
mode).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.configs import smoke as ref_smoke  # noqa: E402
from repro.models import moe as ref_moe  # noqa: E402
from repro_torch.configs import get_config, smoke  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from torch_dist import run_ranks  # noqa: E402

ARCH = "olmoe-1b-7b"
REL_TOL = 1e-5
REF_GRAD_TOL = 1e-5
#: mode -> (mesh shape (data, model), fsdp, B, S, shared experts)
MODES = {
    2: {
        "sp": ((1, 2), False, 2, 16, 0),
        "no_sp": ((1, 2), False, 2, 15, 0),
        "shared": ((1, 2), False, 2, 16, 1),
    },
    4: {
        "fsdp_sp": ((2, 2), True, 2, 16, 0),
        "dp_no_sp": ((2, 2), False, 2, 15, 0),
        "fsdp_partial_b1": ((2, 2), True, 1, 1, 0),
    },
}
BITWISE_OUT = {"sp", "no_sp", "fsdp_sp", "dp_no_sp"}

BODY = """
import numpy as np
from dataclasses import replace
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import Replicate, Shard, distribute_tensor

from repro_torch.configs import get_config, smoke
from repro_torch.distributed.sharding import param_rules, placements, spec_for_param
from repro_torch.models import moe
from repro_torch.models.sharding_hooks import set_activation_sharder


def main(rank, world, tmp):
    d = np.load(tmp + "/in.npz")
    modes = eval(open(tmp + "/modes.txt").read())
    res = {}
    for name, (shape, fsdp, B, S, shared) in modes.items():
        cfg = replace(smoke(get_config("olmoe-1b-7b")), moe_num_shared=shared)
        mesh = init_device_mesh("cpu", shape, mesh_dim_names=("data", "model"))
        set_activation_sharder(None, mesh=mesh, fsdp=fsdp)
        rules = param_rules(cfg, mesh, fsdp=fsdp)
        p = {}
        for k, spec in moe.moe_specs(cfg).items():
            pl = placements(spec_for_param(spec.axes, spec.shape, rules, mesh), mesh)
            p[k] = distribute_tensor(torch.from_numpy(d[k]), mesh, pl).requires_grad_()
        x = torch.from_numpy(d["x"][:B, :S])
        x = distribute_tensor(x, mesh, [Shard(0) if B % shape[0] == 0 else Replicate(), Replicate()])
        x.requires_grad_()
        w = distribute_tensor(torch.from_numpy(d["w"][:B, :S]), mesh, [Replicate(), Replicate()])
        out, aux = moe.moe_ffn(cfg, p, x)
        loss = ((out * w).sum() + aux).full_tensor()
        loss.backward()
        res[name] = dict(
            out=out.full_tensor().detach().numpy(),
            out_placements=[str(pl) for pl in out.placements],
            aux=float(aux.full_tensor()),
            loss=float(loss),
            grads={k: v.grad.full_tensor().numpy() for k, v in p.items()},
            gx=x.grad.full_tensor().numpy(),
        )
        set_activation_sharder(None)
    return res
"""


def _inputs():
    cfg = smoke(get_config(ARCH), moe_num_shared=1)
    rng = np.random.default_rng(11)
    inp = {}
    for name, spec in moe.moe_specs(cfg).items():
        inp[name] = (rng.normal(size=spec.shape) / np.sqrt(spec.shape[-2])).astype(np.float32)
    inp["x"] = rng.normal(size=(2, 16, cfg.d_model)).astype(np.float32)
    inp["w"] = rng.normal(size=(2, 16, cfg.d_model)).astype(np.float32)
    return inp


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """``ranks(world)``: every mode of that rank count, run once (one spawn
    of ``world`` processes, ~11 s) and kept for the module."""
    done = {}

    def get(world):
        if world not in done:
            tmp = tmp_path_factory.mktemp(f"moe{world}")
            np.savez(tmp / "in.npz", **_inputs())
            (tmp / "modes.txt").write_text(repr(MODES[world]))
            done[world] = run_ranks(world, BODY, tmp, timeout=240)
        return done[world]

    return get


def _single(name, world, inp):
    """The single-process port's output, aux and gradients for a mode."""
    _, _, B, S, shared = MODES[world][name]
    cfg = smoke(get_config(ARCH), moe_num_shared=shared)
    p = {k: torch.from_numpy(inp[k]).requires_grad_() for k in moe.moe_specs(cfg)}
    x = torch.from_numpy(inp["x"][:B, :S]).requires_grad_()
    out, aux = moe.moe_ffn(cfg, p, x)
    ((out * torch.from_numpy(inp["w"][:B, :S])).sum() + aux).backward()
    grads = {k: v.grad.numpy() for k, v in p.items()}
    return cfg, out.detach().numpy(), float(aux.detach()), grads, x.grad.numpy()


def _rel(got, want) -> float:
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _modes(world):
    return [(world, name) for name in MODES[world]]


@pytest.mark.parametrize("world,name", _modes(2) + _modes(4))
def test_expert_parallel_matches_single_process(ranks, world, name):
    inp = _inputs()
    cfg, out, aux, grads, gx = _single(name, world, inp)
    r = ranks(world)[name]
    if name in BITWISE_OUT:
        np.testing.assert_array_equal(r["out"], out)
    assert _rel(r["out"], out) <= REL_TOL
    assert abs(r["aux"] - aux) <= REL_TOL * abs(aux)
    assert _rel(r["gx"], gx) <= REL_TOL, "the tokens' gradient"
    for k, g in grads.items():
        assert _rel(r["grads"][k], g) <= REL_TOL, k


@pytest.mark.parametrize("world,name", _modes(2) + _modes(4))
def test_expert_parallel_matches_reference_local_path(ranks, world, name):
    inp, res = _inputs(), ranks(world)
    _, _, B, S, shared = MODES[world][name]
    ref_cfg = ref_smoke(ref_get_config(ARCH), moe_num_shared=shared)
    cfg = smoke(get_config(ARCH), moe_num_shared=shared)
    p = {k: jnp.asarray(inp[k]) for k in moe.moe_specs(cfg)}
    x = jnp.asarray(inp["x"][:B, :S])
    want, want_aux = jax.jit(ref_moe.moe_ffn, static_argnums=0)(ref_cfg, p, x)
    np.testing.assert_allclose(res[name]["out"], np.asarray(want), rtol=0, atol=1e-5)
    np.testing.assert_allclose(res[name]["aux"], float(want_aux), rtol=0, atol=1e-6)
    sp = S % 2 == 0 and S > 1
    assert res[name]["out_placements"][1] == ("S(1)" if sp else "R")


@pytest.mark.parametrize("world,name", _modes(2) + _modes(4))
def test_expert_parallel_gradients_match_reference(ranks, world, name):
    """Every weight's and the tokens' gradient of ``sum(out * w) + aux``
    against ``jax.grad`` of the reference's local path on the same inputs."""
    inp, res = _inputs(), ranks(world)
    _, _, B, S, shared = MODES[world][name]
    ref_cfg = ref_smoke(ref_get_config(ARCH), moe_num_shared=shared)
    cfg = smoke(get_config(ARCH), moe_num_shared=shared)
    p = {k: jnp.asarray(inp[k]) for k in moe.moe_specs(cfg)}
    x, w = jnp.asarray(inp["x"][:B, :S]), jnp.asarray(inp["w"][:B, :S])

    def loss(p, x):
        out, aux = ref_moe.moe_ffn(ref_cfg, p, x)
        return (out * w).sum() + aux

    gp, gx = jax.jit(jax.grad(loss, argnums=(0, 1)))(p, x)
    assert _rel(res[name]["gx"], np.asarray(gx)) <= REF_GRAD_TOL, "the tokens' gradient"
    assert set(res[name]["grads"]) == set(gp)
    for k, g in gp.items():
        assert _rel(res[name]["grads"][k], np.asarray(g)) <= REF_GRAD_TOL, k
