"""The port's serving stack against the JAX package: ``BankedKVPool``
allocation under seeded churn, and the serving engine on the CPU against the
reference ``ServingEngine(cfg, params)`` on the same seeded requests and the
same weights: slots, block tables, steps, done flags and token streams, on
``smoke(stablelm-1.6b)`` and ``smoke(olmoe-1b-7b)`` (MoE with QK-norm).

Token streams must be identical, with one allowance that the test measures
instead of assuming: where a request's streams part, the port's top-2 logit
margin at that token must lie within twice the logits tolerance of
``tests/test_torch_model.py`` (a near-tie that rounding may break either
way).  Every margin is recorded, and the smallest is reported, so a near-tie
is told apart from a fault.  The reference engine gets its model module's
functions with the run's compute and cache dtype (the float32 runs need a
float32 cache, as ``test_torch_model.py`` explains; bfloat16 is its default).
"""

import dataclasses
import functools
import json
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.serving.engine as ref_engine  # noqa: E402
from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.configs import smoke as ref_smoke  # noqa: E402
from repro.models import model as RM  # noqa: E402
from repro.serving.pool import BankedKVPool as RefPool  # noqa: E402
from repro_torch.configs import get_config, smoke  # noqa: E402
from repro_torch.interop import model_from_reference  # noqa: E402
from repro_torch.kernels import LAUNCHES  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.serving.engine import ServingEngine  # noqa: E402
from repro_torch.serving.pool import BankedKVPool  # noqa: E402

ARCH = "stablelm-1.6b"
#: logits tolerances of tests/test_torch_model.py
TOL = {"float32": 1e-4, "bfloat16": 0.5}
DTYPES = {"float32": (torch.float32, jnp.float32), "bfloat16": (torch.bfloat16, jnp.bfloat16)}
#: 6 requests on 4 slots: a second wave, idle slots, blocks freed and reused
SPEC = serve.ServeSpec(
    requests=6, prompt_lo=8, prompt_hi=10, max_new_tokens=6, max_batch=4, max_len=32, block_size=4
)


@pytest.mark.parametrize("placement", ["fractal", "sequential"])
def test_pool_allocations_match_reference(placement):
    rng = np.random.default_rng(9)
    ours = BankedKVPool(num_blocks=64, block_size=16, num_banks=8, placement=placement, seed=3)
    ref = RefPool(num_blocks=64, block_size=16, num_banks=8, placement=placement, seed=3)
    live = []
    for step in range(300):
        if live and rng.random() < 0.4:
            rid = live.pop(int(rng.integers(len(live))))
            assert ours.free(rid) == ref.free(rid)
        else:
            rid, n = 500 + step, int(rng.integers(1, 9))
            got = ours.alloc(rid, n)
            assert got == ref.alloc(rid, n)
            if got is not None:
                live.append(rid)
        assert ours.check_isolation()
        np.testing.assert_array_equal(ours.owner, ref.owner)
    assert ours.by_request == ref.by_request
    assert dataclasses.asdict(ours.stats) == dataclasses.asdict(ref.stats)
    np.testing.assert_array_equal(ours.bank_load(), ref.bank_load())
    assert ours.imbalance() == ref.imbalance()


class MarginEngine(ServingEngine):
    """Records the top-2 logit margin behind every token it picks."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.margins = {}  # (rid, token index) -> margin

    def _pick(self, reqs, logits):
        top = torch.topk(logits.float(), 2, dim=-1).values
        for r, m in zip(reqs, (top[:, 0] - top[:, 1]).tolist()):
            self.margins[(r.rid, len(r.out_tokens))] = m
        return super()._pick(reqs, logits)


def _drive(eng):
    """Step to the end; returns per-step slot rids and each request's blocks."""
    slots, blocks = [], {}
    while eng.queue or any(r is not None for r in eng.slot_req):
        eng.step()
        slots.append([None if r is None else r.rid for r in eng.slot_req])
        for rid, b in eng.pool.by_request.items():
            blocks.setdefault(rid, list(b))
    return slots, blocks


def _reference_model_module(jdt):
    """The reference's model module with ``compute_dtype`` and the cache
    dtype set to ``jdt`` (its engine uses the defaults, bfloat16), and its
    prefill jitted as its decode step is: the engine calls prefill eagerly,
    which compiles every scan anew (~1.3 s per admission on this CPU)."""
    mod = types.SimpleNamespace(**vars(RM))
    mod.prefill = jax.jit(functools.partial(RM.prefill, compute_dtype=jdt), static_argnums=0)
    mod.decode_step = functools.partial(RM.decode_step, compute_dtype=jdt)
    mod.init_cache = functools.partial(RM.init_cache, dtype=jdt)
    return mod


@pytest.mark.parametrize(
    "arch,overrides,dtype",
    [
        (ARCH, {}, "float32"),
        (ARCH, {"num_kv_heads": 2}, "float32"),
        (ARCH, {}, "bfloat16"),
        ("olmoe-1b-7b", {}, "float32"),
    ],
    ids=["mha-float32", "gqa-float32", "mha-bfloat16", "olmoe-float32"],
)
def test_engine_matches_reference(arch, overrides, dtype, monkeypatch, record_property):
    cfg = smoke(get_config(arch), **overrides)
    tree = M.init_params(cfg, 0, device="cpu", compute_dtype=torch.float32).state_tree()
    td, jdt = DTYPES[dtype]
    monkeypatch.setattr(ref_engine, "M", _reference_model_module(jdt))
    model = model_from_reference(cfg, tree, device="cpu", compute_dtype=td, kv_dtype=td)
    prompts = serve.make_prompts(cfg, SPEC, seed=4)

    ref_cfg = ref_smoke(ref_get_config(arch), **overrides)
    ref = ref_engine.ServingEngine(
        ref_cfg,
        jax.tree_util.tree_map(jnp.asarray, tree),
        max_batch=SPEC.max_batch,
        max_len=SPEC.max_len,
        block_size=SPEC.block_size,
    )
    ref_reqs = [ref.submit(p, max_new_tokens=SPEC.max_new_tokens) for p in prompts]
    ours, reqs = serve.new_engine(cfg, model, SPEC, prompts, engine_cls=MarginEngine)

    assert _drive(ours) == _drive(ref)  # slots per step, every request's blocks
    assert ours.steps == ref.steps
    assert [r.done for r in reqs] == [r.done for r in ref_reqs] == [True] * SPEC.requests
    smallest = min(ours.margins.values())
    record_property("smallest_top2_margin", smallest)
    for r, rr in zip(reqs, ref_reqs):
        assert len(r.out_tokens) == len(rr.out_tokens) == SPEC.max_new_tokens
        pairs = enumerate(zip(r.out_tokens, rr.out_tokens))
        split = next((i for i, (a, b) in pairs if a != b), None)
        if split is not None:
            margin = ours.margins[(r.rid, split)]
            assert margin <= 2 * TOL[dtype], (
                f"request {r.rid} parts from the reference at token {split} with a top-2 "
                f"margin of {margin} (not a near-tie): {r.out_tokens} vs {rr.out_tokens}"
            )
    assert ours.stats.admissions == SPEC.requests
    assert ours.stats.decode_steps == ours.steps  # freed slots refill at once: no idle step


def test_traffic_only_matches_reference():
    cfg = smoke(get_config(ARCH))
    prompts = serve.make_prompts(cfg, serve.SMOKE, seed=2)
    ours, reqs = serve.new_engine(None, None, serve.SMOKE, prompts)
    ref = ref_engine.ServingEngine(None, None, max_batch=4, max_len=64, block_size=8)
    ref_reqs = [ref.submit(p, max_new_tokens=8) for p in prompts]
    assert _drive(ours) == _drive(ref)
    assert ours.steps == ref.steps
    assert [r.out_tokens for r in reqs] == [r.out_tokens for r in ref_reqs]
    assert ours.kv is None and ours.stats.admissions == len(prompts)


def test_engine_refuses_what_it_does_not_carry():
    cfg = smoke(get_config(ARCH))
    model = M.init_params(smoke(get_config(ARCH), num_kv_heads=2), device="cpu")
    with pytest.raises(ValueError, match="built for"):
        ServingEngine(cfg, model)
    eng = ServingEngine(None, None, max_len=16)
    with pytest.raises(ValueError, match="prompt"):
        eng.submit(np.zeros(16, np.int32))


def test_serve_cli_smoke_on_cpu(capsys):
    before = dict(LAUNCHES)
    serve.main(["--smoke", "--device", "cpu"])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["done"] == out["requests"] == 8 and out["device"] == "cpu"
    assert out["out_tokens"] == 8 * 8 and out["stats"]["admissions"] == 8
    assert LAUNCHES == before  # the plain path launches no kernel
