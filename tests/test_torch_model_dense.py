"""The port's dense configs of the thirteenth slice against the JAX package:
deepseek-7b (MHA at 32 heads of 128), chameleon-34b (family ``vlm``: a dense
GQA stack with QK-norm, the VQ front end a stub the reference never reads)
and stablelm-3b (MHA at head dim 80, LayerNorm, rotary over a quarter of
the dims).

  * each config equals the reference's field for field, ``num_params``
    included, at full size and at smoke size;
  * ``prefill`` and ``decode_step`` logits at smoke width through
    ``tests/test_torch_model.py``'s ``prefill_and_decode_gap`` (its
    tolerances: 1e-4 in float32, 0.5 in bfloat16), with stablelm-3b at
    ``smoke(cfg, head_dim=80)`` so that D = 80 and its 20 rotary dims run
    and chameleon-34b at GQA 4:1;
  * the serving engine's slots, blocks, steps and tokens against the
    reference's engine in float32 (``tests/test_torch_serving.py``'s check,
    near-tie allowance included).
"""

import dataclasses

import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.configs import smoke as ref_smoke  # noqa: E402
from repro_torch.configs import get_config, smoke  # noqa: E402
from test_torch_model import prefill_and_decode_gap  # noqa: E402
from test_torch_serving import test_engine_matches_reference as _engine_matches  # noqa: E402

#: (arch, smoke overrides): stablelm-3b at its own head dim of 80
ARCHS = [("deepseek-7b", {}), ("chameleon-34b", {}), ("stablelm-3b", {"head_dim": 80})]
IDS = [a for a, _ in ARCHS]


@pytest.mark.parametrize("arch,overrides", ARCHS, ids=IDS)
def test_configs_match_reference(arch, overrides):
    ref = ref_get_config(arch)
    assert dataclasses.asdict(get_config(arch)) == dataclasses.asdict(ref)
    assert get_config(arch).num_params() == ref.num_params()
    got, want = smoke(get_config(arch), **overrides), ref_smoke(ref, **overrides)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.num_params() == want.num_params()


def test_the_new_configs_keep_their_shapes():
    """What the slice runs them for: D = 80 at full size, GQA 8:1 with
    QK-norm, and family vlm taken as a dense stack."""
    assert get_config("stablelm-3b").resolved_head_dim == 80
    cham = get_config("chameleon-34b")
    assert (cham.family, cham.num_heads // cham.num_kv_heads, cham.use_qk_norm) == ("vlm", 8, True)
    assert smoke(cham).num_kv_heads == 1  # GQA 4:1 at smoke size
    assert get_config("deepseek-7b").resolved_head_dim == 128


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch,overrides", ARCHS, ids=IDS)
def test_prefill_and_decode_match_reference(arch, overrides, dtype, record_property):
    record_property("max_abs_logit_gap", prefill_and_decode_gap(arch, overrides, dtype))


@pytest.mark.parametrize("arch,overrides", ARCHS, ids=IDS)
def test_engine_matches_reference(arch, overrides, monkeypatch, record_property):
    _engine_matches(arch, overrides, "float32", monkeypatch, record_property)
