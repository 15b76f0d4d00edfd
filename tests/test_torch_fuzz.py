"""The port's scenario fuzzer against the JAX package, without a simulation:
sampled specs (``default_rng([seed, index])``, every draw in the reference's
order) as JSON, the JSON round trip in and across both packages, the
capture's fuzz specs against what the port samples now; then, with the CPU
simulator, the committed corpus replayed to its verdicts and the planted
find shrunk to the reference's reproducer (held to the capture, tolerance
0)."""

import json
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from repro.scenarios import fuzz as ref_fuzz  # noqa: E402
from repro_torch.data import FUZZ_JOB, FUZZ_PLANTED, cosim_reference  # noqa: E402
from repro_torch.scenarios import fuzz  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
CORPUS = sorted((REPO / "tests" / "data" / "fuzz_corpus").glob("*.json"))


@pytest.mark.parametrize("seed", [0, 3, 5, 7])
def test_sampled_specs_match_reference(seed):
    for plant_rate in (0.0, 0.3):
        ours = fuzz.FuzzConfig(seed=seed, budget=0, plant_rate=plant_rate)
        ref = ref_fuzz.FuzzConfig(seed=seed, budget=0, plant_rate=plant_rate)
        for i in range(32):
            a, b = fuzz.sample_case(ours, i), ref_fuzz.sample_case(ref, i)
            got, want = fuzz.case_to_json(a), ref_fuzz.case_to_json(b)
            assert got == want, (seed, plant_rate, i)
            assert json.dumps(got) == json.dumps(want)  # plain ints and floats, same order
            assert fuzz.needs_alone_run(a) == ref_fuzz.needs_alone_run(b)
            assert a.params.dyn_vector().tolist() == b.params.dyn_vector().tolist()
    assert fuzz.FuzzConfig().to_json() == ref_fuzz.FuzzConfig().to_json()


def test_case_json_round_trips_within_and_across_packages():
    case = fuzz.sample_case(fuzz.FuzzConfig(seed=11, budget=0, plant_rate=0.5), 4)
    text = json.dumps(fuzz.case_to_json(case))
    loaded = fuzz.case_from_json(json.loads(text))
    assert fuzz.case_to_json(loaded) == fuzz.case_to_json(case)
    assert loaded.geometry == case.geometry
    assert loaded.params.static_key() == case.params.static_key()
    theirs = ref_fuzz.case_from_json(json.loads(text))
    assert ref_fuzz.case_to_json(theirs) == json.loads(text)
    for path in CORPUS:
        d = json.loads(path.read_text())["case"]
        assert fuzz.case_to_json(fuzz.case_from_json(d)) == d
    with pytest.raises(ValueError, match="format"):
        fuzz.case_from_json({"format": 99})


def test_capture_specs_match_sampling():
    """A stale ``cosim_reference.json`` fails here: every case of the
    captured fuzz job is the spec the port samples now."""
    ref = cosim_reference()["fuzz"]
    cfg = fuzz.FuzzConfig(**FUZZ_JOB)
    cases = ref["job"]["cases"]
    assert [c["index"] for c in cases] == list(range(FUZZ_JOB["budget"]))
    for c in cases:
        assert fuzz.case_to_json(fuzz.sample_case(cfg, c["index"])) == c["spec"]
    planted = fuzz.FuzzConfig(**FUZZ_PLANTED)
    (rep,) = ref["planted"]["reproducers"]
    original = fuzz.sample_case(planted, rep["original"]["index"])
    assert original.planted and len(original.scenario.masters) == rep["original"]["masters"]


@pytest.mark.parametrize("path", CORPUS, ids=lambda p: p.stem)
def test_corpus_replays_to_expected_verdict(path):
    torch.set_num_threads(1)
    case, verdict = fuzz.load_reproducer(path)
    result = fuzz.replay_case(case, device="cpu")
    assert sorted({v.oracle for v in result.violations}) == sorted(
        verdict.get("violated_oracles", [])
    ), [v.message for v in result.violations]


def test_planted_violation_shrinks_to_the_reference_reproducer():
    """``FUZZ_PLANTED`` (the reference test's planted run) on the CPU: the
    violation is found and shrunk to the capture's reproducer, its JSON (spec,
    violation, verdict, original, shrunk) equal."""
    torch.set_num_threads(1)
    outcome = fuzz.run_fuzz(fuzz.FuzzConfig(**FUZZ_PLANTED), device="cpu")
    assert outcome.violating and outcome.evaluated == FUZZ_PLANTED["budget"]
    want = cosim_reference()["fuzz"]["planted"]["reproducers"]
    assert json.loads(json.dumps(outcome.reproducers)) == want
    assert want[0]["shrunk"] == {"masters": 1, "txns": [1]}
