"""The seven example scripts on the port (``repro_torch.examples``), each at
the CPU tests' cut size (``repro_torch.data.EXAMPLES``) with
``device="cpu"``, held to what the reference's script printed at that size
(``examples_reference.json``, ``tests/data/capture_torch_examples.py``):
the simulator examples' whole text (``adas_scenarios``' host timings
masked), ``serve_batch``'s requests done, tokens, pool imbalance and
isolation, ``quickstart``'s steps and falling loss, ``long_context_decode``'s
state KiB.  The reference is not run here: the capture holds its output."""

import importlib
import json

import pytest

torch = pytest.importorskip("torch")

from repro_torch.data import EXAMPLES, example_record, examples_reference  # noqa: E402
from repro_torch.examples import NAMES  # noqa: E402


@pytest.fixture(scope="module")
def reference():
    return examples_reference()["examples"]


def test_names_are_the_scripts_and_the_sizes_are_complete():
    assert sorted(NAMES) == sorted(EXAMPLES)
    for name in NAMES:
        assert set(EXAMPLES[name]) == {"full", "cut"}
        assert set(EXAMPLES[name]["cut"]) == set(EXAMPLES[name]["full"])


@pytest.mark.parametrize("name", NAMES)
def test_capture_sizes_match_the_port(reference, name):
    """A stale capture (made at other sizes than ``EXAMPLES``) fails here."""
    for which in ("full", "cut"):
        assert reference[name][which]["args"] == json.loads(json.dumps(EXAMPLES[name][which]))


@pytest.mark.parametrize("name", NAMES)
def test_example_matches_reference_at_cut_size(reference, name):
    mod = importlib.import_module(f"repro_torch.examples.{name}")
    result = mod.run(**EXAMPLES[name]["cut"], device="cpu")
    mod.check(result)
    got = example_record(name, mod.text(result))
    assert got == reference[name]["cut"]["record"]


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.skipif(torch.cuda.is_available(), reason="the default device is the card here")
def test_example_wants_the_card_by_default(name):
    """With no ``device`` an example runs on the CUDA card, and raises
    where there is none: no silent fallback to the CPU."""
    mod = importlib.import_module(f"repro_torch.examples.{name}")
    with pytest.raises(RuntimeError, match="CUDA"):
        mod.run(**EXAMPLES[name]["cut"])


def test_main_prints_the_scripts_text(capsys):
    mod = importlib.import_module("repro_torch.examples.long_context_decode")
    mod.main(["--device", "cpu"])
    out = capsys.readouterr().out
    assert out.startswith("decoded 64 tokens in ") and out.endswith("with context)\n")
