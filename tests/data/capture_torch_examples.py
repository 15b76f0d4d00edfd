"""Regenerate src/repro_torch/data/examples_reference.json with the reference.

The PyTorch port's examples (``repro_torch.examples``; ``chip_smoke.py``,
phase ``examples``; ``tests/test_torch_examples.py``) are held to this file,
made with the JAX package on the CPU: the reference's seven scripts under
``examples/``, loaded from their paths with ``runpy`` (``sys.argv`` set, their
standard output captured), under ``PYTHONHASHSEED=0`` (the script re-runs
itself with it set: the reference salts each weight's key with Python's
string hash).  For each script, at the sizes ``EXAMPLES`` names:

  * ``full``: the script run as it is, as ``__main__`` with no arguments;
  * ``cut``: the CPU tests' sizes.  ``quickstart`` takes ``--steps 16`` on
    its command line; the simulator scripts run their own ``main`` with the
    names it looks up replaced: ``TXNS`` (``adas_scenarios`` 8,
    ``qos_isolation`` 24, ``slice_scaling`` 16 transactions a master), and
    in ``memory_sim_sweep`` ``random_uniform``'s transactions (200 -> 8) and
    ``bulk_linear``'s payload (64 KB -> 4 KB); ``serve_batch`` and
    ``long_context_decode`` run whole.

Each record is ``example_record`` of the printed text.

Run from the repo root (about fifteen minutes on one CPU):

  PYTHONPATH=src python tests/data/capture_torch_examples.py
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import runpy
import sys
from pathlib import Path

from repro_torch.data import EXAMPLES, EXAMPLES_REFERENCE, example_record

SCRIPTS = Path(__file__).resolve().parents[2] / "examples"


def _cut_globals(name: str, sizes: dict, g: dict) -> None:
    """Point the names ``name``'s ``main`` looks up at the cut ``sizes``."""
    if "txns" in sizes and name != "memory_sim_sweep":
        g["TXNS"] = sizes["txns"]
        return
    random_uniform, bulk_linear = g["random_uniform"], g["bulk_linear"]
    g["random_uniform"] = lambda X, n, **kw: random_uniform(X, sizes["txns"], **kw)
    g["bulk_linear"] = lambda X, n, **kw: bulk_linear(X, sizes["bulk_kb"] * 1024, **kw)


def run_script(name: str, which: str) -> str:
    """The standard output of ``examples/<name>.py`` at ``EXAMPLES[name][which]``."""
    sizes = EXAMPLES[name][which]
    path = str(SCRIPTS / f"{name}.py")
    argv = [path]
    if name == "quickstart" and sizes != EXAMPLES[name]["full"]:
        argv += ["--steps", str(sizes["steps"])]
    simulator = name not in ("quickstart", "serve_batch", "long_context_decode")
    out = io.StringIO()
    saved = sys.argv
    sys.argv = argv
    try:
        with contextlib.redirect_stdout(out):
            if simulator and which == "cut":
                g = runpy.run_path(path)
                _cut_globals(name, sizes, g["main"].__globals__)
                g["main"]()
            else:
                runpy.run_path(path, run_name="__main__")
    finally:
        sys.argv = saved
    return out.getvalue()


def capture() -> dict:
    out = {}
    for name in EXAMPLES:
        out[name] = {}
        for which in ("full", "cut"):
            text = run_script(name, which)
            print(f"--- {name} ({which})\n{text}", end="", file=sys.stderr, flush=True)
            out[name][which] = {
                "args": EXAMPLES[name][which],
                "record": example_record(name, text),
            }
    return {"source": "examples/*.py run by the reference, PYTHONHASHSEED=0", "examples": out}


def main() -> None:
    ref = capture()
    EXAMPLES_REFERENCE.write_text(json.dumps(ref, indent=1) + "\n")
    print(f"wrote {EXAMPLES_REFERENCE}")


if __name__ == "__main__":
    if os.environ.get("PYTHONHASHSEED") != "0":
        env = {**os.environ, "PYTHONHASHSEED": "0"}
        os.execve(sys.executable, [sys.executable, *sys.argv], env)
    main()
