"""The port stands alone: nothing in ``src/repro_torch`` or ``chip_smoke.py``
imports JAX or the reference package, and the port (simulator, serving, the
co-sim's recording, the fuzzer's sampling and the paper's jobs) runs with
both blocked."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

REPO = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "repro")


def _port_sources():
    return sorted((REPO / "src" / "repro_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]


def _imported_roots(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.lineno, node.module.split(".")[0]
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", None) == "import_module":
            for arg in node.args:
                if isinstance(arg, ast.Constant) and isinstance(arg.value, str):
                    yield node.lineno, arg.value.split(".")[0]


def test_port_sources_import_neither_jax_nor_the_reference():
    sources = _port_sources()
    assert len(sources) >= 30
    bad = [
        f"{p.relative_to(REPO)}:{line} imports {root}"
        for p in sources
        for line, root in _imported_roots(p)
        if root in FORBIDDEN
    ]
    assert not bad, bad


def test_port_runs_with_jax_and_reference_blocked():
    prog = """
import sys
for name in ("jax", "jaxlib", "repro"):
    sys.modules[name] = None
import numpy as np
import chip_smoke  # noqa: F401
from repro_torch import interop
from repro_torch.core.simulator import SimParams, simulate
from repro_torch.core.traffic import random_uniform
from repro_torch.data import golden_cases
from repro_torch.kernels.bank_arbiter import ops  # noqa: F401
from repro_torch.kernels.banked_copy import ops as _bc  # noqa: F401
from repro_torch.kernels.flash_attention import ops as _fa  # noqa: F401
from repro_torch.kernels.paged_attention import ops as _pa  # noqa: F401
from repro_torch.launch import serve
from repro_torch.launch import dryrun, mesh, specs  # noqa: F401
from repro_torch.distributed import comm, sharding, train  # noqa: F401
from repro_torch.analysis import collectives  # noqa: F401
from repro_torch.models import sharding_hooks  # noqa: F401
from repro_torch.scenarios import record_serving_run, sample_case, serving_scenario, FuzzConfig
assert len(golden_cases()) == 3
rec = record_serving_run(num_requests=3, max_batch=2)
assert serving_scenario(rec).compile().qos[0] == "realtime"
assert sample_case(FuzzConfig(), 0).scenario.masters
serve.main(["--smoke", "--device", "cpu", "--requests", "3"])
from repro_torch.models import ssm  # noqa: F401
serve.main(["--smoke", "--device", "cpu", "--requests", "3", "--arch", "mamba2-1.3b"])
serve.main(["--smoke", "--device", "cpu", "--requests", "3", "--arch", "h2o-danube-1.8b"])
out = simulate(random_uniform(2, 4, burst=4, seed=1), SimParams(max_cycles=400), device="cpu")
from repro_torch.paper.paper_figures import fig5_bulk, pool_balance
assert pool_balance(device="cpu")["fractal"]["worst_imbalance"] > 0
assert fig5_bulk(payloads_kb=(4,), device="cpu")[4]["read"]["ideal"] == 128
assert bool(out["all_done"]) and out["throughput"].shape == (4,)
assert not any(m == "jax" or m.startswith(("jax.", "repro.")) for m in sys.modules
               if sys.modules[m] is not None)
print("OK")
"""
    env = {
        "PYTHONPATH": os.pathsep.join([str(REPO / "src"), str(REPO)]),
        "PATH": os.environ.get("PATH", "/usr/bin:/bin"),
    }
    res = subprocess.run(
        [sys.executable, "-c", prog], env=env, capture_output=True, text=True, timeout=300, cwd=REPO
    )
    assert res.returncode == 0, res.stderr
    assert "OK" in res.stdout
