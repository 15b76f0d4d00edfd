"""Regenerate src/repro_torch/data/moe_reference.json with the reference.

The PyTorch port's ``moe_whitening`` phase (``chip_smoke.py``) is held to
this file: the reference's ``_route`` on the inputs of its
``benchmarks/paper_figures.py::moe_whitening`` benchmark (olmoe-1b-7b with
capacity factor 0.5, x ``[4, 512, 64]`` and router ``[64, 64]`` from
``default_rng(0)``), with the fractal slot permutation on (``fractal``) and
off (``tail_drop``): the benchmark's drop rate and share of drops in the last
quarter, and every expert choice and slot.  Run from the repo root (a few
seconds on one CPU):

  PYTHONPATH=src python tests/data/capture_torch_moe.py
"""

from __future__ import annotations

import dataclasses
import json

import jax.numpy as jnp

from repro.configs import get_config
from repro.models.moe import _route, expert_capacity
from repro_torch.data import (
    MOE_REFERENCE,
    MOE_WHITENING_CAPACITY_FACTOR,
    moe_whitening_inputs,
    moe_whitening_record,
)


def main() -> None:
    cfg = dataclasses.replace(
        get_config("olmoe-1b-7b"), moe_capacity_factor=MOE_WHITENING_CAPACITY_FACTOR
    )
    x, router = moe_whitening_inputs()
    C = expert_capacity(cfg, x.shape[1])
    out = {"source": "benchmarks/paper_figures.py::moe_whitening", "capacity": C}
    for name, whiten in (("fractal", True), ("tail_drop", False)):
        _, top_e, slot, _ = _route(cfg, jnp.asarray(x), jnp.asarray(router), whiten=whiten)
        out[name] = moe_whitening_record(top_e, slot, C)
    MOE_REFERENCE.write_text(json.dumps(out, indent=1) + "\n")
    print(
        f"wrote {MOE_REFERENCE}: capacity {C}, "
        + ", ".join(
            f"{k} drop rate {out[k]['drop_rate']}, last quarter "
            f"{out[k]['fraction_of_drops_in_last_quarter']}"
            for k in ("fractal", "tail_drop")
        )
    )


if __name__ == "__main__":
    main()
