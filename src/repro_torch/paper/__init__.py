"""The paper's experiment functions on the port: one function per table or
figure (``paper_figures``), the QoS isolation sweep (``qos_isolation``) and
the multi-slice scaling check (``slice_scaling``), each the reference's
``benchmarks/`` function of the same name with its keyword arguments,
defaults, asserts and returned dict, plus a keyword-only ``device`` (default:
the CUDA card; ``"cpu"`` runs the plain PyTorch path).

:func:`job_table` lists the ten jobs of the reference's ``benchmarks/run.py``
at its sizes; ``python -m repro_torch.paper`` runs them.  (The submodule
``qos_isolation`` and the function of that name in ``paper_figures`` keep
the reference's names, so the package exports no function of its own.)
"""

from __future__ import annotations

from typing import Callable, Dict, Tuple


def job_table(full: bool = False) -> Dict[str, Tuple[Callable, dict]]:
    """Job name -> (function, keyword arguments), in the reference's
    ``benchmarks/run.py`` order and at its sizes (``full``: its ``--full``)."""
    from repro_torch.paper.paper_figures import (
        comparators,
        fig4_throughput,
        fig5_bulk,
        fig67_traces,
        moe_whitening,
        pool_balance,
        qos_isolation,
        table1_outstanding,
    )
    from repro_torch.paper.qos_isolation import qos_isolation_sweep
    from repro_torch.paper.slice_scaling import slice_scaling_bench

    return {
        "fig4_throughput": (fig4_throughput, dict(num_txns=1000) if full else {}),
        "fig5_bulk": (
            fig5_bulk,
            dict(payloads_kb=(4, 16, 64, 256, 1024, 2048) if full else (4, 16, 64, 256, 1024)),
        ),
        "table1_outstanding": (table1_outstanding, {}),
        "fig67_traces": (fig67_traces, dict(max_txns=3000 if full else 1200)),
        "comparators": (comparators, {}),
        "qos_isolation": (qos_isolation, {}),
        "pool_balance": (pool_balance, {}),
        "moe_whitening": (moe_whitening, {}),
        "qos_isolation_sweep": (
            qos_isolation_sweep,
            dict(txns=96 if full else 64, max_cycles=14_000 if full else 10_000),
        ),
        "slice_scaling": (
            slice_scaling_bench,
            dict(txns=96 if full else 64, max_cycles=12_000 if full else 10_000),
        ),
    }
