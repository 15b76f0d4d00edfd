"""QoS isolation: the paper's "deterministic access latency with proper
isolation under ... stringent real-time QoS constraints" claim, made
measurable; the port's copy of the reference's ``benchmarks/qos_isolation.py``.

Four configurations of the ``qos_isolation`` preset run as lanes of one
batch (the QoS knobs ``qos_aging``, ``reg_rate`` and ``reg_burst`` travel in
each lane's dyn vector and the arbiter priorities in its trace):

  * ``alone``     the safety masters with every aggressor silenced
                  (per-class baseline latency)
  * ``qos_on``    full load, priority arbiter + best-effort regulator
  * ``qos_noreg`` full load, priority arbiter only (regulator off)
  * ``qos_off``   full load, QoS-blind FCFS+RR (the pre-QoS arbiter)

Banks run at ``bank_occupancy=12`` (a slow-SRAM stress corner: at the
paper's nominal occupancy of 2 even 13 saturating aggressors cannot congest
a bank, which is the paper's throughput claim).  The headline assertion:
safety-class p99 read latency with QoS on stays within ``bound_cycles`` of
its alone latency and visibly degrades with QoS off; the regulator caps
best-effort throughput.

  PYTHONPATH=src python -m repro_torch.paper --only qos_isolation_sweep
"""

from __future__ import annotations

from dataclasses import replace
from typing import Dict

import numpy as np

from repro_torch.core.simulator import SimParams, Trace, simulate_batch
from repro_torch.scenarios import qos_isolation

CONFIGS = ("alone", "qos_on", "qos_noreg", "qos_off")


def qos_isolation_sweep(
    *,
    txns: int = 64,
    max_cycles: int = 10_000,
    bank_occupancy: int = 12,
    reg_rate: int = 64,
    reg_burst: int = 32,
    bound_cycles: int = 24,
    device=None,
) -> Dict:
    """Safety-class p99 under best-effort saturation, with and without QoS,
    on ``device`` (default: the CUDA card)."""
    comp = qos_isolation(txns=txns).compile()
    full = comp.trace
    keep = np.zeros(full.num_masters, bool)
    keep[comp.masters_of_class("safety")] = True
    alone = Trace(
        full.is_write,
        np.where(keep[:, None], full.burst, 0).astype(np.int32),
        full.addr,
        full.start,
        full.prio,
    )
    blind = Trace(full.is_write, full.burst, full.addr, full.start, None)

    base = SimParams(max_cycles=max_cycles, bank_occupancy=bank_occupancy)
    qos_on = replace(base, reg_rate=reg_rate, reg_burst=reg_burst)
    traces = [alone, full, full, blind]
    prms = [qos_on, qos_on, base, base]
    stacked = simulate_batch(traces, prms, device=device)  # one batch of four lanes

    rows = {}
    for i, (cfg, tr, prm) in enumerate(zip(CONFIGS, traces, prms)):
        metrics = {k: np.asarray(v)[i] for k, v in stacked.items()}
        comp_i = replace(comp, trace=tr)
        rows[cfg] = comp_i.summarize(prm, metrics).summary()

    safety = {cfg: rows[cfg]["per_class"]["safety"] for cfg in CONFIGS}
    be_tput = {cfg: rows[cfg]["per_class"]["besteffort"]["read_throughput"] for cfg in CONFIGS[1:]}
    out = {
        "headline": {
            "alone_p99": safety["alone"]["read_lat_p99"],
            "qos_on_p99": safety["qos_on"]["read_lat_p99"],
            "qos_noreg_p99": safety["qos_noreg"]["read_lat_p99"],
            "qos_off_p99": safety["qos_off"]["read_lat_p99"],
            "bound_cycles": bound_cycles,
            "besteffort_read_throughput": be_tput,
            "safety_deadline_misses": {cfg: safety[cfg]["deadline_misses"] for cfg in CONFIGS},
        },
        "rows": rows,
    }
    h = out["headline"]
    # isolation holds with the QoS machinery on ...
    assert h["qos_on_p99"] <= h["alone_p99"] + bound_cycles, h
    assert safety["qos_on"]["deadline_misses"] == 0, h
    # ... and visibly degrades with it off (the pre-QoS arbiter)
    assert h["qos_off_p99"] >= h["qos_on_p99"] + bound_cycles, h
    # the regulator caps best-effort throughput well below the unregulated run
    assert be_tput["qos_on"] < be_tput["qos_noreg"] * 0.6, h
    return out
