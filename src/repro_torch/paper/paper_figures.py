"""One function per paper table/figure (§III-A), plus the §II-A comparators
and the TPU-adaptation checks (pool balance, MoE whitening): the port's copy
of the reference's ``benchmarks/paper_figures.py``.

Every function keeps the reference's keyword arguments, defaults, asserts
and returned dict, and computes on numpy on the host from the port's
simulator (``device``: default the CUDA card, ``"cpu"`` the plain PyTorch
path).  The one difference in how it runs: ``fig5_bulk`` steps a payload's
read and write streams as two lanes of one batch (they share the trace
shape and the parameters), where the reference runs them one after the
other; every lane equals its own ``simulate`` bit for bit, so the rows do
not change."""

from __future__ import annotations

from typing import Dict

import numpy as np

from repro_torch.core.qos import interference_report, regions_isolated
from repro_torch.core.simulator import SimParams, Trace, simulate, simulate_batch
from repro_torch.core.traffic import BEAT, adas_mixed_trace, bulk_linear, random_uniform
from repro_torch.serving.pool import BankedKVPool


def fig4_throughput(*, num_txns: int = 300, counts=(1, 2, 4, 8, 16), device=None) -> Dict:
    """Read/write throughput + latency vs number of parallel masters."""
    rows = {}
    for X in counts:
        tr = random_uniform(X, num_txns, burst=16, full_duplex=True)
        need = int(num_txns * 16 * 1.3) + 2000
        m = simulate(tr, SimParams(max_cycles=need), device=device)
        rows[X] = {
            "read_throughput": float(m["read_throughput"][:X].mean()),
            "write_throughput": float(m["write_throughput"][X:].mean()),
            "read_lat": float(m["read_lat_avg"][:X].mean()),
            "write_lat": float(m["write_lat_avg"][X:].mean()),
        }
    first, last = rows[counts[0]], rows[counts[-1]]
    # paper: ~96 % read / ~99 % write, droop <= ~0.5 pp across the sweep
    assert last["read_throughput"] > 0.93 and last["write_throughput"] > 0.97
    assert abs(first["read_throughput"] - last["read_throughput"]) < 0.02
    return rows


def fig5_bulk(*, payloads_kb=(4, 16, 64, 256, 1024), device=None) -> Dict:
    """Bulk transfer cycles vs the 100 %-utilization ideal."""
    rows = {}
    for kb in payloads_kb:
        beats = kb * 1024 // BEAT
        ideal = beats  # 1 beat/cycle on a 256-bit port
        prm = SimParams(max_cycles=int(beats * 1.4) + 3000)
        pair = [bulk_linear(16, kb * 1024, burst=16, is_write=wr) for wr in (False, True)]
        m = simulate_batch(pair, [prm, prm], device=device)
        out = {}
        for lane, wr in enumerate((False, True)):
            done = m["complete_cycle"][lane]
            acc = m["accept_cycle"][lane]
            span = int((done.max(axis=1) - acc.min(axis=1)).mean())
            out["write" if wr else "read"] = {
                "cycles": span,
                "ideal": ideal,
                "overhead": span - ideal,
                "utilization": ideal / max(span, 1),
            }
        rows[kb] = out
        # fixed pipe fill, then ~100 % utilization
        assert out["read"]["overhead"] < 120, (kb, out)
        assert out["read"]["utilization"] > 0.9 or beats < 1024
    return rows


def table1_outstanding(*, num_txns: int = 256, device=None) -> Dict:
    """Average read latency at 16 vs 1 outstanding commands per port."""
    rng = np.random.default_rng(0)
    rows = {}
    for o in (16, 1):
        tr = Trace(
            np.zeros((16, num_txns), np.int32),
            np.full((16, num_txns), 16, np.int32),
            rng.integers(0, 2**20 - 16, (16, num_txns)).astype(np.int32),
        )
        m = simulate(tr, SimParams(outstanding=o, max_cycles=num_txns * 20 + 4000), device=device)
        rows[o] = {
            "read_lat": float(m["read_lat_avg"].mean()),
            "read_throughput": float(m["read_throughput"].mean()),
        }
    # paper: 222 vs 36 cycles (about 6x); the same regime is required
    assert 25 <= rows[1]["read_lat"] <= 45
    assert rows[16]["read_lat"] / rows[1]["read_lat"] > 4.5
    return rows


def fig67_traces(*, max_txns: int = 1200, device=None) -> Dict:
    """ML (SSD net) + image (ROI) trace replay: throughput about that of
    random traffic, ML read latency noisier than image reads."""
    tr = adas_mixed_trace(16, max_txns=max_txns)
    assert regions_isolated(tr), "trace regions must be disjoint (isolation)"
    beats = int((tr.burst).sum())
    m = simulate(tr, SimParams(max_cycles=int(beats / 16 * 1.6) + 6000), device=device)
    ml, img = slice(0, 8), slice(8, 16)
    lat = m["read_lat_avg"]
    lat_max = m["read_lat_max"]
    rows = {
        "ml_read_throughput": float(m["read_throughput"][ml].mean()),
        "img_read_throughput": float(m["read_throughput"][img].mean()),
        "ml_read_lat": float(lat[ml].mean()),
        "img_read_lat": float(lat[img].mean()),
        "ml_lat_spread": float((lat_max[ml] - lat[ml]).mean()),
        "img_lat_spread": float((lat_max[img] - lat[img]).mean()),
        "write_throughput": float(m["write_throughput"][:].mean()),
        "all_done": bool(m["all_done"]),
    }
    assert rows["ml_read_throughput"] > 0.80 and rows["img_read_throughput"] > 0.85
    assert rows["ml_lat_spread"] >= rows["img_lat_spread"] * 0.8
    return rows


def comparators(*, payload_kb: int = 128, device=None) -> Dict:
    """§II-A: the proposed banking vs monolithic-linear vs no-fractal, under
    the bulk linear streams ADAS masters actually issue (each master confined
    to its own region: the isolation layout)."""
    rows = {}
    for banking in ("paper", "linear", "no_fractal"):
        tr = bulk_linear(16, payload_kb * 1024, burst=16)
        beats = payload_kb * 1024 // BEAT
        m = simulate(
            tr, SimParams(banking=banking, max_cycles=int(beats * 2.6) + 4000), device=device
        )
        rows[banking] = {
            "read_throughput": float(m["read_throughput"][:16].mean()),
            "read_lat": float(m["read_lat_avg"][:16].mean()),
        }
    # monolithic linear banking serializes a stream on one bank (0.5 b/cyc);
    # the paper's split+fractal dispatch sustains ~1 b/cyc per port
    assert rows["paper"]["read_throughput"] > rows["linear"]["read_throughput"] + 0.2
    # strided ML traffic hurts no_fractal more (power-of-two restriding)
    tr = adas_mixed_trace(16, max_txns=600)
    for banking in ("paper", "no_fractal"):
        m = simulate(tr, SimParams(banking=banking, max_cycles=30_000), device=device)
        rows[f"trace_{banking}"] = {
            "read_lat": float(m["read_lat_avg"][:8].mean()),
            "read_throughput": float(m["read_throughput"][:8].mean()),
        }
    return rows


def qos_isolation(*, num_txns: int = 200, device=None) -> Dict:
    """Victim latency alone vs with 15 aggressors (disjoint regions)."""
    full = adas_mixed_trace(16, max_txns=num_txns)
    victim = Trace(full.is_write[:1], full.burst[:1], full.addr[:1])
    rep = interference_report(victim, full, SimParams(max_cycles=30_000), device=device)
    assert rep["read_lat_degradation"] < 60, rep  # bounded interference
    return rep


def pool_balance(*, blocks: int = 512, banks: int = 16, rounds: int = 300, device=None) -> Dict:
    """Fractal vs sequential block placement under alloc/free churn.  The
    pool runs on the host: ``device`` is taken for a signature common to
    every job and not used."""
    rng = np.random.default_rng(0)
    out = {}
    for placement in ("fractal", "sequential"):
        pool = BankedKVPool(blocks, 16, num_banks=banks, placement=placement)
        live = []
        worst = 1.0
        for t in range(rounds):
            if live and rng.random() < 0.45:
                rid = live.pop(rng.integers(len(live)))
                pool.free(rid)
            else:
                rid = 10_000 + t
                if pool.alloc(rid, int(rng.integers(1, 9))) is not None:
                    live.append(rid)
            assert pool.check_isolation()
            if (pool.owner >= 0).sum() >= banks:
                worst = max(worst, pool.imbalance())
        out[placement] = {
            "worst_imbalance": round(worst, 3),
            "final_imbalance": round(pool.imbalance(), 3),
        }
    assert out["fractal"]["worst_imbalance"] <= out["sequential"]["worst_imbalance"] + 1e-9
    return out


def moe_whitening(*, device=None) -> Dict:
    """Capacity-drop position bias with and without the fractal permutation:
    olmoe-1b-7b's routing (64 experts, top-8) at capacity factor 0.5 through
    the port's ``route`` in float32 on ``device``."""
    import dataclasses

    import torch

    from repro_torch.configs import get_config
    from repro_torch.core.simulator import _resolve_device
    from repro_torch.models.moe import expert_capacity, route

    dev = _resolve_device(device)
    cfg = dataclasses.replace(get_config("olmoe-1b-7b"), moe_capacity_factor=0.5)  # force drops
    rng = np.random.default_rng(0)
    x = torch.as_tensor(rng.normal(size=(4, 512, 64)), dtype=torch.float32, device=dev)
    router = torch.as_tensor(
        rng.normal(size=(64, cfg.moe_num_experts)), dtype=torch.float32, device=dev
    )
    out = {}
    C = expert_capacity(cfg, 512)
    for whiten in (True, False):
        _, _, slot, _ = route(cfg, x, router, whiten=whiten)
        dropped = (slot >= C).cpu().numpy()  # [B, S, K]
        pos_frac = dropped[:, 384:, :].sum() / max(dropped.sum(), 1)
        out["fractal" if whiten else "tail_drop"] = {
            "drop_rate": float(dropped.mean()),
            "fraction_of_drops_in_last_quarter": float(pos_frac),
        }
    # whitened drops are position-uniform (~25 % in the last quarter);
    # unwhitened GShard-style ranks drop the tail disproportionately
    assert out["fractal"]["fraction_of_drops_in_last_quarter"] < 0.35
    assert out["tail_drop"]["fraction_of_drops_in_last_quarter"] > 0.4
    return out
