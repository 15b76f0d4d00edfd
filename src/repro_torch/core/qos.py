"""QoS policy and isolation analysis (paper §II-C challenge 3, ISO 26262).

The comparator key the per-bank QoS arbiter minimizes is defined once, here:
the arbitration stage builds its keys with it and the bank-arbiter kernel
reduces them.  Beside it, numpy copies of the reference package's isolation
checks:
  1. *Static isolation*: masters with disjoint address regions never touch
     the same sub-bank (``regions_isolated``, ``subbank_isolated``).
  2. *Dynamic interference*: a victim master run alone and among aggressors,
     as two lanes of one batch (``interference_report``).
"""

from __future__ import annotations

from typing import TYPE_CHECKING, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.address import MemoryGeometry, flat_bank_id, sub_bank_id

if TYPE_CHECKING:  # type-only: the simulator imports this module's policy
    from repro_torch.core.simulator import SimParams, Trace


def aging_boost(age: torch.Tensor, qos_aging: torch.Tensor) -> torch.Tensor:
    """Anti-starvation promotion: one priority level per ``qos_aging`` cycles
    of waiting (``qos_aging == 0`` disables aging, i.e. pure priority).
    ``qos_aging`` broadcasts against ``age`` (a per-lane column)."""
    return torch.where(qos_aging > 0, age // torch.clamp(qos_aging, min=1), 0)


def arbitration_priority_key(
    level: torch.Tensor, age: torch.Tensor, rr_dist: torch.Tensor, *, age_cap: int, num_masters: int
) -> torch.Tensor:
    """Packed lexicographic (QoS level, FCFS age, round-robin distance)
    comparator key, smaller wins.  ``age`` saturates at ``age_cap`` (chosen by
    the simulator so it cannot saturate within a run) and the whole key stays
    strictly below the ineligible filler ``2**30``."""
    return (level * (age_cap + 1) + (age_cap - age)) * num_masters + rr_dist


def touched_subbanks(
    addr: np.ndarray, burst: np.ndarray, geom: MemoryGeometry = MemoryGeometry()
) -> np.ndarray:
    """Set of (bank, sub-bank) granules a master's trace touches."""
    beats = [np.arange(a, a + b) for a, b in zip(addr, burst) if b > 0]
    if not beats:
        return np.zeros((0,), np.int64)
    beats = np.concatenate(beats)
    granule = flat_bank_id(beats, geom).astype(np.int64) * geom.sub_banks + sub_bank_id(beats, geom)
    return np.unique(granule)


def touched_intervals(addr: np.ndarray, burst: np.ndarray) -> List[Tuple[int, int]]:
    """Sorted, merged [lo, hi) beat intervals a master's trace touches."""
    ivs = sorted((int(a), int(a) + int(b)) for a, b in zip(addr, burst) if b > 0)
    merged: List[Tuple[int, int]] = []
    for lo, hi in ivs:
        if merged and lo <= merged[-1][1]:
            merged[-1] = (merged[-1][0], max(merged[-1][1], hi))
        else:
            merged.append((lo, hi))
    return merged


def regions_isolated(
    trace: "Trace", geom: MemoryGeometry = MemoryGeometry(), groups: Optional[Sequence[int]] = None
) -> bool:
    """True iff no two masters touch the same *address* (the paper's
    "accessing memory spaces don't have any overlap" requirement), comparing
    the touched beat intervals rather than per-master bounding boxes.

    ``groups`` (one label per master) collapses masters with equal labels
    into one logical master: overlap *within* a group is allowed (serving
    ports sharing one KV pool declare a ``share_group``)."""
    tagged = []
    for m in range(trace.num_masters):
        label = m if groups is None else groups[m]
        for lo, hi in touched_intervals(trace.addr[m], trace.burst[m]):
            tagged.append((lo, hi, label))
    tagged.sort()
    # sorted by lo, any overlapping pair involves the running-max interval
    cur_hi, cur_m = -1, -1
    for lo, hi, m in tagged:
        if lo < cur_hi and m != cur_m:
            return False
        if hi > cur_hi:
            cur_hi, cur_m = hi, m
    return True


def subbank_isolated(trace: "Trace", geom: MemoryGeometry = MemoryGeometry()) -> bool:
    """Stronger ASIL isolation: no two masters share a (bank, sub-bank)
    granule, attainable for up to ``geom.sub_banks`` masters whose regions
    align with the sub-bank slicing (§II-C replicated arbitration)."""
    seen = {}
    for m in range(trace.num_masters):
        for x in touched_subbanks(trace.addr[m], trace.burst[m], geom):
            if x in seen and seen[x] != m:
                return False
            seen[x] = m
    return True


def interference_report(
    victim_trace: "Trace", full_trace: "Trace", prm: Optional["SimParams"] = None, device=None
) -> Dict[str, float]:
    """Victim-alone vs victim-among-aggressors latency/throughput deltas,
    both runs as two lanes of one batch on ``device`` (default: CUDA).
    ``full_trace`` row 0 must equal the victim's row; the victim trace is
    padded to the full trace's [X, N] (padding rows are inert)."""
    from repro_torch.core.simulator import SimParams, simulate_batch
    from repro_torch.core.traffic import stack_traces

    if prm is None:
        prm = SimParams()
    out = simulate_batch(stack_traces([victim_trace, full_trace]), [prm, prm], device=device)
    alone = {k: np.asarray(v)[0] for k, v in out.items()}
    together = {k: np.asarray(v)[1] for k, v in out.items()}
    return {
        "alone_read_lat": float(alone["read_lat_avg"][0]),
        "together_read_lat": float(together["read_lat_avg"][0]),
        "read_lat_degradation": float(together["read_lat_avg"][0] - alone["read_lat_avg"][0]),
        "alone_read_lat_max": float(alone["read_lat_max"][0]),
        "together_read_lat_max": float(together["read_lat_max"][0]),
        "alone_tput": float(alone["read_throughput"][0]),
        "together_tput": float(together["read_throughput"][0]),
    }
