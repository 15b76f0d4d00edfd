"""Arbitration policy: the comparator key the per-bank QoS arbiter minimizes.

The single definition of the grant order for the port: the arbitration stage
builds its keys here and the bank-arbiter kernel reduces them.  The isolation
analysis of the reference package's ``core/qos.py`` is not ported yet.
"""

from __future__ import annotations

import torch


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
