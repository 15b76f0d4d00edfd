"""Optimizers of the port: the reference's ``optim/`` on trees of tensors."""

from repro_torch.optim.compression import init_ef_state, int8_ef_compress
from repro_torch.optim.optimizers import (
    OptimizerSpec,
    clip_by_global_norm,
    global_norm,
    lr_schedule,
    make_optimizer,
)

__all__ = [
    "OptimizerSpec",
    "clip_by_global_norm",
    "global_norm",
    "init_ef_state",
    "int8_ef_compress",
    "lr_schedule",
    "make_optimizer",
]
