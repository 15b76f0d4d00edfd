"""Typed, width-packed simulator state: what the cycle loop carries.

:class:`SimState` holds one tensor per field with an explicit *narrow* dtype
and a leading batch axis ``B`` (one lane per simulated point; ``simulate``
runs ``B = 1``):

=================  ==========  =============================================
field              dtype       contents (shape)
=================  ==========  =============================================
now                int32       current fabric cycle [B]
next_txn           int32       next transaction index per port [B, X]
outstanding        int16       in-flight commands per port+channel [B, X, 2]
credits            int16       split-buffer credits per port+channel [B, X, 2]
beats_issued       int32       beats ever dispatched per port [B, X]
fwd_free           int32       W-channel data-bus free time [B, X]
reg_tokens         int32       regulator bucket, 1/256-beat fixed pt [B, X]
busy_r/w/any       int32       busy-cycle counters [B, X]
sl_flags           uint8       PACKED: slot phase (2 bits) | write bit [B, X, P]
sl_bank            int16/32    target bank per slot [B, X, P] (see bank_dtype)
sl_arrive          int32       cycle the beat reaches its bank queue [B, X, P]
sl_ready           int32       cycle the read beat may return [B, X, P]
sl_txn             int16/32    owning transaction per slot [B, X, P]
sl_hops            int8        inter-slice ring hops per slot [B, X, P]
bank_free          int32       bank busy-until cycle [B, NB]
bank_rr            int32       round-robin pointer basis [B, NB]
ing_used           int32       remote beats in flight per slice [B, NSL]
slice_beats        int32       beats served per slice [B, NSL]
remote_beats       int32       total router-crossing beats [B]
remaining          int8        undelivered beats per transaction [B, X, N]
accept_cycle       int32       acceptance timestamp per transaction [B, X, N]
complete_cycle     int32       completion timestamp per transaction [B, X, N]
beats_done         int32       read beats returned per port [B, X]
drained_at         int32       cycle the lane went quiescent, -1 if never [B]
skipped            int32       idle cycles jumped by the time skip [B]
=================  ==========  =============================================

Stage functions never do arithmetic in the narrow dtypes: PyTorch keeps an
``int16`` plus a Python int in ``int16`` and shifts a ``uint8`` in ``uint8``.
:func:`widen` and :func:`unpack_slot_flags` give ``int32`` views on read, and
each stage casts back to the field's dtype on write, so the arithmetic is the
reference package's int32 arithmetic and the narrow types are only storage.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import torch

#: "infinite" cycle sentinel (also the arbitration-key filler ceiling)
INF32 = 2**30

#: fixed-point scale of the regulator token bucket (tokens per beat)
REG_SCALE = 256

#: slot phase values carried in the low 2 bits of ``sl_flags``
SLOT_IDLE, SLOT_WAITING, SLOT_GRANTED = 0, 1, 2
_PHASE_MASK = 0b11
_WRITE_SHIFT = 2


def bank_dtype(num_banks: int) -> torch.dtype:
    """Narrowest signed dtype that can index ``num_banks`` banks *plus* the
    out-of-range filler value ``num_banks``."""
    return torch.int16 if num_banks < 2**15 - 1 else torch.int32


def txn_dtype(num_txns: int) -> torch.dtype:
    """Narrowest signed dtype for transaction indices in [0, num_txns]."""
    return torch.int16 if num_txns < 2**15 - 1 else torch.int32


def pack_slot_flags(phase: torch.Tensor, write: torch.Tensor) -> torch.Tensor:
    """Pack (slot phase, write bit) int32 views into the uint8 store."""
    return (phase | (write << _WRITE_SHIFT)).to(torch.uint8)


def unpack_slot_flags(flags: torch.Tensor):
    """uint8 store -> readable (phase, write) int32 views."""
    f = flags.to(torch.int32)
    return f & _PHASE_MASK, f >> _WRITE_SHIFT


def widen(x: torch.Tensor) -> torch.Tensor:
    """Narrow storage -> int32 compute view."""
    return x.to(torch.int32)


@dataclass(frozen=True)
class SimState:
    """One cycle's complete simulator state (see the module table)."""

    now: torch.Tensor
    next_txn: torch.Tensor
    outstanding: torch.Tensor
    credits: torch.Tensor
    beats_issued: torch.Tensor
    fwd_free: torch.Tensor
    reg_tokens: torch.Tensor
    busy_r: torch.Tensor
    busy_w: torch.Tensor
    busy_any: torch.Tensor
    sl_flags: torch.Tensor
    sl_bank: torch.Tensor
    sl_arrive: torch.Tensor
    sl_ready: torch.Tensor
    sl_txn: torch.Tensor
    sl_hops: torch.Tensor
    bank_free: torch.Tensor
    bank_rr: torch.Tensor
    ing_used: torch.Tensor
    slice_beats: torch.Tensor
    remote_beats: torch.Tensor
    remaining: torch.Tensor
    accept_cycle: torch.Tensor
    complete_cycle: torch.Tensor
    beats_done: torch.Tensor
    drained_at: torch.Tensor
    skipped: torch.Tensor

    def replace(self, **updates) -> "SimState":
        """Functional field update (the stage functions' write path)."""
        return dataclasses.replace(self, **updates)


def init_state(
    *, X: int, N: int, P: int, NB: int, NSL: int, tx_burst: torch.Tensor, d: dict
) -> SimState:
    """Cycle-0 dense state for ``B`` lanes of ``X`` ports x ``P`` ring slots,
    ``N`` transactions, ``NB`` banks and ``NSL`` slices.  ``d`` maps dyn-field
    names to ``[B]`` int32 tensors (credits and regulator buckets start from
    them); ``tx_burst`` ``[B, X, N]`` seeds the remaining-beat counters."""
    B = tx_burst.shape[0]
    dev = tx_burst.device

    def zeros(*shape, dtype=torch.int32):
        return torch.zeros((B, *shape), dtype=dtype, device=dev)

    def full(value, *shape, dtype=torch.int32):
        return torch.full((B, *shape), value, dtype=dtype, device=dev)

    burst = widen(tx_burst)
    return SimState(
        now=zeros(),
        next_txn=zeros(X),
        outstanding=zeros(X, 2, dtype=torch.int16),
        credits=(zeros(X, 2) + d["split_buffer"][:, None, None]).to(torch.int16),
        beats_issued=zeros(X),
        fwd_free=zeros(X),
        reg_tokens=zeros(X) + d["reg_burst"][:, None] * REG_SCALE,
        busy_r=zeros(X),
        busy_w=zeros(X),
        busy_any=zeros(X),
        sl_flags=zeros(X, P, dtype=torch.uint8),
        sl_bank=zeros(X, P, dtype=bank_dtype(NB)),
        sl_arrive=full(INF32, X, P),
        sl_ready=full(INF32, X, P),
        sl_txn=zeros(X, P, dtype=txn_dtype(N)),
        sl_hops=zeros(X, P, dtype=torch.int8),
        bank_free=zeros(NB),
        bank_rr=zeros(NB),
        ing_used=zeros(NSL),
        slice_beats=zeros(NSL),
        remote_beats=zeros(),
        remaining=torch.where(burst > 0, burst, 0).to(torch.int8),
        accept_cycle=full(-1, X, N),
        complete_cycle=full(-1, X, N),
        beats_done=zeros(X),
        drained_at=full(-1),
        skipped=zeros(),
    )
