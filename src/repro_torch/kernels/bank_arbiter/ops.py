"""Entry point of the per-bank QoS arbitration comparator tree.

``bank_arbiter_winners`` is what the simulator's arbitration stage calls once
per simulated cycle.  On a CUDA tensor it launches the hand-written Hopper
kernel (``csrc/bank_arbiter.cu``) and counts the launch in
``repro_torch.kernels.LAUNCHES["bank_arbiter"]``; on a CPU tensor it runs the
plain PyTorch version (``ref.py``).  There is no fallback between the two.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import LAUNCHES, _build
from repro_torch.kernels.bank_arbiter.ref import bank_arbiter_ref

#: static shared memory a block may use without opting in (one u64 per bank)
SHARED_LIMIT = 48 * 1024

_fns: dict = {}


def _kernel_fn(bank_dtype: torch.dtype):
    if not _fns:
        lib = _build.load("bank_arbiter")
        for dtype, fn in ((torch.int16, lib.bank_arbiter_i16), (torch.int32, lib.bank_arbiter_i32)):
            fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
            fn.restype = ctypes.c_int
            _fns[dtype] = fn
    return _fns[bank_dtype]


def _check(key: torch.Tensor, bank: torch.Tensor, elig: torch.Tensor, num_banks: int) -> None:
    if key.dim() != 2 or bank.shape != key.shape or elig.shape != key.shape:
        raise ValueError(
            f"key/bank/elig must share one [B, S] shape; got "
            f"{tuple(key.shape)}/{tuple(bank.shape)}/{tuple(elig.shape)}"
        )
    if key.dtype != torch.int32 or bank.dtype not in (torch.int16, torch.int32):
        raise TypeError(f"key must be int32 and bank int16/int32; got {key.dtype}/{bank.dtype}")
    if elig.dtype != torch.bool:
        raise TypeError(f"elig must be bool; got {elig.dtype}")
    if key.device.type != "cuda" or bank.device != key.device or elig.device != key.device:
        devices = f"{key.device}/{bank.device}/{elig.device}"
        raise ValueError(f"key/bank/elig must lie on one CUDA device; got {devices}")
    if not (key.is_contiguous() and bank.is_contiguous() and elig.is_contiguous()):
        raise ValueError("key/bank/elig must be contiguous")
    if num_banks < 1 or num_banks * 8 > SHARED_LIMIT:
        raise ValueError(
            f"num_banks={num_banks} needs {num_banks * 8} bytes of shared memory; "
            f"the kernel takes 1..{SHARED_LIMIT // 8} banks"
        )
    if key.shape[1] >= 2**31:
        raise ValueError(f"S={key.shape[1]} slots do not fit the kernel's int slot ids")


def bank_arbiter_winners(
    key: torch.Tensor, bank: torch.Tensor, elig: torch.Tensor, *, num_banks: int
) -> torch.Tensor:
    """Winning slot per bank: key/bank/elig ``[B, S]`` -> ``[B, num_banks]``
    int32, ``S`` where a bank has no eligible slot.  Keys must lie in
    ``[0, 2**30]`` and eligible slots' banks in ``[0, num_banks)``."""
    if key.device.type == "cpu":
        return bank_arbiter_ref(key, bank, elig, num_banks=num_banks)
    _check(key, bank, elig, num_banks)
    B, S = key.shape
    win = torch.empty((B, num_banks), dtype=torch.int32, device=key.device)
    if B == 0:
        return win
    err = _kernel_fn(bank.dtype)(
        key.data_ptr(),
        bank.data_ptr(),
        elig.data_ptr(),
        win.data_ptr(),
        B,
        S,
        num_banks,
        torch.cuda.current_stream(key.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"bank_arbiter kernel launch failed: cudaError_t {err}")
    LAUNCHES["bank_arbiter"] += 1
    return win
