"""Entry point of the per-bank QoS arbitration comparator tree.

``bank_arbiter_winners`` is what the simulator's arbitration stage calls once
per simulated cycle.  On a CUDA tensor it launches the hand-written Hopper
kernel (``csrc/bank_arbiter.cu``) and counts the launch in
``repro_torch.kernels.LAUNCHES["bank_arbiter"]``; on a CPU tensor it runs the
plain PyTorch version (``ref.py``).  There is no fallback between the two.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import LAUNCHES, _build, sm_count
from repro_torch.kernels.bank_arbiter.ref import bank_arbiter_ref

#: banks the kernel takes.  A CTA keeps 16 bytes per bank in dynamic shared
#: memory (best[NB] and, at C > 1, its merge inbox) beside at most 36 KB of
#: staging: up to 132 KB at 6144 banks, under the 227 KB a CTA may opt into on
#: sm_90 (the launch opts in above 48 KB)
MAX_BANKS = 6144
#: CTAs per lane the kernel takes: the portable thread-block cluster sizes
CLUSTER_SIZES = (1, 2, 4, 8)
#: a lane is spread over more CTAs only while each keeps this many slots
MIN_SLOTS_PER_CTA = 512
#: slots a CTA stages in shared memory at a time, and the block size cap
MAX_TILE, MAX_THREADS = 4096, 512

_fns: dict = {}


def _lib():
    if not _fns:
        lib = _build.load("bank_arbiter")
        for dtype, fn in ((torch.int16, lib.bank_arbiter_i16), (torch.int32, lib.bank_arbiter_i32)):
            fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
            fn.restype = ctypes.c_int
            _fns[dtype] = fn
        lib.bank_arbiter_floor.argtypes = [ctypes.c_int] * 6 + [ctypes.c_void_p]
        lib.bank_arbiter_floor.restype = ctypes.c_int
        _fns["floor"] = lib.bank_arbiter_floor
        lib.bank_arbiter_smem_bytes.argtypes = [ctypes.c_int] * 4
        lib.bank_arbiter_smem_bytes.restype = ctypes.c_int
        _fns["smem_bytes"] = lib.bank_arbiter_smem_bytes
    return _fns


@functools.cache
def launch_shape(B: int, S: int, num_sms: int, cluster: int | None = None) -> tuple[int, int, int]:
    """``(CTAs per lane, threads per CTA, slots per tile)`` of the launch,
    memoized: the simulator calls the wrapper at one shape every cycle.

    The cluster size is the smallest portable one whose ``B * C`` CTAs cover
    the card's SMs, so it is 1 once ``B`` alone fills the card, and it stops
    growing where a CTA would keep fewer than ``MIN_SLOTS_PER_CTA`` slots.
    ``cluster`` forces it (tests).  A CTA folds ``ceil(S / C)`` slots, rounded
    up to 16, in tiles of at most ``MAX_TILE`` staged in shared memory, with
    one thread per two slots of a tile, in whole warps, at most
    ``MAX_THREADS``."""
    if cluster is None:
        fit = max(1, S // MIN_SLOTS_PER_CTA)
        cluster = next(
            (c for c in CLUSTER_SIZES if B * c >= num_sms or 2 * c > fit), CLUSTER_SIZES[-1]
        )
    elif cluster not in CLUSTER_SIZES:
        raise ValueError(f"cluster={cluster}; the kernel takes {CLUSTER_SIZES} CTAs per lane")
    share = -(-S // cluster)
    tile = min(MAX_TILE, max(16, -(-share // 16) * 16))
    return cluster, min(MAX_THREADS, 32 * -(-tile // 64)), tile


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
    if not 1 <= num_banks <= MAX_BANKS:
        raise ValueError(
            f"num_banks={num_banks}: the kernel keeps up to 16 bytes per bank in shared memory "
            f"and takes 1..{MAX_BANKS} banks"
        )
    if key.shape[1] >= 2**31 - MAX_TILE:
        raise ValueError(f"S={key.shape[1]} slots do not fit the kernel's int slot ids")


def bank_arbiter_winners(
    key: torch.Tensor,
    bank: torch.Tensor,
    elig: torch.Tensor,
    *,
    num_banks: int,
    _cluster: int | None = None,
) -> torch.Tensor:
    """Winning slot per bank: key/bank/elig ``[B, S]`` -> ``[B, num_banks]``
    int32, ``S`` where a bank has no eligible slot.  Keys must lie in
    ``[0, 2**30]`` and eligible slots' banks in ``[0, num_banks)``.
    ``_cluster`` forces the CTAs per lane (tests)."""
    if key.device.type == "cpu":
        return bank_arbiter_ref(key, bank, elig, num_banks=num_banks)
    _check(key, bank, elig, num_banks)
    B, S = key.shape
    cluster, threads, tile = launch_shape(B, S, sm_count(key.device), _cluster)
    win = torch.empty((B, num_banks), dtype=torch.int32, device=key.device)
    if B == 0:
        return win
    err = _lib()[bank.dtype](
        key.data_ptr(),
        bank.data_ptr(),
        elig.data_ptr(),
        win.data_ptr(),
        B,
        S,
        num_banks,
        cluster,
        threads,
        tile,
        torch.cuda.current_stream(key.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(
            f"bank_arbiter kernel launch failed (cluster {cluster}, {threads} threads): "
            f"cudaError_t {err}"
        )
    LAUNCHES["bank_arbiter"] += 1
    return win


def floor_launch(B: int, S: int, *, num_banks: int, device: torch.device) -> None:
    """Launch an empty kernel of the arbiter's launch shape at ``[B, S]`` with
    int16 banks, as the simulator passes them (grid, cluster, block, shared
    memory), on the current stream: the floor under the arbiter's device
    time.  Not counted in ``LAUNCHES``."""
    cluster, threads, tile = launch_shape(B, S, sm_count(device))
    stream = torch.cuda.current_stream(device).cuda_stream
    err = _lib()["floor"](B, num_banks, cluster, threads, tile, 2, stream)
    if err != 0:
        raise RuntimeError(f"bank_arbiter floor launch failed: cudaError_t {err}")
