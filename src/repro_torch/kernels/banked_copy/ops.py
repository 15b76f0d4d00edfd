"""Entry point of the banked burst scatter.

``banked_copy`` is what the serving engine calls once per admitted request to
move the prefill's fresh KV burst into the pool blocks the allocator chose.
On CUDA tensors it launches the hand-written Hopper kernel
(``csrc/banked_copy.cu``) and counts the launch in
``repro_torch.kernels.LAUNCHES["banked_copy"]``; on CPU tensors it runs the
plain version (``ref.py``).  There is no fallback between the two.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import LAUNCHES, _build
from repro_torch.kernels.banked_copy.ref import banked_copy_ref

_fns: dict = {}


def _kernel_fn():
    if not _fns:
        fn = _build.load("banked_copy").banked_copy
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_longlong]
        fn.argtypes += [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fns["fn"] = fn
    return _fns["fn"]


def _check(pool: torch.Tensor, new_kv: torch.Tensor, block_table: torch.Tensor) -> None:
    if pool.dim() != 3 or new_kv.dim() != 4 or block_table.dim() != 2:
        raise ValueError(
            "pool must be [NB, bs, W], new_kv [B, nblk, bs, W] and block_table [B, nblk]; got "
            f"{tuple(pool.shape)}, {tuple(new_kv.shape)}, {tuple(block_table.shape)}"
        )
    if new_kv.shape[:2] != block_table.shape or new_kv.shape[2:] != pool.shape[1:]:
        raise ValueError(
            f"new_kv {tuple(new_kv.shape)} does not match block_table "
            f"{tuple(block_table.shape)} and pool {tuple(pool.shape)}"
        )
    if new_kv.dtype != pool.dtype or block_table.dtype != torch.int32:
        raise TypeError(
            f"new_kv must have the pool's dtype and block_table int32; got "
            f"{pool.dtype}/{new_kv.dtype}/{block_table.dtype}"
        )
    if pool.device.type != "cuda" or {new_kv.device, block_table.device} != {pool.device}:
        raise ValueError(
            f"pool/new_kv/block_table must lie on one CUDA device; got "
            f"{pool.device}/{new_kv.device}/{block_table.device}"
        )
    if not (pool.is_contiguous() and new_kv.is_contiguous() and block_table.is_contiguous()):
        raise ValueError("pool, new_kv and block_table must be contiguous")
    if max(block_table.shape) >= 2**16 or pool.shape[0] >= 2**31:
        raise ValueError(f"grid too large: B, nblk = {tuple(block_table.shape)}")


def banked_copy(
    pool: torch.Tensor, new_kv: torch.Tensor, block_table: torch.Tensor
) -> torch.Tensor:
    """Scatter ``new_kv [B, nblk, bs, W]`` into ``pool [NB, bs, W]`` at
    ``block_table [B, nblk]`` (int32, -1 = skip), in place; returns ``pool``.
    Entries other than -1 must lie in ``[0, NB)`` and be unique."""
    if pool.device.type == "cpu":
        return banked_copy_ref(pool, new_kv, block_table)
    _check(pool, new_kv, block_table)
    B, nblk = block_table.shape
    tile_bytes = pool[0].numel() * pool.element_size()
    if B * nblk * tile_bytes == 0:
        return pool
    err = _kernel_fn()(
        pool.data_ptr(),
        new_kv.data_ptr(),
        block_table.data_ptr(),
        B,
        nblk,
        pool.shape[0],
        tile_bytes,
        torch.cuda.current_stream(pool.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"banked_copy kernel launch failed: cudaError_t {err}")
    LAUNCHES["banked_copy"] += 1
    return pool
