"""Entry point of the banked burst scatter.

``banked_copy`` is what the serving engine calls once per admitted request to
move the prefill's fresh KV burst into the pool blocks the allocator chose.
On CUDA tensors it plans the launch (``copy_plan``), launches the
hand-written Hopper kernel (``csrc/banked_copy.cu``) and counts the launch in
``repro_torch.kernels.LAUNCHES["banked_copy"]``; on CPU tensors it runs the
plain version (``ref.py``).  There is no fallback between the two.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import LAUNCHES, _build, sm_count
from repro_torch.kernels.banked_copy.ref import banked_copy_ref

#: bytes of a chunk: at most one round of the kernel's 128 threads x 8
#: 16-byte words (``kMaxChunk`` in the source); the plan aims at no fewer
#: than ``MIN_CHUNK``
MAX_CHUNK, MIN_CHUNK = 16384, 4096
#: chunks the plan aims at per SM
CHUNKS_PER_SM = 2

_fns: dict = {}


def _lib() -> ctypes.CDLL:
    if not _fns:
        lib = _build.load("banked_copy")
        plan = [ctypes.c_longlong] * 3 + [ctypes.c_int]  # tile chunk grid, word
        lib.banked_copy.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int, *plan, ctypes.c_void_p]
        lib.banked_copy_floor.argtypes = [ctypes.c_longlong, ctypes.c_void_p]
        for fn in (lib.banked_copy, lib.banked_copy_floor):
            fn.restype = ctypes.c_int
        _fns["lib"] = lib
    return _fns["lib"]


def copy_plan(B: int, nblk: int, tile_bytes: int, aligned: bool, num_sms: int) -> tuple[int, int]:
    """``(chunk_bytes, grid)`` of the kernel for a burst of ``B * nblk`` tiles
    of ``tile_bytes``: the kernel's CTA c copies chunk c, part c % per_tile of
    tile c // per_tile (per_tile = ceil(tile_bytes / chunk_bytes)).  Chunks
    never cross a tile's end (a tile's last chunk is shorter) and are whole
    128-byte cache lines where ``aligned`` (the tile and both base pointers
    16-byte aligned), so that no two CTAs write one line, else 4-byte
    multiples.  The chunk size comes from the burst's
    total bytes, ``CHUNKS_PER_SM`` chunks an SM within ``[MIN_CHUNK,
    MAX_CHUNK]``, evened out over each tile, so a burst of at least
    ``num_sms`` x 4 KB has at least ``num_sms`` chunks."""
    if tile_bytes <= 0:
        raise ValueError(f"tile_bytes must be positive; got {tile_bytes}")
    unit = 128 if aligned else 4
    total = B * nblk * tile_bytes
    target = min(max(total // (num_sms * CHUNKS_PER_SM), MIN_CHUNK), MAX_CHUNK) // unit * unit
    per_tile = _ceil_div(tile_bytes, target)
    chunk = _ceil_div(_ceil_div(tile_bytes, per_tile), unit) * unit
    return chunk, B * nblk * _ceil_div(tile_bytes, chunk)


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


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
    if pool.shape[0] >= 2**31:
        raise ValueError(f"pool too large for int32 rows: {pool.shape[0]} blocks")


def _plan_args(pool: torch.Tensor, new_kv: torch.Tensor, block_table: torch.Tensor) -> list:
    """The kernel's whole plan, as the C function takes it after the pointers
    and ``NB``: ``tile_bytes``, ``chunk_bytes``, ``grid``, the word size
    (16, 4 or 1 bytes: the largest that the tile and both base pointers are
    aligned to) and the stream."""
    B, nblk = block_table.shape
    tile_bytes = pool[0].numel() * pool.element_size()
    word = next(
        w
        for w in (16, 4, 1)
        if tile_bytes % w == 0 and pool.data_ptr() % w == 0 and new_kv.data_ptr() % w == 0
    )
    chunk, grid = copy_plan(B, nblk, tile_bytes, word == 16, sm_count(pool.device))
    if grid >= 2**31:
        raise ValueError(f"grid too large: {grid} CTAs for B, nblk = {(B, nblk)}")
    stream = torch.cuda.current_stream(pool.device).cuda_stream
    return [tile_bytes, chunk, grid, word, stream]


def banked_copy(
    pool: torch.Tensor, new_kv: torch.Tensor, block_table: torch.Tensor
) -> torch.Tensor:
    """Scatter ``new_kv [B, nblk, bs, W]`` into ``pool [NB, bs, W]`` at
    ``block_table [B, nblk]`` (int32, -1 = skip), in place; returns ``pool``.
    Entries other than -1 must lie in ``[0, NB)`` and be unique."""
    if pool.device.type == "cpu":
        return banked_copy_ref(pool, new_kv, block_table)
    _check(pool, new_kv, block_table)
    if new_kv.numel() == 0:
        return pool
    err = _lib().banked_copy(
        pool.data_ptr(),
        new_kv.data_ptr(),
        block_table.data_ptr(),
        pool.shape[0],
        *_plan_args(pool, new_kv, block_table),
    )
    if err != 0:
        raise RuntimeError(f"banked_copy kernel launch failed: cudaError_t {err}")
    LAUNCHES["banked_copy"] += 1
    return pool


def floor_launch(pool: torch.Tensor, new_kv: torch.Tensor, block_table: torch.Tensor) -> None:
    """Launch an empty kernel of ``banked_copy``'s launch shape for these
    arguments (its grid and block) on the current stream: the floor under
    its device time.  Not counted in ``LAUNCHES``."""
    _check(pool, new_kv, block_table)
    if new_kv.numel() == 0:
        return
    _, _, grid, _, stream = _plan_args(pool, new_kv, block_table)
    err = _lib().banked_copy_floor(grid, stream)
    if err != 0:
        raise RuntimeError(f"banked_copy floor launch failed: cudaError_t {err}")
