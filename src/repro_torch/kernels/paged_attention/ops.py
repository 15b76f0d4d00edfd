"""Entry point of paged decode attention.

``paged_attention`` is what each decode step's attention calls, once per
layer, over that layer's K and V views of the pool.  On CUDA tensors it
launches the hand-written Hopper kernels (``csrc/paged_attention.cu``): the
split pass, one launch for every (group, request, span of the KV length),
counted in ``repro_torch.kernels.LAUNCHES["paged_attention"]``, then the
merge pass, counted under ``"paged_attention_merge"``.  The number of splits
comes from the block table's width, so the wrapper reads no device tensor on
the host.  On CPU tensors it runs the plain version (``ref.py``).  There is
no fallback between the two.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import LAUNCHES, _build
from repro_torch.kernels.paged_attention.ref import paged_attention_ref

#: head dims the kernel is built for (16-byte pieces of a token row per lane)
HEAD_DIMS = (16, 32, 64, 128)
#: query heads per KV group the kernel holds in registers
MAX_HEADS_PER_GROUP = 8
#: most splits the merge stages in shared memory (48 KB)
MAX_SPLITS = 6144
#: tokens a split covers at least: whole pool blocks, ceil(SPLIT_TOKENS / bs) of them
SPLIT_TOKENS = 256
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

_fns: dict = {}


def _kernel_fns():
    if not _fns:
        lib = _build.load("paged_attention")
        split = lib.paged_attention_split
        split.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 7 + [ctypes.c_longlong] * 2
        split.argtypes += [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
        merge = lib.paged_attention_merge
        merge.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
        for fn in (split, merge):
            fn.restype = ctypes.c_int
        _fns.update(split=split, merge=merge)
    return _fns["split"], _fns["merge"]


def blocks_per_split(block_size: int) -> int:
    """Pool blocks per split: the fewest whole blocks covering ``SPLIT_TOKENS``."""
    return -(-SPLIT_TOKENS // block_size)


def _check(q, k_pool, v_pool, block_table, lengths) -> None:
    if q.dim() != 3 or k_pool.dim() != 4 or v_pool.shape != k_pool.shape:
        raise ValueError(
            f"q must be [B, H, D] and k/v pools one [NB, bs, G, D] shape; got "
            f"{tuple(q.shape)}, {tuple(k_pool.shape)}, {tuple(v_pool.shape)}"
        )
    B, H, D = q.shape
    NB, bs, G, Dk = k_pool.shape
    if Dk != D or H % G or D not in HEAD_DIMS or H // G > MAX_HEADS_PER_GROUP:
        raise ValueError(
            f"H={H}, G={G}, D={D}: the kernel takes D in {HEAD_DIMS} and at most "
            f"{MAX_HEADS_PER_GROUP} query heads per KV group"
        )
    if block_table.dim() != 2 or block_table.shape[0] != B or lengths.shape != (B,):
        raise ValueError(
            f"block_table must be [B, mb] and lengths [B]; got {tuple(block_table.shape)}, "
            f"{tuple(lengths.shape)}"
        )
    if q.dtype not in _DTYPES or {k_pool.dtype, v_pool.dtype} != {q.dtype}:
        raise TypeError(f"q/k/v must share float32 or bfloat16; got {q.dtype}/{k_pool.dtype}")
    if block_table.dtype != torch.int32 or lengths.dtype != torch.int32:
        raise TypeError("block_table and lengths must be int32")
    devices = {q.device, k_pool.device, v_pool.device, block_table.device, lengths.device}
    if q.device.type != "cuda" or len(devices) != 1:
        raise ValueError(f"all inputs must lie on one CUDA device; got {devices}")
    if not (q.is_contiguous() and block_table.is_contiguous() and lengths.is_contiguous()):
        raise ValueError("q, block_table and lengths must be contiguous")
    for pool in (k_pool, v_pool):
        if pool.stride()[2:] != (D, 1):
            raise ValueError(f"pool views need contiguous [G, D] rows; strides {pool.stride()}")
    if k_pool.stride() != v_pool.stride():
        raise ValueError(f"k/v pool strides differ: {k_pool.stride()} vs {v_pool.stride()}")
    vec = 16 // q.element_size()
    if any(t.data_ptr() % 16 for t in (q, k_pool, v_pool)) or k_pool.stride(0) % vec or (
        k_pool.stride(1) % vec
    ):
        raise ValueError("q and the pools must start on 16 bytes and step by 16-byte rows")
    nsplit = -(-block_table.shape[1] // blocks_per_split(bs))
    if B >= 2**16 or G >= 2**31 or nsplit > MAX_SPLITS:
        raise ValueError(f"grid too large: B={B}, G={G}, splits={nsplit}")


def paged_attention(
    q: torch.Tensor,
    k_pool: torch.Tensor,
    v_pool: torch.Tensor,
    block_table: torch.Tensor,
    lengths: torch.Tensor,
    *,
    scale=None,
) -> torch.Tensor:
    """q ``[B, H, D]``; k/v pools ``[NB, bs, G, D]`` (strided views allowed,
    ``[G, D]`` contiguous); block_table ``[B, mb]`` int32 (-1 = unused);
    lengths ``[B]`` int32.  Returns ``[B, H, D]`` in q's dtype."""
    if q.device.type == "cpu":
        return paged_attention_ref(q, k_pool, v_pool, block_table, lengths, scale=scale)
    _check(q, k_pool, v_pool, block_table, lengths)
    B, H, D = q.shape
    _, bs, G, _ = k_pool.shape
    mb = block_table.shape[1]
    bps = blocks_per_split(bs)
    nsplit = -(-mb // bps)
    scale = scale if scale is not None else D**-0.5
    out = torch.empty_like(q)
    if B == 0:
        return out
    part_acc = torch.empty((B, H, nsplit, D), dtype=torch.float32, device=q.device)
    part_ms = torch.empty((B, H, nsplit, 2), dtype=torch.float32, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    split, merge = _kernel_fns()
    if nsplit:
        err = split(
            q.data_ptr(),
            k_pool.data_ptr(),
            v_pool.data_ptr(),
            block_table.data_ptr(),
            lengths.data_ptr(),
            part_acc.data_ptr(),
            part_ms.data_ptr(),
            B,
            H,
            G,
            D,
            mb,
            bs,
            bps,
            k_pool.stride(0),
            k_pool.stride(1),
            float(scale),
            _DTYPES[q.dtype],
            stream,
        )
        if err != 0:
            raise RuntimeError(f"paged_attention split kernel launch failed: cudaError_t {err}")
        LAUNCHES["paged_attention"] += 1
    err = merge(
        part_acc.data_ptr(),
        part_ms.data_ptr(),
        lengths.data_ptr(),
        out.data_ptr(),
        B,
        H,
        D,
        mb,
        bs,
        bps,
        _DTYPES[q.dtype],
        stream,
    )
    if err != 0:
        raise RuntimeError(f"paged_attention merge kernel launch failed: cudaError_t {err}")
    LAUNCHES["paged_attention_merge"] += 1
    return out
