"""Entry point of paged decode attention.

``paged_attention`` is what each decode step's attention calls, once per
layer, over that layer's K and V views of the pool.  On CUDA tensors it
launches the hand-written Hopper kernel (``csrc/paged_attention.cu``), one
launch for all KV groups, and counts it in
``repro_torch.kernels.LAUNCHES["paged_attention"]``; on CPU tensors it runs
the plain version (``ref.py``).  There is no fallback between the two.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import LAUNCHES, _build
from repro_torch.kernels.paged_attention.ref import paged_attention_ref

#: head dims the kernel is built for (32 lanes, each owning D / 32 dims)
HEAD_DIMS = (32, 64, 128)
#: query heads per KV group the kernel holds in registers
MAX_HEADS_PER_GROUP = 8
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

_fns: dict = {}


def _kernel_fn():
    if not _fns:
        fn = _build.load("paged_attention").paged_attention
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [ctypes.c_longlong] * 2
        fn.argtypes += [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fns["fn"] = fn
    return _fns["fn"]


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
    if B >= 2**16 or G >= 2**31:
        raise ValueError(f"grid too large: B={B}, G={G}")


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
    scale = scale if scale is not None else D**-0.5
    out = torch.empty_like(q)
    if B == 0:
        return out
    err = _kernel_fn()(
        q.data_ptr(),
        k_pool.data_ptr(),
        v_pool.data_ptr(),
        block_table.data_ptr(),
        lengths.data_ptr(),
        out.data_ptr(),
        B,
        H,
        G,
        D,
        block_table.shape[1],
        bs,
        k_pool.stride(0),
        k_pool.stride(1),
        float(scale),
        _DTYPES[q.dtype],
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"paged_attention kernel launch failed: cudaError_t {err}")
    LAUNCHES["paged_attention"] += 1
    return out
