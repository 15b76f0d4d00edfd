"""Entry point of the flash-attention forward.

``flash_attention`` is what prefill attention calls, once per layer, on the
prompt's fresh Q, K and V.  On CUDA tensors it launches a hand-written
Hopper kernel (``csrc/flash_attention.cu``) and counts the launch in
``repro_torch.kernels.LAUNCHES["flash_attention"]``: bfloat16 inputs go to
the tensor-core kernel (``wgmma`` fed by TMA), float32 inputs to the
CUDA-core kernel, which keeps float32's digits where the tensor cores would
round to TF32.  The split is by type; a launch that fails raises.  On CPU
tensors it runs the plain version (``ref.py``).  There is no fallback
between any two of these.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import LAUNCHES, _build
from repro_torch.kernels.flash_attention.ref import flash_attention_ref

#: head dims the kernel is built for
HEAD_DIMS = (16, 32, 64, 128)
#: the kernel's C entry point per input dtype
_ENTRY = {torch.float32: "flash_attention_fwd_f32", torch.bfloat16: "flash_attention_fwd_bf16"}

_fns: dict = {}


def _kernel_fn(dtype: torch.dtype):
    if dtype not in _fns:
        fn = getattr(_build.load("flash_attention"), _ENTRY[dtype])
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 8
        fn.argtypes += [ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fns[dtype] = fn
    return _fns[dtype]


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, window: int) -> None:
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(
            f"q must be [B, S, H, D] and k/v one [B, T, G, D] shape; got "
            f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}"
        )
    B, S, H, D = q.shape
    if k.shape[0] != B or k.shape[3] != D or H % k.shape[2]:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} do not fit as GQA")
    if D not in HEAD_DIMS:
        raise ValueError(f"head dim {D}: the kernel is built for {HEAD_DIMS}")
    if q.dtype not in _ENTRY or {k.dtype, v.dtype} != {q.dtype}:
        raise TypeError(f"q/k/v must share float32 or bfloat16; got {q.dtype}/{k.dtype}/{v.dtype}")
    if q.device.type != "cuda" or {k.device, v.device} != {q.device}:
        raise ValueError(f"q/k/v must lie on one CUDA device; got {q.device}/{k.device}/{v.device}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("q, k and v must be contiguous")
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("q, k and v must start on 16-byte boundaries (TMA)")
    if window < 0 or B >= 2**16 or H >= 2**16 or max(S, k.shape[1]) >= 2**31:
        raise ValueError(f"unsupported sizes: B={B}, H={H}, S={S}, window={window}")


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: int = 0,
    scale=None,
) -> torch.Tensor:
    """q ``[B, S, H, D]``, k/v ``[B, T, G, D]`` -> ``[B, S, H, D]``: causal
    and/or windowed GQA attention, keys masked by their true length ``T``."""
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, causal=causal, window=window, scale=scale)
    _check(q, k, v, window)
    B, S, H, D = q.shape
    T, G = k.shape[1], k.shape[2]
    scale = scale if scale is not None else D**-0.5
    out = torch.empty_like(q)
    if B == 0 or S == 0:
        return out
    err = _kernel_fn(q.dtype)(
        q.data_ptr(),
        k.data_ptr(),
        v.data_ptr(),
        out.data_ptr(),
        B,
        S,
        T,
        H,
        G,
        D,
        int(causal),
        int(window),
        float(scale),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: cudaError_t {err}")
    LAUNCHES["flash_attention"] += 1
    return out
