"""Entry points of flash attention: the forward, and for training its
log-sum-exp and the backward.

``flash_attention`` is what prefill attention calls, once per layer, on the
prompt's fresh Q, K and V.  On CUDA tensors it launches a hand-written
Hopper kernel (``csrc/flash_attention.cu``) and counts the launch in
``repro_torch.kernels.LAUNCHES["flash_attention"]``: bfloat16 inputs go to
the tensor-core kernel (``wgmma`` fed by TMA), float32 inputs to the
CUDA-core kernel, which keeps float32's digits where the tensor cores would
round to TF32.  The split is by type; a launch that fails raises.  On CPU
tensors it runs the plain version (``ref.py``).  There is no fallback
between any two of these.  V may have a width of its own: MLA (deepseek-v2)
attends with q/k heads of 192 and v heads of 128 (``WIDTHS``).

Training goes through ``flash_attention_train``, a ``torch.autograd.Function``
whose forward is ``flash_attention_fwd`` (the same kernel, also writing each
row's log-sum-exp ``[B, H, S]``, float32) and whose backward is
``flash_attention_bwd``: on CUDA tensors the hand-written kernel of
``kernels/flash_attention_bwd`` (counted in ``LAUNCHES["flash_attention_bwd"]``;
bfloat16 on the tensor cores with ``dout`` read through TMA, float32 on the
CUDA cores), on CPU tensors the plain blockwise backward of ``ref.py``.
Training takes the widths of ``WIDTHS`` too: the square ones (GQA) and MLA's
(192, 128), where out, dout and dV are v's width and dQ, dK q's.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import LAUNCHES, _build
from repro_torch.kernels.flash_attention.ref import (
    FlashAttentionFunction,
    flash_attention_bwd_ref,
    flash_attention_fwd_ref,
    flash_attention_ref,
)

#: head dims the kernels are built for where q, k and v share one
HEAD_DIMS = (16, 32, 64, 128)
#: (q/k width, v width) pairs the forward, its log-sum-exp and the backward
#: are built for: the square ones and MLA's (deepseek-v2: 128 + 64 RoPE
#: dims, v 128)
WIDTHS = tuple((d, d) for d in HEAD_DIMS) + ((192, 128),)
#: the kernel's C entry point per input dtype
_ENTRY = {torch.float32: "flash_attention_fwd_f32", torch.bfloat16: "flash_attention_fwd_bf16"}

#: the backward kernel's C entry point per input dtype
_ENTRY_BWD = {torch.float32: "flash_attention_bwd_f32", torch.bfloat16: "flash_attention_bwd_bf16"}

_fns: dict = {}


def _kernel_fn(dtype: torch.dtype):
    if dtype not in _fns:
        fn = getattr(_build.load("flash_attention"), _ENTRY[dtype])
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 9
        fn.argtypes += [ctypes.c_float, ctypes.c_void_p, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fns[dtype] = fn
    return _fns[dtype]


def _bwd_fn(dtype: torch.dtype):
    key = ("bwd", dtype)
    if key not in _fns:
        fn = getattr(_build.load("flash_attention_bwd"), _ENTRY_BWD[dtype])
        fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 9
        fn.argtypes += [ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fns[key] = fn
    return _fns[key]


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, window: int) -> None:
    if q.dim() != 4 or k.dim() != 4 or v.shape[:3] != k.shape[:3]:
        raise ValueError(
            f"q must be [B, S, H, D], k [B, T, G, D] and v [B, T, G, Dv]; got "
            f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}"
        )
    B, S, H, D = q.shape
    if k.shape[0] != B or k.shape[3] != D or H % k.shape[2]:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} do not fit as GQA")
    if (D, v.shape[3]) not in WIDTHS:
        raise ValueError(
            f"q/k width {D}, v width {v.shape[3]}: the kernel is built for (q/k, v) in {WIDTHS}"
        )
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


def _launch_fwd(q, k, v, out, lse, causal: bool, window: int, scale: float) -> None:
    B, S, H, D = q.shape
    T, G, Dv = k.shape[1], k.shape[2], v.shape[3]
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
        Dv,
        int(causal),
        int(window),
        float(scale),
        None if lse is None else lse.data_ptr(),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: cudaError_t {err}")
    LAUNCHES["flash_attention"] += 1


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: int = 0,
    scale=None,
) -> torch.Tensor:
    """q ``[B, S, H, D]``, k ``[B, T, G, D]``, v ``[B, T, G, Dv]`` -> ``[B, S,
    H, Dv]``: causal and/or windowed GQA attention, keys masked by their true
    length ``T``; ``scale`` defaults to ``D ** -0.5``."""
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, causal=causal, window=window, scale=scale)
    _check(q, k, v, window)
    scale = scale if scale is not None else q.shape[3] ** -0.5
    out = q.new_empty((*q.shape[:3], v.shape[3]))
    if q.shape[0] == 0 or q.shape[1] == 0:
        return out
    _launch_fwd(q, k, v, out, None, causal, window, scale)
    return out


def flash_attention_fwd(q, k, v, *, causal: bool = True, window: int = 0, scale=None):
    """``flash_attention`` that also returns each row's log-sum-exp
    ``[B, H, S]`` (float32, scaled-score domain; -inf for a row with no
    key): the forward of training attention."""
    if q.device.type == "cpu":
        return flash_attention_fwd_ref(q, k, v, causal=causal, window=window, scale=scale)
    _check(q, k, v, window)
    B, S, H, D = q.shape
    scale = scale if scale is not None else D**-0.5
    out = q.new_empty((B, S, H, v.shape[3]))
    lse = torch.empty((B, H, S), dtype=torch.float32, device=q.device)
    if B and S:
        _launch_fwd(q, k, v, out, lse, causal, window, scale)
    return out, lse


def flash_attention_bwd(
    q, k, v, out, lse, dout, *, causal: bool = True, window: int = 0, scale=None
):
    """dQ, dK, dV of :func:`flash_attention_fwd` for the output gradient
    ``dout`` (the shape and dtype of ``out``, ``[B, S, H, Dv]``); see ``ref.flash_attention_bwd_ref``
    for the function.  One launch of the backward kernel on CUDA tensors
    (deterministic: no atomics), the plain version on CPU tensors."""
    if q.device.type == "cpu":
        return flash_attention_bwd_ref(
            q, k, v, out, lse, dout, causal=causal, window=window, scale=scale
        )
    _check(q, k, v, window)
    B, S, H, D = q.shape
    T, G, Dv = k.shape[1], k.shape[2], v.shape[3]
    for name, t in (("out", out), ("dout", dout)):
        if t.shape != (B, S, H, Dv) or t.dtype != q.dtype or t.device != q.device:
            raise ValueError(
                f"{name} must be [B, S, H, Dv] = {(B, S, H, Dv)}, {q.dtype} on {q.device}; got "
                f"{tuple(t.shape)}, {t.dtype} on {t.device}"
            )
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if dout.data_ptr() % 16:
        raise ValueError("dout must start on a 16-byte boundary (TMA)")
    if (
        lse.shape != (B, H, S)
        or lse.dtype != torch.float32
        or lse.device != q.device
        or not lse.is_contiguous()
    ):
        raise ValueError(
            f"lse must be a contiguous float32 [B, H, S] on q's device; got "
            f"{tuple(lse.shape)}, {lse.dtype} on {lse.device}"
        )
    scale = scale if scale is not None else D**-0.5
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    if B == 0 or S == 0 or T == 0:
        return dq.zero_(), dk.zero_(), dv.zero_()
    drow = torch.empty((B, H, S), dtype=torch.float32, device=q.device)
    err = _bwd_fn(q.dtype)(
        q.data_ptr(),
        k.data_ptr(),
        v.data_ptr(),
        out.data_ptr(),
        dout.data_ptr(),
        lse.data_ptr(),
        drow.data_ptr(),
        dq.data_ptr(),
        dk.data_ptr(),
        dv.data_ptr(),
        B,
        S,
        T,
        H,
        G,
        D,
        Dv,
        int(causal),
        int(window),
        float(scale),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"flash_attention_bwd kernel launch failed: cudaError_t {err}")
    LAUNCHES["flash_attention_bwd"] += 1
    return dq, dk, dv


def flash_attention_train(q, k, v, *, causal: bool = True, window: int = 0, scale=None):
    """Differentiable :func:`flash_attention`: the forward kernel with its
    log-sum-exp, the backward kernel under autograd."""
    return FlashAttentionFunction.apply(
        q, k, v, causal, window, scale, flash_attention_fwd, flash_attention_bwd
    )
