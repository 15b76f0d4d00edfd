"""Plain PyTorch version of the flash-attention forward.

The contract shared with the CUDA kernel (``csrc/flash_attention.cu``): for
``q [B, S, H, D]`` and ``k/v [B, T, G, D]`` (GQA: query head ``h`` reads KV
group ``h // (H // G)``), row ``i`` attends to keys ``j < T`` with ``j <= i``
where causal and ``i - j < window`` where ``window > 0``.  Softmax in float32;
a row with no key gets 0.  There is no padding: keys past ``T`` do not exist,
so they cannot leak in (the fault of the reference's ``ops.py`` recorded in
ROADMAP Queue 3 is not carried over).
"""

from __future__ import annotations

import torch

NEG_INF = -1e9


def attention_mask(S: int, T: int, *, causal: bool, window: int, device=None) -> torch.Tensor:
    """``[S, T]`` bool, True where row ``i`` may attend to key ``j``."""
    i = torch.arange(S, device=device)[:, None]
    j = torch.arange(T, device=device)[None, :]
    ok = torch.ones((S, T), dtype=torch.bool, device=device)
    if causal:
        ok &= j <= i
    if window:
        ok &= (i - j) < window
    return ok


def flash_attention_ref(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: int = 0,
    scale=None,
) -> torch.Tensor:
    """q ``[B, S, H, D]``, k/v ``[B, T, G, D]`` -> ``[B, S, H, D]`` in q's dtype."""
    B, S, H, D = q.shape
    T, G = k.shape[1], k.shape[2]
    scale = scale if scale is not None else D**-0.5
    qg = q.reshape(B, S, G, H // G, D).float()
    s = torch.einsum("bsgmd,btgd->bgmst", qg, k.float()) * scale
    ok = attention_mask(S, T, causal=causal, window=window, device=q.device)
    p = torch.softmax(s.masked_fill(~ok, NEG_INF), dim=-1) * ok
    out = torch.einsum("bgmst,btgd->bsgmd", p, v.float())
    return out.reshape(B, S, H, D).to(q.dtype)
