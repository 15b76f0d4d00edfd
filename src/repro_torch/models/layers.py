"""Foundation layers and the ParamSpec system of the port.

Parameters are described declaratively, as in the reference: ``param_specs``
(``models/model.py``) returns a nested dict of :class:`ParamSpec`, with the
layer stack's leaves stacked ``[L, ...]`` as the reference stacks them, and
``init_leaf`` draws each leaf.  Each leaf draws from its own
``torch.Generator``, seeded from a stable digest of the seed and the leaf's
path, so a leaf's values do not depend on the order of the tree or on the
process.  (The reference folds Python's salted ``hash`` of the path into its
key, so its weights differ between processes; parity with it goes through
``repro_torch.interop``.)
"""

from __future__ import annotations

import math
import zlib
from dataclasses import dataclass
from typing import Optional, Tuple

import torch


@dataclass(frozen=True)
class ParamSpec:
    shape: Tuple[int, ...]
    axes: Tuple[Optional[str], ...]  # logical axis name per dim, as in the reference
    init: str = "normal"  # normal | zeros | ones | fan_in
    stddev: float = 0.02

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(f"shape {self.shape} and axes {self.axes} differ in rank")

    def stacked(self, n: int) -> "ParamSpec":
        return ParamSpec((n, *self.shape), (None, *self.axes), self.init, self.stddev)


def keystr(keys) -> str:
    """A leaf's path as the reference's ``keystr`` writes it (``['layers']['attn']['wq']``)."""
    return "".join(f"['{k}']" for k in keys)


def leaf_seed(seed: int, keys) -> int:
    return zlib.crc32(f"{seed}:{keystr(keys)}".encode())


def init_leaf(spec: ParamSpec, seed: int, device) -> torch.Tensor:
    """One float32 leaf on ``device``: the reference's init rules (``fan_in``
    reads the second-to-last dim, as the reference's does)."""
    if spec.init == "zeros":
        return torch.zeros(spec.shape, device=device)
    if spec.init == "ones":
        return torch.ones(spec.shape, device=device)
    gen = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn(spec.shape, generator=gen, device=device)
    if spec.init == "fan_in":
        fan_in = spec.shape[-2] if len(spec.shape) >= 2 else spec.shape[-1]
        return x.mul_(1.0 / math.sqrt(fan_in))
    return x.mul_(spec.stddev)


def iter_specs(specs, prefix=()):
    """``(keys, ParamSpec)`` for every leaf of a nested spec dict."""
    for key, val in specs.items():
        keys = (*prefix, key)
        if isinstance(val, ParamSpec):
            yield keys, val
        else:
            yield from iter_specs(val, keys)


# ---------------------------------------------------------------------------
# Norms (computed in float32, returned in the input's dtype)
# ---------------------------------------------------------------------------


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    var = x.square().mean(-1, keepdim=True)
    return (x * torch.rsqrt(var + eps) * scale.float()).to(dt)


def layernorm(
    x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, eps: float = 1e-5
) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    mu = x.mean(-1, keepdim=True)
    var = (x - mu).square().mean(-1, keepdim=True)
    y = (x - mu) * torch.rsqrt(var + eps)
    return (y * scale.float() + bias.float()).to(dt)


def norm_spec(cfg, d: int) -> dict:
    spec = {"scale": ParamSpec((d,), (None,), init="ones")}
    if cfg.norm_type == "layernorm":
        spec["bias"] = ParamSpec((d,), (None,), init="zeros")
    return spec


class Norm(torch.nn.Module):
    """LayerNorm or RMSNorm as the config names it; scale and bias stay
    float32 whatever the compute dtype, as the reference reads them."""

    def __init__(self, cfg, d: int):
        super().__init__()
        self.eps = cfg.norm_eps
        self.scale = torch.nn.Parameter(torch.ones(d), requires_grad=False)
        self.bias = None
        if cfg.norm_type == "layernorm":
            self.bias = torch.nn.Parameter(torch.zeros(d), requires_grad=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.bias is None:
            return rmsnorm(x, self.scale, self.eps)
        return layernorm(x, self.scale, self.bias, self.eps)


# ---------------------------------------------------------------------------
# Rotary embeddings (half-split llama convention, partial-rotary capable)
# ---------------------------------------------------------------------------


def rope_frequencies(rot_dim: int, theta: float, device=None) -> torch.Tensor:
    exps = torch.arange(0, rot_dim, 2, dtype=torch.float32, device=device) / rot_dim
    return 1.0 / (theta**exps)


def apply_rope(
    x: torch.Tensor, positions: torch.Tensor, *, theta: float = 10_000.0, fraction: float = 1.0
) -> torch.Tensor:
    """x: ``[..., seq, heads, head_dim]``; positions: ``[..., seq]`` (int).
    Rotates the first ``fraction`` of each head's dims, in float32."""
    head_dim = x.shape[-1]
    rot_dim = int(head_dim * fraction) // 2 * 2
    if rot_dim == 0:
        return x
    freqs = rope_frequencies(rot_dim, theta, x.device)
    angles = (positions.float()[..., None] * freqs)[..., None, :]  # [..., s, 1, rot/2]
    sin, cos = torch.sin(angles), torch.cos(angles)
    xr, xp = x[..., :rot_dim], x[..., rot_dim:]
    x1, x2 = xr.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return torch.cat([out.to(x.dtype), xp], dim=-1)
