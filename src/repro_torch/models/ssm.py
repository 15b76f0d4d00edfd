"""Mamba2 (SSD, state-space duality) mixer block: the reference's
``models/ssm.py``.  [arXiv:2405.21060]

Prefill uses the chunked dual form: quadratic within a chunk (matrix
products), linear state passing between chunks (a Python loop over the
chunks, where the reference scans).  Decode is the O(1)-state recurrence.
The projections are separate matrices, as the reference keeps them
(``w_z``, ``w_x``, ``w_B``, ``w_C``, ``w_dt``), each in the compute dtype.

The reference computes SSD with ``jnp`` einsums outside any Pallas kernel,
so the port computes it with PyTorch matrix products (cuBLAS on the card):
there is no TPU kernel here to port.  Its einsums take bf16 operands with
``preferred_element_type=float32``; here the same operands (rounded to the
compute dtype where the reference rounds them) are multiplied in float32,
which is that contract.  All decay arithmetic is in log space: ``A < 0``,
so every ``exp`` argument the result keeps is ``<= 0``.  The state is
float32, the conv window in the cache's dtype (bf16), as the reference's
``init_ssm_cache``.

The reference's ``ssd_chunked`` asserts ``S % chunk == 0`` with ``chunk =
min(ssm_chunk, S)``: a prompt longer than a chunk must be a whole number of
chunks.  The port keeps that contract and raises ``ValueError`` where the
reference asserts; it does not pad, which would serve prompts the
reference's engine refuses.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import ParamSpec, rmsnorm


def ssm_specs(cfg: ModelConfig) -> dict:
    d, di = cfg.d_model, cfg.d_inner
    g, n, h, w = cfg.ssm_num_groups, cfg.ssm_state_dim, cfg.ssm_num_heads, cfg.ssm_conv_width
    return {
        "w_z": ParamSpec((d, di), ("embed", "mlp"), init="fan_in"),
        "w_x": ParamSpec((d, di), ("embed", "mlp"), init="fan_in"),
        "w_B": ParamSpec((d, g * n), ("embed", None), init="fan_in"),
        "w_C": ParamSpec((d, g * n), ("embed", None), init="fan_in"),
        "w_dt": ParamSpec((d, h), ("embed", "heads"), init="fan_in"),
        "conv_x": ParamSpec((w, di), (None, "mlp"), init="fan_in"),
        "conv_B": ParamSpec((w, g * n), (None, None), init="fan_in"),
        "conv_C": ParamSpec((w, g * n), (None, None), init="fan_in"),
        "A_log": ParamSpec((h,), ("heads",), init="zeros"),  # A = -1 (the reference's const 0)
        "D": ParamSpec((h,), ("heads",), init="ones"),
        "dt_bias": ParamSpec((h,), ("heads",), init="zeros"),
        "norm": ParamSpec((di,), ("mlp",), init="ones"),
        "out_proj": ParamSpec((di, d), ("mlp", "embed"), init="fan_in"),
    }


@dataclass
class SSMCache:
    """The recurrent state of a stack of SSM layers: ``ssm [L, B, h, p, n]``
    float32 and the conv window ``conv [L, B, W - 1, conv_dim]`` (the raw x,
    B and C of the last ``W - 1`` tokens), as the reference's cache."""

    ssm: torch.Tensor
    conv: torch.Tensor

    def slot(self, b: int) -> "SSMCache":
        """Slot ``b``'s state as a ``B = 1`` view (writes go through)."""
        return SSMCache(self.ssm[:, b : b + 1], self.conv[:, b : b + 1])

    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size() for t in (self.ssm, self.conv))


def init_ssm_cache(
    cfg: ModelConfig, num_layers: int, batch: int, *, device=None, conv_dtype=torch.bfloat16
) -> SSMCache:
    h, ph, n = cfg.ssm_num_heads, cfg.ssm_head_dim, cfg.ssm_state_dim
    return SSMCache(
        torch.zeros((num_layers, batch, h, ph, n), dtype=torch.float32, device=device),
        torch.zeros(
            (num_layers, batch, cfg.ssm_conv_width - 1, cfg.ssm_conv_dim),
            dtype=conv_dtype,
            device=device,
        ),
    )


def _causal_conv(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv1d: x ``[B, S, C]``, w ``[W, C]`` -> ``[B, S, C]``,
    tap by tap in the reference's order."""
    W, S = w.shape[0], x.shape[1]
    xp = F.pad(x, (0, 0, W - 1, 0))
    out = torch.zeros_like(x)
    for i in range(W):
        out = out + xp[:, i : i + S] * w[i]
    return out


def ssd_chunked(
    x: torch.Tensor,
    a_log: torch.Tensor,
    B: torch.Tensor,
    C: torch.Tensor,
    chunk: int,
    initial_state: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """SSD dual form, group-aware (the reference's ``ssd_chunked``).

    x ``[b, s, h, p]`` (already times dt), a_log ``[b, s, h]`` float32 (dt A,
    all <= 0), B and C ``[b, s, g, n]`` at group granularity.  Returns
    ``(y [b, s, h, p]`` in x's dtype, ``final_state [b, h, p, n]`` float32).
    Heads are viewed as ``(g, m = h / g)``."""
    b, s, h, p = x.shape
    g, n = B.shape[-2:]
    m = h // g
    if chunk <= 0 or s % chunk:
        raise ValueError(
            f"ssd_chunked takes a whole number of chunks: S = {s}, chunk = {chunk} (the "
            "reference asserts S % chunk == 0)"
        )
    dt, f32 = x.dtype, torch.float32
    xs = x.reshape(b, s, g, m, p)
    al = a_log.reshape(b, s, g, m).float()
    S_prev = (
        torch.zeros((b, h, p, n), dtype=f32, device=x.device)
        if initial_state is None
        else initial_state.float()
    ).reshape(b, g, m, p, n)
    mask = torch.ones(chunk, chunk, dtype=torch.bool, device=x.device).tril()
    ys = []
    for c0 in range(0, s, chunk):
        xc = xs[:, c0 : c0 + chunk].float()  # operands in x's dtype, products in float32
        Bc = B[:, c0 : c0 + chunk].float()
        Cc = C[:, c0 : c0 + chunk].float()
        la = torch.cumsum(al[:, c0 : c0 + chunk], dim=1)  # [b, l, g, m]
        la_last = la[:, -1:]
        Gm = torch.einsum("blgn,bkgn->bglk", Cc, Bc)
        lah = la.permute(0, 2, 3, 1)  # [b, g, m, l]
        seg = lah[..., :, None] - lah[..., None, :]  # [b, g, m, l, k]
        M = torch.where(mask, Gm[:, :, None] * torch.exp(seg), 0.0)
        y_intra = torch.einsum("bgmlk,bkgmp->blgmp", M.to(dt).float(), xc)
        y_inter = torch.einsum(
            "blgm,blgn,bgmpn->blgmp", torch.exp(la).to(dt).float(), Cc, S_prev.to(dt).float()
        )
        decay_to_end = torch.exp(la_last - la)
        S_c = torch.einsum("blgm,blgn,blgmp->bgmpn", decay_to_end.to(dt).float(), Bc, xc)
        S_prev = S_prev * torch.exp(la_last[:, 0])[..., None, None] + S_c
        ys.append((y_intra + y_inter).to(dt))
    y = torch.cat(ys, dim=1).reshape(b, s, h, p)
    return y, S_prev.reshape(b, h, p, n)


class SSMBlock(torch.nn.Module):
    """The mamba2 mixer (the reference's ``ssm_block``): weight matrices and
    conv taps in the compute dtype, ``A_log``, ``D``, ``dt_bias`` and the
    gated norm's scale float32, as the reference's init keeps them."""

    def __init__(self, cfg: ModelConfig, dtype: torch.dtype):
        super().__init__()
        self.cfg = cfg
        for name, spec in ssm_specs(cfg).items():
            dt = dtype if len(spec.shape) > 1 else torch.float32
            self.register_parameter(
                name, torch.nn.Parameter(torch.empty(spec.shape, dtype=dt), requires_grad=False)
            )

    def forward(
        self, u: torch.Tensor, cache: Optional[SSMCache] = None, *, decode: bool = False
    ) -> torch.Tensor:
        """u ``[B, S, d]``.  ``cache=None``: the training form (no state);
        a cache (one layer's ``ssm [B, h, p, n]`` and ``conv [B, W - 1, C]``)
        with ``decode=False``: prefill from its state, writing the final
        state and the conv tail into it; with ``decode=True``: the O(1)
        recurrent step (S = 1), updating it in place."""
        cfg = self.cfg
        Bsz, S, _ = u.shape
        h, ph, n, g = cfg.ssm_num_heads, cfg.ssm_head_dim, cfg.ssm_state_dim, cfg.ssm_num_groups
        di, W = cfg.d_inner, cfg.ssm_conv_width
        dtype, f32 = u.dtype, torch.float32
        z = u @ self.w_z.to(dtype)
        xr = u @ self.w_x.to(dtype)
        Br = u @ self.w_B.to(dtype)
        Cr = u @ self.w_C.to(dtype)
        dt_raw = u @ self.w_dt.to(dtype)

        if not decode:
            if cache is not None:
                tail = torch.cat([xr, Br, Cr], dim=-1)[:, -(W - 1) :]
                if S < W - 1:  # short prompt: left-pad the rolling window
                    tail = F.pad(tail, (0, 0, W - 1 - S, 0))
            xr = _causal_conv(xr, self.conv_x.to(dtype))
            Br = _causal_conv(Br, self.conv_B.to(dtype))
            Cr = _causal_conv(Cr, self.conv_C.to(dtype))
        else:
            if S != 1:
                raise ValueError(f"the recurrent step takes one token a sequence; got S = {S}")
            win = torch.cat([cache.conv.to(dtype), torch.cat([xr, Br, Cr], dim=-1)], dim=1)
            w_all = torch.cat([self.conv_x, self.conv_B, self.conv_C], dim=-1).to(dtype)
            conv = torch.einsum("bwc,wc->bc", win.float(), w_all.float()).to(dtype)[:, None]
            xr, Br, Cr = conv[..., :di], conv[..., di : di + g * n], conv[..., di + g * n :]
            cache.conv.copy_(win[:, 1:])

        xr, Br, Cr = F.silu(xr), F.silu(Br), F.silu(Cr)
        xh = xr.reshape(Bsz, S, h, ph)
        Bh = Br.reshape(Bsz, S, g, n)
        Ch = Cr.reshape(Bsz, S, g, n)
        dt = F.softplus(dt_raw.float() + self.dt_bias.float())
        A = -torch.exp(self.A_log.float())  # [h], negative
        a_log = dt * A
        x_dt = xh * dt.to(dtype)[..., None]

        if not decode:
            init = None if cache is None else cache.ssm
            y, S_last = ssd_chunked(x_dt, a_log, Bh, Ch, min(cfg.ssm_chunk, S), init)
            if cache is not None:  # prefill: persist the state and the conv window
                cache.ssm.copy_(S_last)
                cache.conv.copy_(tail)
        else:  # S' = a S + B (x) x_dt; y = C . S'  (group-aware)
            m = h // g
            a = torch.exp(a_log[:, 0]).reshape(Bsz, g, m)
            x0 = x_dt[:, 0].to(f32).reshape(Bsz, g, m, ph)
            outer = torch.einsum("bgmp,bgn->bgmpn", x0, Bh[:, 0].to(f32))
            S_new = cache.ssm.reshape(Bsz, g, m, ph, n) * a[..., None, None] + outer
            y = torch.einsum("bgmpn,bgn->bgmp", S_new, Ch[:, 0].to(f32))[:, None].to(dtype)
            y = y.reshape(Bsz, S, h, ph)
            cache.ssm.copy_(S_new.reshape(Bsz, h, ph, n))

        y = y + self.D.to(dtype)[:, None] * xh
        y = y.reshape(Bsz, S, di)
        y = rmsnorm(y * F.silu(z), self.norm, cfg.norm_eps)
        return y @ self.out_proj.to(dtype)
