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
so every ``exp`` argument the result keeps is ``<= 0``; the intra-chunk
segment sums above the diagonal, which the result drops, are set to
``-inf`` before the exponent, where the reference exponentiates them (they
are positive and overflow float32 once a chunk's decay passes ~88): the
values are the same, and the gradients stay finite where the reference's
turn NaN.  Under autograd (training, ``cache=None``) every piece is
differentiable as it stands.  The state is
float32, the conv window in the cache's dtype (bf16), as the reference's
``init_ssm_cache``.

The reference's ``ssd_chunked`` asserts ``S % chunk == 0`` with ``chunk =
min(ssm_chunk, S)``: a prompt longer than a chunk must be a whole number of
chunks.  The port keeps that contract and raises ``ValueError`` where the
reference asserts; it does not pad, which would serve prompts the
reference's engine refuses.

In a sharded step (DTensor inputs) the mixer runs split over its heads on
the mesh's ``model`` dim where that dim divides them (``heads_split``,
``SSMBlock._mix_heads``: each rank holds its heads' blocks of the weights
and of the state, as the reference's rules lay them out), and per batch
row with the weights gathered where it does not (``SSMBlock._mix_rows``,
where the rules keep the weights whole).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import ParamSpec, rmsnorm
from repro_torch.models.sharding_hooks import on_batch_rows, replicated, whole_sequence_grad


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
    """The recurrent state of a stack of SSM layers: ``ssm [*layers, B, h,
    p, n]`` float32 and the conv window ``conv [*layers, B, W - 1,
    conv_dim]`` (the raw x, B and C of the last ``W - 1`` tokens), as the
    reference's cache.  ``layers`` is ``(L,)`` for a uniform stack and
    ``(nb, attn_layer_period - 1)`` for a hybrid one, whose SSM leaves carry
    batch on axis 2 (the reference's hybrid cache)."""

    ssm: torch.Tensor
    conv: torch.Tensor

    def slot(self, b: int) -> "SSMCache":
        """Slot ``b``'s state as a ``B = 1`` view (writes go through)."""
        return SSMCache(self.ssm[..., b : b + 1, :, :, :], self.conv[..., b : b + 1, :, :])

    def layer(self, *idx: int) -> "SSMCache":
        """One layer's state (``[B, ...]`` views) at ``idx`` among the layers."""
        return SSMCache(self.ssm[idx], self.conv[idx])

    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size() for t in (self.ssm, self.conv))


def init_ssm_cache(
    cfg: ModelConfig, num_layers, batch: int, *, device=None, conv_dtype=torch.bfloat16
) -> SSMCache:
    """A zero state of ``batch`` sequences; ``num_layers`` is the number of
    layers or a tuple of the leading layer dims (a hybrid stack's ``(nb,
    attn_layer_period - 1)``)."""
    h, ph, n = cfg.ssm_num_heads, cfg.ssm_head_dim, cfg.ssm_state_dim
    lead = tuple(num_layers) if isinstance(num_layers, tuple) else (num_layers,)
    return SSMCache(
        torch.zeros((*lead, batch, h, ph, n), dtype=torch.float32, device=device),
        torch.zeros(
            (*lead, batch, cfg.ssm_conv_width - 1, cfg.ssm_conv_dim),
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
        # -inf above the diagonal before the exponent: there seg > 0 and
        # exp(seg) overflows once a chunk's decay passes ~88, and the where's
        # backward would carry 0 * inf = NaN into the kept cells' gradients
        seg = seg.masked_fill(~mask, -math.inf)
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


def heads_split(cfg: ModelConfig, mesh) -> bool:
    """Whether a sharded step runs the mixer split over its heads on
    ``mesh``'s ``model`` dim (``SSMBlock._mix_heads``): where that dim
    divides the heads, as the reference's rules split the weights there."""
    names = mesh.mesh_dim_names
    return "model" in names and cfg.ssm_num_heads % mesh.size(names.index("model")) == 0


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
        if not isinstance(u, DTensor):
            return self._mix(u, cache, decode, self._parameters)
        if heads_split(self.cfg, u.device_mesh):
            return self._mix_heads(u, cache, decode)
        return self._mix_rows(u, cache, decode)

    def _mix_rows(self, u, cache: Optional[SSMCache], decode: bool):
        """The mixer on DTensors where ``model`` does not divide the heads
        (the rules keep the weights whole there, as the reference's
        ``spec_for_param``): each rank's code on its batch rows, each row's
        sequence whole and the weights gathered (SSD has no DTensor
        strategy; rows are independent); a cache's new state comes back
        laid out as the cache's own."""
        p = dict(self._parameters)
        if cache is None:
            y = on_batch_rows(lambda u, p: self._mix(u, None, decode, p), (u,), (p,))
            return whole_sequence_grad(y)

        def rows(u, ssm, conv, p):
            c = SSMCache(ssm.clone(), conv.clone())
            return self._mix(u, c, decode, p), c.ssm, c.conv

        y, ssm, conv = on_batch_rows(rows, (u, cache.ssm, cache.conv), (p,), ("rows",) * 3)
        cache.ssm.copy_(ssm)
        cache.conv.copy_(conv)
        return whole_sequence_grad(y)

    def _mix_heads(self, u, cache: Optional[SSMCache], decode: bool):
        """The mixer split over its heads on ``model``, as the reference's
        layout splits it: each rank's code (``distributed.comm``'s
        collectives) on its batch rows (the split the data-parallel mesh
        dims give ``u``'s dim 0) and its ``h / tp`` heads.

        ``u`` is taken whole over ``model`` (gathered from sequence
        parallelism, as the attention's input is).  ``w_z``, ``w_x``,
        ``conv_x``, ``w_dt`` are the rank's column blocks, ``A_log``, ``D``,
        ``dt_bias`` and ``norm`` its heads' and channels', ``out_proj`` its
        row block; ``w_B``, ``w_C``, ``conv_B``, ``conv_C`` stay whole (one
        group: every head reads the same B and C).  Under FSDP the weights'
        ``data`` blocks are gathered, as every other layer's; nothing of a
        weight moves over ``model``.  The gated norm averages over all of
        ``d_inner``: each rank's float32 sum of squares (``[B, S, 1]``) is
        all-reduced over ``model``.  ``out_proj``'s product, a partial sum
        over ``model``, is reduce-scattered along the sequence where ``u``
        came split by it (sequence parallelism), else all-reduced.

        Gradients: ``u``'s and the whole weights' come back ``Partial`` over
        ``model`` (each rank backpropagates its own heads' share), every
        weight's ``Partial`` over the mesh dims that split the batch; the
        norm's sum carries the sum of the ranks' gradients back
        (``comm.vary``).

        A cache's state ``ssm [B, h, p, n]`` stays on the rank's heads: it
        is read and written where it lies.  Its conv window ``conv [B, W -
        1, d_inner + 2 g n]`` is split over its concatenated channels on
        ``model`` (the reference's layout), which do not align with the
        rank's ``x`` channels beside whole B and C: a decode step gathers
        the window over ``model`` (``B_l (W - 1) C`` elements a rank) and
        the new row's ``x`` (``B_l d_inner``), a prefill the last ``W - 1``
        rows of its ``x`` (``B_l (W - 1) d_inner``), and each rank writes
        back its own channels of the new window.  In bf16 at mamba2-1.3b's
        widths (C 4352, d_inner 4096) and 8 rows a rank (decode_32k on the
        (16, 16) mesh), that is 209 KB and 66 KB a layer and decode step on
        the ring model, and 197 KB a layer at prefill."""
        from torch.distributed.tensor import Partial, Replicate, Shard

        from repro_torch.distributed import comm

        cfg = self.cfg
        if cfg.ssm_num_groups != 1:
            raise ValueError(
                f"the SSD split over its heads takes one group of B and C; got "
                f"ssm_num_groups = {cfg.ssm_num_groups}: a rank's heads would need their "
                "own groups' B and C"
            )
        mesh = u.device_mesh
        mi = mesh.mesh_dim_names.index("model")
        group = mesh.get_group(mi)

        def at_model(pl, p) -> tuple:
            return (*pl[:mi], p, *pl[mi + 1 :])

        rows = tuple(
            Shard(0) if i != mi and p.is_shard(0) else Replicate()
            for i, p in enumerate(u.placements)
        )
        batch_grad = tuple(Partial() if p.is_shard() else Replicate() for p in rows)
        sp = u.placements[mi].is_shard(1)

        def local(t, want, grad):
            return replicated(mesh, t).redistribute(mesh, want).to_local(grad_placements=grad)

        u_l = local(u, at_model(rows, Replicate()), at_model(rows, Partial()))
        p = {}
        for name, spec in ssm_specs(cfg).items():
            dim = next((i for i, a in enumerate(spec.axes) if a in ("mlp", "heads")), None)
            split = Replicate() if dim is None else Shard(dim)
            want = at_model((Replicate(),) * mesh.ndim, split)
            grad = at_model(batch_grad, Partial() if dim is None else split)
            p[name] = local(self._parameters[name], want, grad)

        c = None
        if cache is not None:
            di, di_l = cfg.d_inner, p["w_x"].shape[-1]
            state_pl = at_model(rows, Shard(1))
            whole_pl = at_model(rows, Replicate())
            ssm = cache.ssm.redistribute(mesh, state_pl).to_local().clone()
            if decode:
                win = cache.conv.redistribute(mesh, whole_pl).to_local()
                x0 = mesh.get_local_rank(mi) * di_l
                conv = torch.cat([win[..., x0 : x0 + di_l], win[..., di:]], dim=-1)
            else:  # a prefill reads no window
                win = None
                shape = (u_l.shape[0], cfg.ssm_conv_width - 1, di_l + cfg.ssm_conv_dim - di)
                conv = u_l.new_empty(shape, dtype=cache.conv.dtype)
            c = SSMCache(ssm, conv)
        y = self._mix(u_l, c, decode, p, norm_group=group)
        if c is not None:
            fresh = c.conv[:, -1:] if decode else c.conv
            x_new = comm.all_gather(fresh[..., :di_l], 2, group, varying=False)
            fresh = torch.cat([x_new, fresh[..., di_l:]], dim=-1)
            conv = fresh if win is None else torch.cat([win[:, 1:], fresh], dim=1)
            cache.ssm.copy_(DTensor.from_local(c.ssm, mesh, state_pl, run_check=False))
            cache.conv.copy_(DTensor.from_local(conv, mesh, whole_pl, run_check=False))
        y = comm.reduce_scatter(y, 1, group) if sp else comm.all_reduce(y, group)
        out_pl = at_model(rows, Shard(1) if sp else Replicate())
        return DTensor.from_local(y, mesh, out_pl, run_check=False)

    def _mix(
        self, u, cache: Optional[SSMCache], decode: bool, p, norm_group=None
    ) -> torch.Tensor:
        """The mixer on plain tensors, ``p`` its parameters by name: all the
        heads, or (``norm_group``, ``_mix_heads``) a rank's heads, whose
        gated norm sums its squares over the group's ranks; the heads and
        ``d_inner`` are those of ``p``'s blocks, a cache's conv window
        holds their ``x`` channels beside B and C."""
        cfg = self.cfg
        Bsz, S, _ = u.shape
        ph, n, g = cfg.ssm_head_dim, cfg.ssm_state_dim, cfg.ssm_num_groups
        h, di, W = p["w_dt"].shape[-1], p["w_x"].shape[-1], cfg.ssm_conv_width
        dtype, f32 = u.dtype, torch.float32
        z = u @ p["w_z"].to(dtype)
        xr = u @ p["w_x"].to(dtype)
        Br = u @ p["w_B"].to(dtype)
        Cr = u @ p["w_C"].to(dtype)
        dt_raw = u @ p["w_dt"].to(dtype)

        if not decode:
            if cache is not None:
                tail = torch.cat([xr, Br, Cr], dim=-1)[:, -(W - 1) :]
                if S < W - 1:  # short prompt: left-pad the rolling window
                    tail = F.pad(tail, (0, 0, W - 1 - S, 0))
            xr = _causal_conv(xr, p["conv_x"].to(dtype))
            Br = _causal_conv(Br, p["conv_B"].to(dtype))
            Cr = _causal_conv(Cr, p["conv_C"].to(dtype))
        else:
            if S != 1:
                raise ValueError(f"the recurrent step takes one token a sequence; got S = {S}")
            win = torch.cat([cache.conv.to(dtype), torch.cat([xr, Br, Cr], dim=-1)], dim=1)
            w_all = torch.cat([p["conv_x"], p["conv_B"], p["conv_C"]], dim=-1).to(dtype)
            conv = torch.einsum("bwc,wc->bc", win.float(), w_all.float()).to(dtype)[:, None]
            xr, Br, Cr = conv[..., :di], conv[..., di : di + g * n], conv[..., di + g * n :]
            cache.conv.copy_(win[:, 1:])

        xr, Br, Cr = F.silu(xr), F.silu(Br), F.silu(Cr)
        xh = xr.reshape(Bsz, S, h, ph)
        Bh = Br.reshape(Bsz, S, g, n)
        Ch = Cr.reshape(Bsz, S, g, n)
        dt = F.softplus(dt_raw.float() + p["dt_bias"].float())
        A = -torch.exp(p["A_log"].float())  # [h], negative
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

        y = y + p["D"].to(dtype)[:, None] * xh
        y = y.reshape(Bsz, S, di)
        y = y * F.silu(z)
        if norm_group is None:
            y = rmsnorm(y, p["norm"], cfg.norm_eps)
        else:
            y = _rmsnorm_split(y, p["norm"], cfg.norm_eps, cfg.d_inner, norm_group)
        return y @ p["out_proj"].to(dtype)


def _rmsnorm_split(x, scale, eps: float, width: int, group) -> torch.Tensor:
    """``layers.rmsnorm`` over a feature dim of ``width`` split over
    ``group``'s ranks, ``x`` and ``scale`` the rank's block of it: the
    float32 sums of squares all-reduced (their gradient summed over the
    group, where each rank normalises its own block), divided by the whole
    width."""
    from repro_torch.distributed import comm

    dt = x.dtype
    x = x.float()
    ss = comm.vary(comm.all_reduce(x.square().sum(-1, keepdim=True), group), group)
    return (x * torch.rsqrt(ss / width + eps) * scale.float()).to(dt)
