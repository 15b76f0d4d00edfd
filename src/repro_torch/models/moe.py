"""Mixture-of-Experts with banked capacity dispatch: the single-device path
of the reference's ``models/moe.py``.

Paper tie-in: the capacity buffer is a *shared memory with many masters*
(token groups).  Slot assignment applies ``core.address.fractal_permute`` so
capacity overflow drops are whitened across the sequence instead of
truncating the tail, the paper's §II-C fractal randomization as a
load-balancing policy; ``whiten=False`` recovers GShard tail-drop.

Groups are batch rows: each row routes its ``S`` tokens over the full
expert set into its own ``C`` slots per expert, and rows never share
capacity.  What the reference computes, and how the port keeps it:

  * top-k: ``jax.lax.top_k`` puts the lower expert index first among equal
    probabilities, so the port takes the first ``K`` of a stable descending
    sort (``torch.topk`` promises no order among ties).
  * slots: the reference's algebra step for step (stable argsort of the
    permuted expert ids, left ``searchsorted``, the two inverse
    permutations); ``slot == C`` marks a dropped (token, k).
  * dispatch: each kept (expert, slot) is written by exactly one (token, k),
    so the reference's sum of K scatters into a zero buffer is one indexed
    write; dropped pairs go to a spare row that nothing reads.
  * expert products: batched matmuls over experts with groups x capacity as
    one M axis, so each expert's weights are read once per call.
  * combine: the K weighted gathers are added in the reference's order and
    dtype (``top_w`` cast to the compute dtype, the sum rounded after each
    add); dropped pairs gather a zero row.

Under autograd (training) the same algebra is differentiable: gradients
flow through the softmax weights, the indexed dispatch (its backward gathers)
and the combine (its backward adds into each kept row once; only the spare
row takes several), while the slot algebra stays integer.  Serving and
training share the one path: the expert products return a fresh tensor and
the spare zero row is appended to it.

Expert parallelism (the reference's ``shard_map`` path) runs where a mesh
is registered: ``_expert_parallel``, each rank's code with explicit
collectives on DTensor blocks.  No Pallas kernel is on this path: the reference leaves routing
and the expert products to XLA, and the port to PyTorch.
"""

from __future__ import annotations

import functools
import math
from typing import Mapping, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.core.address import fractal_permute
from repro_torch.distributed.sharding import mesh_axes
from repro_torch.models.layers import ParamSpec
from repro_torch.models.sharding_hooks import (
    current_mesh,
    gather_sequence,
    on_batch_rows,
    whole_sequence_grad,
)


def moe_specs(cfg: ModelConfig) -> dict:
    d, e = cfg.d_model, cfg.moe_num_experts
    f = cfg.moe_d_ff or cfg.d_ff
    spec = {
        "router": ParamSpec((d, e), ("embed", None), init="fan_in"),
        "w_gate": ParamSpec((e, d, f), ("expert", "embed", "expert_mlp"), init="fan_in"),
        "w_up": ParamSpec((e, d, f), ("expert", "embed", "expert_mlp"), init="fan_in"),
        "w_down": ParamSpec((e, f, d), ("expert", "expert_mlp", "embed"), init="fan_in"),
    }
    if cfg.moe_num_shared:
        fs = cfg.moe_num_shared * f
        spec.update(
            {
                "ws_gate": ParamSpec((d, fs), ("embed", "mlp"), init="fan_in"),
                "ws_up": ParamSpec((d, fs), ("embed", "mlp"), init="fan_in"),
                "ws_down": ParamSpec((fs, d), ("mlp", "embed"), init="fan_in"),
            }
        )
    return spec


def expert_capacity(cfg: ModelConfig, tokens_per_group: int) -> int:
    c = math.ceil(cfg.moe_capacity_factor * cfg.moe_top_k * tokens_per_group / cfg.moe_num_experts)
    return max(8, -(-c // 8) * 8)  # round up to 8, as the reference tiles it


@functools.cache
def _fractal_perm(nk: int, device: torch.device) -> torch.Tensor:
    """``fractal_permute(nk, seed=1)`` on ``device``, made once per size: a
    decode step routes every layer at the same ``nk``."""
    return torch.from_numpy(fractal_permute(nk, seed=1).astype(np.int64)).to(device)


def route(cfg: ModelConfig, x: torch.Tensor, router: torch.Tensor, *, whiten: bool):
    """Routing and capacity slot assignment over the full expert set.
    x ``[B, S, d]``.  Returns ``(top_w [B, S, K] float32, top_e [B, S, K],
    slot [B, S, K], aux)``, ``slot == C`` where the pair is dropped."""
    B, S, _ = x.shape
    E, K = cfg.moe_num_experts, cfg.moe_top_k
    C = expert_capacity(cfg, S)
    logits = x @ router.to(x.dtype)
    probs = torch.softmax(logits.float(), dim=-1)
    top_w, top_e = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_w, top_e = top_w[..., :K], top_e[..., :K]
    top_w = top_w / top_w.sum(-1, keepdim=True).clamp_min(1e-9)

    # f_e: the share of each group's (token, k) picks per expert (the
    # reference's mean of one-hot rows), counted without a host read
    picks = top_e.reshape(B, S * K)
    f_e = probs.new_zeros(B, E).scatter_add_(1, picks, probs.new_ones(picks.shape)) / (S * K)
    p_e = probs.mean(dim=1)
    aux = E * (f_e * p_e).sum(-1).mean()

    NK = S * K
    e_perm = picks
    perm = _fractal_perm(NK, x.device) if whiten else None
    if whiten:
        e_perm = e_perm[:, perm]
    order = torch.argsort(e_perm, dim=-1, stable=True)
    e_sorted = torch.gather(e_perm, -1, order)
    experts = torch.arange(E, device=x.device).expand(B, E).contiguous()
    start = torch.searchsorted(e_sorted, experts)
    rank_sorted = torch.arange(NK, device=x.device) - torch.gather(start, -1, e_sorted)
    slot = torch.empty_like(rank_sorted).scatter_(-1, order, rank_sorted)
    if whiten:
        slot = torch.empty_like(slot).index_copy_(1, perm, slot)
    slot = slot.reshape(B, S, K).clamp_max(C)  # C == dropped
    return top_w, top_e, slot, aux


def expert_products(
    buf: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor, w_down: torch.Tensor
) -> torch.Tensor:
    """SwiGLU of every expert over its rows: buf ``[E, M, d]`` -> ``[E, M, d]``."""
    h = F.silu(torch.bmm(buf, w_gate)) * torch.bmm(buf, w_up)
    return torch.bmm(h, w_down)


def dispatch_compute_combine(
    cfg: ModelConfig, x, products, num_experts: int, top_w, top_e, slot, *, lo: int = 0
):
    """x ``[B, S, d_in]``; ``products`` maps the capacity rows ``[E, M,
    d_in]`` of ``num_experts`` experts to their outputs ``[E, M, d]`` in x's
    dtype (``expert_products`` with the weights).  Returns the experts'
    output ``[B, S, d]``.  Capacity rows are laid out ``[E, B, C]`` so that
    each expert's rows form one ``[B * C, d_in]`` block of the batched
    product.

    The experts may be a model rank's ``[lo, lo + num_experts)`` only: pairs
    routed elsewhere are dropped here (the expert-parallel path sums the
    ranks' outputs)."""
    B, S, d_in = x.shape
    E = num_experts
    C = expert_capacity(cfg, S)
    M = B * C
    n = E * M  # row n is the spare row: dropped pairs write it and gather zeros
    group = torch.arange(B, device=x.device)[:, None, None] * C
    e = top_e - lo
    keep = slot < C
    if lo or E != cfg.moe_num_experts:
        keep = keep & (e >= 0) & (e < E)
    row = torch.where(keep, e * M + group + slot, n)
    buf = x.new_zeros(n + 1, d_in)
    buf[row] = x[:, :, None, :]
    y = products(buf[:n].view(E, M, d_in))
    d = y.shape[-1]
    out_rows = torch.cat([y.reshape(n, d), y.new_zeros(1, d)])
    weighted = out_rows[row] * top_w.to(x.dtype)[..., None]
    out = weighted.new_zeros(B, S, d)
    for kk in range(cfg.moe_top_k):
        out = out + weighted[:, :, kk]
    return out


def shared_expert(p: Mapping[str, torch.Tensor], x: torch.Tensor) -> torch.Tensor:
    return (F.silu(x @ p["ws_gate"]) * (x @ p["ws_up"])) @ p["ws_down"]


def _expert_parallel(cfg: ModelConfig, p, x, mesh, *, whiten: bool):
    """The reference's ``shard_map`` expert parallelism over ``mesh``'s
    ``model`` axis, written as each rank's code with explicit collectives
    (``distributed.comm``): ``x`` and ``p``'s leaves are DTensors (plain
    tensors count as replicated), redistributed to the reference's
    ``in_specs`` and taken as the rank's blocks; the result is a DTensor
    laid out as the reference's ``out_specs``.

    Each ``model`` rank holds ``E / tp`` experts (``lo = rank * E_loc``).
    Under sequence parallelism the tokens are all-gathered over ``model``;
    every rank routes the full sequence (the router replicated, so the
    decisions agree) and computes its own experts; the outputs are summed by
    a reduce-scatter along the sequence (SP) or an all-reduce, and ``aux``
    is averaged over the mesh.  Under FSDP the experts' d_model dim is
    sharded over ``data``: with the batch sharded over the data-parallel
    axes the weights are all-gathered first; with batch-1 decode (batch not
    sharded) they keep their d-slice, each rank multiplies its slice of the
    tokens, and the gate and up products are summed over ``data`` and the
    down product's d is all-gathered (the partial-product mode: a small
    activation reduce in place of the weights' gather).  No all-to-all, as
    in the reference.

    Gradients: each input's block takes a ``Partial`` gradient over the
    mesh dims where it is replicated but the ranks compute different things
    from it (the ``model`` ranks route alike but each backpropagates its own
    experts' share, so their sum is the whole); in the partial mode the
    ``data`` ranks route and combine alike, so the routing's input gradient
    is scaled by their count before the sum."""
    from torch.distributed.tensor import DTensor, Partial, Replicate

    from repro_torch.distributed import comm
    from repro_torch.distributed.sharding import dp_axes, mesh_axes, placements
    from repro_torch.models.sharding_hooks import params_fsdp

    sizes = mesh_axes(mesh)
    E, tp = cfg.moe_num_experts, sizes["model"]
    B, S, d = x.shape
    E_loc = E // tp
    dp = dp_axes(mesh)
    dp_size = math.prod(sizes[a] for a in dp)
    bspec = dp if B % dp_size == 0 else None
    sp = "model" if (S % tp == 0 and S > 1) else None
    mlp_ax = "data" if (params_fsdp() and p["w_gate"].shape[1] % sizes["data"] == 0) else None
    partial_mode = mlp_ax is not None and bspec is None
    varying = {"model"} | (set(dp) if bspec else set())

    def local(t, spec, vary=()):
        if not isinstance(t, DTensor):
            t = DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim, run_check=False)
        want = placements(spec, mesh)
        grad = [
            Partial() if (pl.is_replicate() and name in vary) else pl
            for name, pl in zip(mesh.mesh_dim_names, want)
        ]
        return t.redistribute(mesh, want).to_local(grad_placements=grad)

    model = mesh.get_group("model")
    x_vary = ({"model"} if sp is None else set()) | ({mlp_ax} if partial_mode else set())
    x_l = local(x, (bspec, sp, None), x_vary)
    router = local(p["router"], (None, None), varying)
    w_vary = set(dp) - {mlp_ax} if bspec else set()
    wg = local(p["w_gate"], ("model", mlp_ax, None), w_vary)
    wu = local(p["w_up"], ("model", mlp_ax, None), w_vary)
    wd = local(p["w_down"], ("model", None, mlp_ax), w_vary)

    x_full = comm.all_gather(x_l, 1, model) if sp is not None else x_l
    # in the partial mode the data ranks route alike and combine alike
    x_route = comm.scale_grad(x_full, 1 / sizes[mlp_ax]) if partial_mode else x_full
    top_w, top_e, slot, aux = route(cfg, x_route, router, whiten=whiten)
    lo = mesh.get_local_rank("model") * E_loc
    x_in = x_full
    if partial_mode:
        data = mesh.get_group(mlp_ax)
        d_loc = wg.shape[1]
        di = mesh.get_local_rank(mlp_ax)
        x_in = x_full[..., di * d_loc : (di + 1) * d_loc]

        def products(rows):
            """The rank's d-slice of the rows against the weights' d-slices:
            the gate and up products summed over ``data``, their SwiGLU
            entering each rank's own d-slice of the down product, whose d
            is gathered back."""
            g = comm.all_reduce(torch.bmm(rows, wg), data)
            u = comm.all_reduce(torch.bmm(rows, wu), data)
            h = comm.vary(F.silu(g) * u, data)
            return comm.all_gather(torch.bmm(h, wd), 2, data, varying=False)

    else:
        if mlp_ax is not None:  # FSDP (ZeRO-3) gather of the d_model dim
            data = mesh.get_group(mlp_ax)
            wg, wu = comm.all_gather(wg, 1, data), comm.all_gather(wu, 1, data)
            wd = comm.all_gather(wd, 2, data)
        products = functools.partial(expert_products, w_gate=wg, w_up=wu, w_down=wd)
    out = dispatch_compute_combine(cfg, x_in, products, E_loc, top_w, top_e, slot, lo=lo)
    out = comm.reduce_scatter(out, 1, model) if sp is not None else comm.all_reduce(out, model)
    for a in sorted(varying, key=mesh.mesh_dim_names.index):
        aux = comm.all_reduce(aux, mesh.get_group(a))
    aux = aux / math.prod(sizes[a] for a in varying)
    out = DTensor.from_local(out, mesh, placements((bspec, sp, None), mesh), run_check=False)
    aux = DTensor.from_local(aux, mesh, [Replicate()] * mesh.ndim, run_check=False)
    return out, aux


def moe_ffn(
    cfg: ModelConfig, p: Mapping[str, torch.Tensor], x: torch.Tensor, *, whiten: bool = True
) -> Tuple[torch.Tensor, torch.Tensor]:
    """x ``[B, S, d]`` -> ``(out, aux)``, aux float32.  Groups = batch rows.
    ``p`` holds ``moe_specs``' leaves in x's dtype.

    With a mesh registered (``models.sharding_hooks``) whose ``model`` axis
    divides E: the expert-parallel path (``_expert_parallel``) on DTensors
    (plain tensors count as replicated and come back whole: every rank gets
    the full output).  Otherwise the single-device path, with the same
    semantics."""
    mesh = current_mesh()
    E = cfg.moe_num_experts
    if mesh is not None and "model" in mesh.mesh_dim_names:
        if E % mesh_axes(mesh)["model"] == 0:
            from torch.distributed.tensor import DTensor

            out, aux = _expert_parallel(cfg, p, x, mesh, whiten=whiten)
            if not isinstance(x, DTensor):
                out, aux = out.full_tensor(), aux.full_tensor()
            if cfg.moe_num_shared:  # each row's sequence whole, as the router's
                out = out + whole_sequence_grad(shared_expert(p, gather_sequence(x)))
            return out, aux.float()
    # groups are batch rows: on DTensors (a mesh whose ``model`` axis does
    # not divide E) each rank routes its own rows over every expert, each
    # row's sequence whole (gathered from sequence parallelism)
    out, aux = on_batch_rows(
        functools.partial(_moe_local, cfg, whiten=whiten), (x,), (dict(p),), ("rows", "mean")
    )
    return whole_sequence_grad(out), aux.float()


def _moe_local(cfg: ModelConfig, x, p, *, whiten: bool):
    """The single-device path on plain tensors: ``(out, aux)``."""
    top_w, top_e, slot, aux = route(cfg, x, p["router"], whiten=whiten)
    products = functools.partial(
        expert_products, w_gate=p["w_gate"], w_up=p["w_up"], w_down=p["w_down"]
    )
    out = dispatch_compute_combine(cfg, x, products, cfg.moe_num_experts, top_w, top_e, slot)
    if cfg.moe_num_shared:
        out = out + shared_expert(p, x)
    return out, aux


class MoE(torch.nn.Module):
    """The MoE FFN of one layer; a serving model stores its weights in the
    compute dtype (the reference casts them per einsum), a training model in
    float32, cast at each use.  Serving drops ``aux``; training adds it to
    the loss (``forward_aux``)."""

    def __init__(self, cfg: ModelConfig, dtype: torch.dtype):
        super().__init__()
        self.cfg = cfg
        for name, spec in moe_specs(cfg).items():
            self.register_parameter(
                name, torch.nn.Parameter(torch.empty(spec.shape, dtype=dtype), requires_grad=False)
            )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.forward_aux(x)[0]

    def forward_aux(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """``(out, aux)``: the layer's output and its float32 load-balancing loss."""
        return moe_ffn(self.cfg, {k: v.to(x.dtype) for k, v in self._parameters.items()}, x)
