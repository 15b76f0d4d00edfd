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

The reference's ``shard_map`` expert-parallel path is not ported yet
(ROADMAP).  No Pallas kernel is on this path: the reference leaves routing
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
from repro_torch.models.layers import ParamSpec


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
    buf: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor, w_down: torch.Tensor, out=None
) -> torch.Tensor:
    """SwiGLU of every expert over its rows: buf ``[E, M, d]`` -> ``[E, M, d]``
    (into ``out`` where given)."""
    h = F.silu(torch.bmm(buf, w_gate)) * torch.bmm(buf, w_up)
    return torch.bmm(h, w_down, out=out)


def dispatch_compute_combine(cfg: ModelConfig, x, w_gate, w_up, w_down, top_w, top_e, slot):
    """x ``[B, S, d]``; weights in x's dtype.  Returns the experts' output
    ``[B, S, d]``.  Capacity rows are laid out ``[E, B, C]`` so that each
    expert's rows form one ``[B * C, d]`` block of the batched product."""
    B, S, d = x.shape
    E = w_gate.shape[0]
    C = expert_capacity(cfg, S)
    M = B * C
    n = E * M  # row n is the spare row: dropped pairs write it and gather zeros
    group = torch.arange(B, device=x.device)[:, None, None] * C
    row = torch.where(slot < C, top_e * M + group + slot, n)
    buf = x.new_zeros(n + 1, d)
    buf[row] = x[:, :, None, :]
    out_rows = x.new_empty(n + 1, d)
    out_rows[n] = 0
    expert_products(buf[:n].view(E, M, d), w_gate, w_up, w_down, out=out_rows[:n].view(E, M, d))
    weighted = out_rows[row] * top_w.to(x.dtype)[..., None]
    out = torch.zeros_like(x)
    for kk in range(cfg.moe_top_k):
        out = out + weighted[:, :, kk]
    return out


def shared_expert(p: Mapping[str, torch.Tensor], x: torch.Tensor) -> torch.Tensor:
    return (F.silu(x @ p["ws_gate"]) * (x @ p["ws_up"])) @ p["ws_down"]


def moe_ffn(
    cfg: ModelConfig, p: Mapping[str, torch.Tensor], x: torch.Tensor, *, whiten: bool = True
) -> Tuple[torch.Tensor, torch.Tensor]:
    """x ``[B, S, d]`` -> ``(out, aux)``, aux float32.  Groups = batch rows.
    ``p`` holds ``moe_specs``' leaves in x's dtype."""
    top_w, top_e, slot, aux = route(cfg, x, p["router"], whiten=whiten)
    out = dispatch_compute_combine(cfg, x, p["w_gate"], p["w_up"], p["w_down"], top_w, top_e, slot)
    if cfg.moe_num_shared:
        out = out + shared_expert(p, x)
    return out, aux.float()


class MoE(torch.nn.Module):
    """The MoE FFN of one layer; weights stored in the compute dtype (the
    reference casts them per einsum).  Serving drops ``aux``."""

    def __init__(self, cfg: ModelConfig, dtype: torch.dtype):
        super().__init__()
        self.cfg = cfg
        for name, spec in moe_specs(cfg).items():
            self.register_parameter(
                name, torch.nn.Parameter(torch.empty(spec.shape, dtype=dtype), requires_grad=False)
            )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return moe_ffn(self.cfg, self._parameters, x)[0]
