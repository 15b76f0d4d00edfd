"""Grouped-query attention (+ partial RoPE, optional QK-norm) over the banked KV pool.

The GQA part of the reference's ``models/attention.py``, with its layouts at
the public functions (``wq [d, h, k]``, ``wo [h, k, d]``, K/V ``[.., T, G, D]``).
Two regimes, computing the reference's function in each:

  prefill : causal attention over the prompt's fresh K/V through the
            flash-attention kernel (the reference: ``chunked_attention``);
            the fresh K/V are also written to the caller's staging burst.
  decode  : each slot's new K/V row is written into its pool block, then the
            paged-attention kernel attends to tokens ``0 .. pos`` through the
            block table (the reference: ``direct_attention`` over its dense
            cache).

K/V are stored in the KV dtype (bfloat16, as the reference's cache) and
attention reads them back from there, so a float32 run rounds them exactly
where the reference does.  ``impl="ref"`` calls the kernels' plain versions
on any device; it is the yardstick the card's run is held to.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.flash_attention.ref import flash_attention_ref
from repro_torch.kernels.paged_attention.ops import paged_attention
from repro_torch.kernels.paged_attention.ref import paged_attention_ref
from repro_torch.models.layers import ParamSpec, apply_rope, rmsnorm

NEG_INF = -1e9

#: attention functions per implementation: (prefill, decode)
ATTENTION = {
    "kernel": (flash_attention, paged_attention),
    "ref": (flash_attention_ref, paged_attention_ref),
}


def gqa_specs(cfg: ModelConfig) -> dict:
    d, h, g = cfg.d_model, cfg.num_heads, cfg.num_kv_heads
    k = cfg.resolved_head_dim
    spec = {
        "wq": ParamSpec((d, h, k), ("embed", "heads", "head_dim"), init="fan_in"),
        "wk": ParamSpec((d, g, k), ("embed", "kv_heads", "head_dim"), init="fan_in"),
        "wv": ParamSpec((d, g, k), ("embed", "kv_heads", "head_dim"), init="fan_in"),
        "wo": ParamSpec((h, k, d), ("heads", "head_dim", "embed"), init="fan_in"),
    }
    if cfg.use_qk_norm:
        spec["q_norm"] = ParamSpec((k,), (None,), init="ones")
        spec["k_norm"] = ParamSpec((k,), (None,), init="ones")
    return spec


def mask_bias(q_pos: torch.Tensor, kv_pos: torch.Tensor, *, causal: bool, window: int):
    """Additive mask ``[..., Sq, Tk]`` from absolute positions (-1 kv slot =
    empty), the reference's ``_mask_bias`` (``[..., 1, Tk]`` when neither
    causal nor windowed, as there)."""
    q = q_pos[..., :, None].int()
    t = kv_pos[..., None, :].int()
    ok = t >= 0
    if causal:
        ok = ok & (t <= q)
    if window:
        ok = ok & ((q - t) < window)
    return torch.where(ok, 0.0, NEG_INF).float()


@dataclass
class PagedKV:
    """What one decode step needs of the pool.

    ``pool`` is the engine's KV store viewed ``[NB, bs, L, 2, G, D]`` (K at
    index 0, V at 1); ``block_table [B, mb]`` and ``lengths [B]`` (int32) give
    each slot's blocks and the tokens it attends to (``pos + 1``; 0 and an
    all -1 row for an idle slot).  The step writes its new K/V row for slot
    ``write_slot[i]`` at block ``write_blk[i]``, row ``write_row[i]``."""

    pool: torch.Tensor
    block_table: torch.Tensor
    lengths: torch.Tensor
    write_slot: torch.Tensor
    write_blk: torch.Tensor
    write_row: torch.Tensor


class GQAAttention(torch.nn.Module):
    """Projections in the compute dtype; the QK-norm scales (``use_qk_norm``)
    stay float32, as the reference's norms read them."""

    def __init__(self, cfg: ModelConfig, dtype: torch.dtype):
        super().__init__()
        self.cfg = cfg
        for name, spec in gqa_specs(cfg).items():
            dt = dtype if len(spec.shape) > 1 else torch.float32
            self.register_parameter(
                name, torch.nn.Parameter(torch.empty(spec.shape, dtype=dt), requires_grad=False)
            )

    def _qkv(self, x: torch.Tensor, positions: torch.Tensor):
        cfg = self.cfg
        B, S, d = x.shape
        q = (x @ self.wq.reshape(d, -1)).view(B, S, cfg.num_heads, -1)
        k = (x @ self.wk.reshape(d, -1)).view(B, S, cfg.num_kv_heads, -1)
        v = (x @ self.wv.reshape(d, -1)).view(B, S, cfg.num_kv_heads, -1)
        if cfg.use_qk_norm:  # per head over head_dim, before RoPE, as the reference
            q = rmsnorm(q, self.q_norm, cfg.norm_eps)
            k = rmsnorm(k, self.k_norm, cfg.norm_eps)
        q = apply_rope(q, positions, theta=cfg.rope_theta, fraction=cfg.rope_fraction)
        k = apply_rope(k, positions, theta=cfg.rope_theta, fraction=cfg.rope_fraction)
        return q, k, v

    def _out(self, o: torch.Tensor) -> torch.Tensor:
        B, S = o.shape[:2]
        return o.reshape(B, S, -1) @ self.wo.reshape(-1, self.cfg.d_model)

    def prefill(self, x, positions, kv_out, *, kv_dtype, impl: str) -> torch.Tensor:
        """x ``[B, S, d]``, positions ``[B, S]``; ``kv_out`` (``[B, S, 2, G, D]``
        or None) receives the fresh K/V in ``kv_dtype``."""
        q, k, v = self._qkv(x, positions)
        k, v = k.to(kv_dtype), v.to(kv_dtype)
        if kv_out is not None:
            kv_out[:, :, 0] = k
            kv_out[:, :, 1] = v
        flash = ATTENTION[impl][0]
        return self._out(flash(q, k.to(x.dtype), v.to(x.dtype), causal=True))

    def decode(self, x, positions, cache: PagedKV, layer: int, *, impl: str) -> torch.Tensor:
        """x ``[B, 1, d]``, positions ``[B, 1]``."""
        q, k, v = self._qkv(x, positions)
        pool, i = cache.pool, cache.write_slot
        pool[cache.write_blk, cache.write_row, layer, 0] = k[i, 0].to(pool.dtype)
        pool[cache.write_blk, cache.write_row, layer, 1] = v[i, 0].to(pool.dtype)
        paged = ATTENTION[impl][1]
        o = paged(
            q[:, 0].contiguous(),
            pool[:, :, layer, 0],
            pool[:, :, layer, 1],
            cache.block_table,
            cache.lengths,
        )
        return self._out(o[:, None])
