"""Grouped-query attention (+ partial RoPE, optional QK-norm) and Multi-head
Latent Attention (DeepSeek-V2) over the banked KV pool.

The reference's ``models/attention.py``, with its layouts at the public
functions (``wq [d, h, k]``, ``wo [h, k, d]``, K/V ``[.., T, G, D]``).
Two regimes, computing the reference's function in each (GQA here; MLA in
``MLAAttention``, below):

  prefill : causal attention over the prompt's fresh K/V through the
            flash-attention kernel (the reference: ``chunked_attention``);
            the fresh K/V are also written to the caller's staging burst.
  decode  : each slot's new K/V row is written into its pool block, then the
            paged-attention kernel attends to tokens ``0 .. pos`` through the
            block table (the reference: ``direct_attention`` over its dense
            cache).

A sliding window (``cfg.sliding_window > 0``, h2o-danube) goes to every
attention call: a query at position ``q`` sees keys ``t`` with ``q - t <
window``, the reference's mask.  The reference's decode rolls a cache of
``window`` slots (``slot = pos % window``) and its prefill of a prompt longer
than the window attends over the whole prompt under the mask and keeps the
last ``window`` rows; here the pool keeps every row of a request, and the
paged kernel masks the rows before ``pos - window + 1`` itself, so both
compute the reference's function over the same keys.

K/V are stored in the KV dtype (bfloat16, as the reference's cache) and
attention reads them back from there, so a float32 run rounds them exactly
where the reference does.  ``impl="ref"`` calls the kernels' plain versions
on any device; it is the yardstick the card's run is held to.

Training (``forward_train``) attends over the fresh K/V of the sequence with
no cache, as the reference's ``gqa_attention`` without one, through
``TRAIN_ATTENTION[impl]``: the flash forward with its log-sum-exp and the
flash backward under autograd (the kernels, or their plain blockwise
versions).  Weights are cast to the activations' dtype at each use, which
costs nothing in serving (stored in that dtype) and casts the float32 master
weights of a training model, as the reference's ``p[...].astype(x.dtype)``.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.flash_attention.ops import flash_attention, flash_attention_train
from repro_torch.kernels.flash_attention.ref import flash_attention_ref, flash_attention_train_ref
from repro_torch.kernels.paged_attention.ops import paged_attention
from repro_torch.kernels.paged_attention.ref import paged_attention_ref
from repro_torch.models.layers import ParamSpec, apply_rope, rmsnorm

NEG_INF = -1e9

#: attention functions per implementation: (prefill, decode)
ATTENTION = {
    "kernel": (flash_attention, paged_attention),
    "ref": (flash_attention_ref, paged_attention_ref),
}

#: differentiable attention of the training forward per implementation
TRAIN_ATTENTION = {"kernel": flash_attention_train, "ref": flash_attention_train_ref}


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


def mla_specs(cfg: ModelConfig) -> dict:
    d, h = cfg.d_model, cfg.num_heads
    r, dn, dr, dv = cfg.kv_lora_rank, cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
    return {
        "wq": ParamSpec((d, h, dn + dr), ("embed", "heads", "head_dim"), init="fan_in"),
        "w_dkv": ParamSpec((d, r), ("embed", None), init="fan_in"),
        "w_kpe": ParamSpec((d, dr), ("embed", None), init="fan_in"),
        "kv_norm": ParamSpec((r,), (None,), init="ones"),
        "w_uk": ParamSpec((r, h, dn), (None, "heads", "head_dim"), init="fan_in"),
        "w_uv": ParamSpec((r, h, dv), (None, "heads", "head_dim"), init="fan_in"),
        "wo": ParamSpec((h, dv, d), ("heads", "head_dim", "embed"), init="fan_in"),
    }


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

    ``pool`` is the engine's KV store viewed by the model's row layout
    (``Transformer.kv_row_shape``): ``[NB, bs, L, 2, G, D]`` for GQA (K at
    index 0, V at 1), ``[NB, bs, L, kv_lora_rank + qk_rope_dim]`` for MLA's
    latent rows; ``block_table [B, mb]`` and ``lengths [B]`` (int32) give
    each slot's blocks and the tokens it attends to (``pos + 1``; 0 and an
    all -1 row for an idle slot).  The step writes its new row for slot
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
        q = (x @ self.wq.to(x.dtype).reshape(d, -1)).view(B, S, cfg.num_heads, -1)
        k = (x @ self.wk.to(x.dtype).reshape(d, -1)).view(B, S, cfg.num_kv_heads, -1)
        v = (x @ self.wv.to(x.dtype).reshape(d, -1)).view(B, S, cfg.num_kv_heads, -1)
        if cfg.use_qk_norm:  # per head over head_dim, before RoPE, as the reference
            q = rmsnorm(q, self.q_norm, cfg.norm_eps)
            k = rmsnorm(k, self.k_norm, cfg.norm_eps)
        q = apply_rope(q, positions, theta=cfg.rope_theta, fraction=cfg.rope_fraction)
        k = apply_rope(k, positions, theta=cfg.rope_theta, fraction=cfg.rope_fraction)
        return q, k, v

    def _out(self, o: torch.Tensor) -> torch.Tensor:
        B, S = o.shape[:2]
        return o.reshape(B, S, -1) @ self.wo.to(o.dtype).reshape(-1, self.cfg.d_model)

    def prefill(self, x, positions, kv_out, *, kv_dtype, impl: str) -> torch.Tensor:
        """x ``[B, S, d]``, positions ``[B, S]``; ``kv_out`` (``[B, S, 2, G, D]``
        or None) receives the fresh K/V in ``kv_dtype``."""
        q, k, v = self._qkv(x, positions)
        if kv_out is not None:
            kv_out[:, :, 0] = k
            kv_out[:, :, 1] = v
        window = self.cfg.sliding_window
        if not (window and x.shape[1] > window):
            # attention reads the K/V back as stored, as the reference reads its
            # cache; its rolling prefill (a prompt past the window) attends over
            # the fresh K/V in the compute dtype instead
            k, v = k.to(kv_dtype).to(x.dtype), v.to(kv_dtype).to(x.dtype)
        flash = ATTENTION[impl][0]
        return self._out(flash(q, k, v, causal=True, window=window))

    def forward_train(self, x, positions, *, impl: str) -> torch.Tensor:
        """Causal (and windowed) self-attention over ``x [B, S, d]``, differentiable."""
        q, k, v = self._qkv(x, positions)
        flash = TRAIN_ATTENTION[impl]
        qkv = (q.contiguous(), k.contiguous(), v.contiguous())
        return self._out(flash(*qkv, causal=True, window=self.cfg.sliding_window))

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
            window=self.cfg.sliding_window,
        )
        return self._out(o[:, None])


class MLAAttention(torch.nn.Module):
    """Multi-head Latent Attention (DeepSeek-V2), the reference's
    ``mla_attention``.  The cache holds one latent row per token and layer,
    ``[c_kv | k_pe]`` (``kv_lora_rank + qk_rope_dim``: 576 at full width),
    stored in the KV dtype; attention reads it back from there, as the
    reference reads its cache.  Projections in the compute dtype,
    ``kv_norm`` float32.  ``forward_train`` is the training form: the
    prefill's below over the sequence's fresh rows, with no cache.

      prefill : the reference's non-absorbed ("paper") form: the latent rows
                are up-projected to per-head K (``w_uk``, then ``k_pe``
                broadcast to every head) and V (``w_uv``), and the flash
                kernel attends at QK width ``qk_nope + qk_rope`` and V width
                ``v_head_dim`` with scale ``(qk_nope + qk_rope) ** -0.5``.
      decode  : ``absorbed=True``: ``w_uk`` folds into q and ``w_uv`` into
                the output, and the paged kernel attends in latent space,
                ``[q_nope w_uk | q_pe] . [c_kv | k_pe]``, with the layer's
                latent rows as K and their first ``kv_lora_rank`` columns as
                V: one KV group of all heads, each row read once.
                ``absorbed=False``: the reference's default form in plain
                PyTorch: the slot's rows gathered through the block table,
                up-projected and attended directly (tests and cross-checks).
    """

    def __init__(self, cfg: ModelConfig, dtype: torch.dtype):
        super().__init__()
        self.cfg = cfg
        for name, spec in mla_specs(cfg).items():
            dt = dtype if len(spec.shape) > 1 else torch.float32
            self.register_parameter(
                name, torch.nn.Parameter(torch.empty(spec.shape, dtype=dt), requires_grad=False)
            )

    @property
    def scale(self) -> float:
        return (self.cfg.qk_nope_dim + self.cfg.qk_rope_dim) ** -0.5

    def _project(self, x: torch.Tensor, positions: torch.Tensor):
        """``(q_nope [B, S, h, dn], q_pe [B, S, h, dr]`` roped, the latent
        rows ``[c_kv | k_pe] [B, S, r + dr])`` in x's dtype."""
        cfg = self.cfg
        B, S, d = x.shape
        dn = cfg.qk_nope_dim
        q = (x @ self.wq.to(x.dtype).reshape(d, -1)).view(B, S, cfg.num_heads, -1)
        q_pe = apply_rope(q[..., dn:], positions, theta=cfg.rope_theta)
        c_kv = rmsnorm(x @ self.w_dkv.to(x.dtype), self.kv_norm, cfg.norm_eps)
        k_pe = apply_rope((x @ self.w_kpe.to(x.dtype))[:, :, None], positions, theta=cfg.rope_theta)
        return q[..., :dn], q_pe, torch.cat([c_kv, k_pe[:, :, 0]], dim=-1)

    def _out(self, o: torch.Tensor) -> torch.Tensor:
        B, S = o.shape[:2]
        return o.reshape(B, S, -1) @ self.wo.to(o.dtype).reshape(-1, self.cfg.d_model)

    def _up(self, rows: torch.Tensor):
        """Latent rows ``[B, T, r + dr]`` -> per-head ``(k [B, T, h, dn + dr],
        v [B, T, h, dv])``: ``c_kv`` up-projected, ``k_pe`` on every head."""
        cfg = self.cfg
        B, T, _ = rows.shape
        r, h = cfg.kv_lora_rank, cfg.num_heads
        c_all, pe_all = rows[..., :r], rows[..., r:]
        k_nope = (c_all @ self.w_uk.to(rows.dtype).reshape(r, -1)).view(B, T, h, -1)
        v = (c_all @ self.w_uv.to(rows.dtype).reshape(r, -1)).view(B, T, h, -1)
        k = torch.cat([k_nope, pe_all[:, :, None].expand(B, T, h, cfg.qk_rope_dim)], dim=-1)
        return k, v

    def prefill(self, x, positions, kv_out, *, kv_dtype, impl: str) -> torch.Tensor:
        """x ``[B, S, d]``, positions ``[B, S]``; ``kv_out`` (``[B, S, r + dr]``
        or None) receives the latent rows in ``kv_dtype``."""
        q_nope, q_pe, rows = self._project(x, positions)
        rows = rows.to(kv_dtype)
        if kv_out is not None:
            kv_out.copy_(rows)
        k, v = self._up(rows.to(x.dtype))
        q = torch.cat([q_nope, q_pe], dim=-1)
        flash = ATTENTION[impl][0]
        return self._out(flash(q, k.contiguous(), v.contiguous(), causal=True, scale=self.scale))

    def forward_train(self, x, positions, *, impl: str) -> torch.Tensor:
        """Causal self-attention over ``x [B, S, d]``, differentiable: the
        reference's non-absorbed form with no cache, the fresh latent rows
        up-projected in x's dtype (``k_pe`` reaches every head through
        ``expand``, so its gradient sums over the heads) and attended at QK
        width ``qk_nope + qk_rope``, V width ``v_head_dim``."""
        q_nope, q_pe, rows = self._project(x, positions)
        k, v = self._up(rows)
        q = torch.cat([q_nope, q_pe], dim=-1)
        flash = TRAIN_ATTENTION[impl]
        return self._out(
            flash(q.contiguous(), k.contiguous(), v.contiguous(), causal=True, scale=self.scale)
        )

    def decode(
        self, x, positions, cache: PagedKV, layer: int, *, impl: str, absorbed: bool = True
    ) -> torch.Tensor:
        """x ``[B, 1, d]``, positions ``[B, 1]``; ``cache.pool`` the latent
        view ``[NB, bs, L, r + dr]``."""
        r = self.cfg.kv_lora_rank
        q_nope, q_pe, rows = self._project(x, positions)
        pool, i = cache.pool, cache.write_slot
        pool[cache.write_blk, cache.write_row, layer] = rows[i, 0].to(pool.dtype)
        lat = pool[:, :, layer]
        if not absorbed:
            return self._out(self._decode_up(q_nope, q_pe, lat, cache)[:, None])
        q_lat = torch.einsum("bhk,rhk->bhr", q_nope[:, 0], self.w_uk.to(x.dtype))
        q = torch.cat([q_lat, q_pe[:, 0]], dim=-1).contiguous()
        kv = lat[:, :, None]  # [NB, bs, 1, r + dr]: one KV group of all the heads
        paged = ATTENTION[impl][1]
        o_lat = paged(q, kv, kv[..., :r], cache.block_table, cache.lengths, scale=self.scale)
        o = torch.einsum("bhr,rhk->bhk", o_lat, self.w_uv.to(x.dtype))
        return self._out(o[:, None])

    def _decode_up(self, q_nope, q_pe, lat, cache: PagedKV) -> torch.Tensor:
        """The reference's non-absorbed decode over each slot's rows,
        gathered through the block table: ``[B, h, dv]`` in q's dtype."""
        B, mb = cache.block_table.shape
        bs = lat.shape[1]
        tbl = cache.block_table.long()
        rows = lat[tbl.clamp(min=0)].reshape(B, mb * bs, -1).to(q_nope.dtype)
        tok = torch.arange(mb * bs, device=rows.device)
        valid = (tok[None] < cache.lengths[:, None].long()) & (tbl >= 0).repeat_interleave(bs, 1)
        k, v = self._up(rows)
        q = torch.cat([q_nope, q_pe], dim=-1)[:, 0]  # [B, h, dn + dr]
        s = torch.einsum("bhk,bthk->bht", q.float(), k.float()) * self.scale
        w = torch.softmax(s.masked_fill(~valid[:, None], NEG_INF), dim=-1)
        return torch.einsum("bht,bthk->bhk", w.to(v.dtype).float(), v.float()).to(q.dtype)
