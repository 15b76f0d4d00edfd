"""Grouped-query attention (+ partial RoPE, optional QK-norm), whisper's
cross-attention and Multi-head Latent Attention (DeepSeek-V2) over the
banked KV pool.

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
compute the reference's function over the same keys.  A prompt past the
window must be a whole number of windows, as the reference's rolling
prefill asserts (``GQAAttention.prefill`` raises ``ValueError``).

Whisper (``cfg.is_encoder_decoder``) attends without RoPE: its encoder's
self-attention is non-causal over the fresh K/V of its frames
(``GQAAttention.forward``, flash with ``causal=False``), and each decoder
layer's ``CrossAttention`` attends to the encoder's output: through the
flash kernel at prefill and in training, and at decode through the paged
kernel over each slot's cross K/V (``CrossKV``, kept beside the pool).

The reference's contiguous cache (``init_gqa_cache``, ``init_mla_cache``:
``[L, B, T, ...]`` leaves and ``pos`` -1 for an empty slot) is the other
form: ``prefill(..., cache=)`` writes a prompt at slot 0 (a prompt longer
than the cache rolls its last ``T`` rows in, ``write_prefill``), and
``decode_cache`` writes one row at slot ``pos % T`` (``write_kv_cache``)
and runs the same paged kernel over the cache, each sequence's slots read
as consecutive blocks (``CacheView``, ``lengths = min(pos + 1, T)``).  On
DTensors (a sharded step) each rank attends over its own slots and the
ranks merge by log-sum-exp: the step registers those operations
(``sharding_hooks.cache_ops``, ``distributed.serve``).

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

import math
from dataclasses import dataclass

import torch
from torch.distributed.tensor import DTensor, Replicate

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.flash_attention.ops import flash_attention, flash_attention_train
from repro_torch.kernels.flash_attention.ref import flash_attention_ref, flash_attention_train_ref
from repro_torch.kernels.paged_attention.ops import paged_attention
from repro_torch.kernels.paged_attention.ref import paged_attention_ref
from repro_torch.models.layers import ParamSpec, apply_rope, rmsnorm
from repro_torch.models.sharding_hooks import (
    cache_ops,
    gather_sequence,
    grad_as_value,
    on_batch_rows,
    shard_activations,
    whole_sequence_grad,
)

NEG_INF = -1e9

#: attention functions per implementation: (prefill, decode)
ATTENTION = {
    "kernel": (flash_attention, paged_attention),
    "ref": (flash_attention_ref, paged_attention_ref),
}

#: differentiable attention of the training forward per implementation
TRAIN_ATTENTION = {"kernel": flash_attention_train, "ref": flash_attention_train_ref}


def _attn_io(*ts):
    """The attention operands under the ``attn_io`` constraint (batch over
    the data-parallel axes, the sequence whole, heads free): the identity
    with no sharder registered."""
    return tuple(shard_activations(t, "attn_io") for t in ts)


def _whole_heads(y: DTensor, heads: int) -> DTensor:
    """``y [..., heads * k]`` with its last dim split only where the split
    falls on whole heads: a mesh dim that does not divide ``heads`` (KV
    groups or heads the rules keep whole) is gathered."""
    mesh = y.device_mesh
    want = [
        Replicate() if p.is_shard(y.dim() - 1) and heads % mesh.size(i) else p
        for i, p in enumerate(y.placements)
    ]
    return y if want == list(y.placements) else y.redistribute(mesh, want)


class _WholeHeads(torch.autograd.Function):
    """``_whole_heads`` on a value and on its gradient: DTensor's products
    may split a flattened ``heads * k`` dim where the heads are kept whole
    (a free chunk of a replicated weight), and the heads' view cannot
    unflatten that split, neither the forward's nor the backward's."""

    @staticmethod
    def forward(ctx, y, heads):
        ctx.heads = heads
        return _whole_heads(y, heads)

    @staticmethod
    def backward(ctx, g):
        return _whole_heads(g, ctx.heads), None


def _heads_flat(y: torch.Tensor, heads: int) -> torch.Tensor:
    """``y [..., heads * k]`` before or after its heads' view, split on
    whole heads only (above); anything but a DTensor as it is."""
    return _WholeHeads.apply(y, heads) if isinstance(y, DTensor) else y


def _flash(flash, q, k, v, **kw):
    """``flash(q, k, v, **kw)``; on DTensors (a sharded step) the same call
    on each rank's block through ``local_map``: attention is independent
    across batch rows and heads, so the blocks need no collective.  The
    batch stays as the ``attn_io`` constraint laid it out; the heads stay
    sharded where q's and K/V's heads are split alike, and are replicated
    elsewhere (e.g. KV groups that the ``model`` axis does not divide)."""
    if not isinstance(q, DTensor):
        return flash(q, k, v, **kw)
    from torch.distributed.tensor.experimental import local_map

    pl = []
    for a, b in zip(q.placements, k.placements):
        same = a.is_shard() and a == b and a.dim in (0, 2)
        pl.append(a if same else Replicate())
    run = local_map(
        lambda q, k, v: flash(q, k, v, **kw),
        out_placements=pl,
        in_placements=(pl, pl, pl),
        device_mesh=q.device_mesh,
        redistribute_inputs=True,
    )
    return run(q, k, v)


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


# ---------------------------------------------------------------------------
# The contiguous cache (the reference's ``init_cache`` trees)
# ---------------------------------------------------------------------------


def init_gqa_cache(cfg: ModelConfig, num_layers, batch: int, length: int, dtype, device) -> dict:
    """The reference's GQA cache: ``k``/``v`` ``[*layers, B, T, G, D]`` in
    ``dtype`` (zeros) and ``pos [*layers, B, T]`` int32, -1 (empty)."""
    lead = (num_layers,) if isinstance(num_layers, int) else tuple(num_layers)
    g, k = cfg.num_kv_heads, cfg.resolved_head_dim
    kw = dict(dtype=dtype, device=device)
    return {
        "k": torch.zeros((*lead, batch, length, g, k), **kw),
        "v": torch.zeros((*lead, batch, length, g, k), **kw),
        "pos": torch.full((*lead, batch, length), -1, dtype=torch.int32, device=device),
    }


def init_mla_cache(cfg: ModelConfig, num_layers: int, batch: int, length: int, dtype, device):
    """MLA's cache: the reference's ``c_kv [L, B, T, r]`` and ``k_pe [L, B,
    T, dr]`` side by side in one row, ``latent [L, B, T, r + dr]`` (576 at
    full width; ``mla_cache_tree`` splits it back), and ``pos [L, B, T]``
    -1.  The latent call reads one row of 576 with V its first 512 columns
    (``kernels.paged_attention``), so the row stays whole; its bytes, and
    each rank's under the cache's sharding, are the two leaves' sum."""
    return {
        "latent": torch.zeros(
            (num_layers, batch, length, cfg.latent_dim), dtype=dtype, device=device
        ),
        "pos": torch.full((num_layers, batch, length), -1, dtype=torch.int32, device=device),
    }


def mla_cache_tree(cache: dict, cfg: ModelConfig) -> dict:
    """An MLA cache as the reference's tree (views): ``c_kv``, ``k_pe``, ``pos``."""
    r = cfg.kv_lora_rank
    lat = cache["latent"]
    return {"c_kv": lat[..., :r], "k_pe": lat[..., r:], "pos": cache["pos"]}


def _write_slot(buf: torch.Tensor, new: torch.Tensor, slot: torch.Tensor) -> torch.Tensor:
    """Write ``new [B, S, ...]`` into ``buf [B, T, ...]`` at slot ``slot``
    (a scalar or ``[B]`` tensor) onward, in place, with no host read."""
    B, S = new.shape[:2]
    rows = slot.reshape(-1, 1).long() + torch.arange(S, device=buf.device)
    buf[torch.arange(B, device=buf.device)[:, None], rows.expand(B, S)] = new.to(buf.dtype)
    return buf


def write_kv_cache(layer: dict, updates: dict, positions: torch.Tensor, slot) -> dict:
    """The reference's ``write_kv_cache``, in place: each of ``updates``
    (the layer's leaves but ``pos``, ``[B, S, ...]``) and ``positions [B,
    S]`` at ``slot`` (scalar or ``[B]``)."""
    for name, new in updates.items():
        _write_slot(layer[name], new, slot)
    _write_slot(layer["pos"], positions.to(torch.int32), slot)
    return layer


def write_prefill(layer: dict, updates: dict, positions: torch.Tensor) -> None:
    """A prompt's rows into a layer cache at slot 0: all ``S`` of them, or,
    into a rolling cache of ``T < S`` slots, the last ``T`` (the
    reference's rolling prefill: their slots are their positions mod ``T``,
    as ``S % T == 0``).  In place on plain tensors and on DTensors alike
    (``copy_`` lays the rows out as the cache); in a sharded step, a
    prompt shorter than the cache goes through the registered
    ``sharding_hooks.cache_ops`` (each rank writes its own slots)."""
    S, T = positions.shape[1], layer["pos"].shape[1]
    keep = min(S, T)
    if keep < T and (ops := cache_ops()) is not None:  # a rank writes its own slots
        return ops.write_prefill(layer, updates, positions)
    for name, new in (*updates.items(), ("pos", positions.to(torch.int32))):
        dst = layer[name] if keep == T else layer[name][:, :keep]
        dst.copy_(new[:, S - keep :])


def check_rolling(S: int, T: int) -> None:
    """A prompt longer than its cache must be a whole number of cache
    lengths, as the reference's rolling prefill asserts."""
    if S > T and S % T:
        raise ValueError(
            f"a prompt of {S} tokens past a {T}-slot rolling cache must be a whole number of "
            "windows (the reference's rolling prefill asserts S % window == 0)"
        )


def view_block_size(length: int, *, latent: bool = False) -> int:
    """Rows of a block when a contiguous cache of ``length`` slots a
    sequence is read as the paged kernel's pool: 16 where that divides
    ``length`` (else the largest power of two that does), doubled for the
    latent call until a sequence takes at most ``LATENT_MAX_TABLE`` blocks
    (``decode_32k``: blocks of 32)."""
    from repro_torch.kernels.paged_attention.ops import LATENT_MAX_TABLE

    bs = math.gcd(length, 16)
    while latent and length // bs > LATENT_MAX_TABLE and length % (2 * bs) == 0:
        bs *= 2
    return bs


@dataclass
class CacheView:
    """One decode step's read of contiguous layer caches ``[B, T, ...]`` as
    the paged kernel's pool: each sequence's ``T`` slots viewed as ``T /
    block_size`` consecutive blocks (``block_table [B, T / block_size]``,
    row ``b``'s blocks ``b * nb .. b * nb + nb - 1``) and ``lengths [B] =
    min(pos + 1, T)``.  The cache is filled in slot order (a prompt at slot
    0, then one token a step at ``pos % T``), so the slots below that length
    are exactly the ones the reference's mask keeps: ``0 .. pos`` of a
    cache longer than the context, every slot of a full rolling window
    (whose rows are in ring order: only the order of summation differs)."""

    block_table: torch.Tensor
    lengths: torch.Tensor
    block_size: int

    @classmethod
    def make(cls, pos: torch.Tensor, length: int, *, latent: bool = False) -> "CacheView":
        """``pos [B]`` the step's absolute positions, ``length`` the cache's slots."""
        B = pos.shape[0]
        bs = view_block_size(length, latent=latent)
        nb = length // bs
        table = torch.arange(B * nb, dtype=torch.int32, device=pos.device).view(B, nb)
        lengths = torch.clamp(pos.long() + 1, max=length).to(torch.int32)
        return cls(table, lengths, bs)

    def pool(self, buf: torch.Tensor) -> torch.Tensor:
        """A layer cache ``[B, T, ...]`` (contiguous) as blocks ``[B T / bs, bs, ...]``."""
        B, T = buf.shape[:2]
        return buf.view(B * T // self.block_size, self.block_size, *buf.shape[2:])


class GQAAttention(torch.nn.Module):
    """Projections in the compute dtype; the QK-norm scales (``use_qk_norm``)
    stay float32, as the reference's norms read them.  q and k are rotated
    unless the stack is an encoder-decoder one (whisper: the reference's
    ``use_rope=not cfg.is_encoder_decoder``); ``causal=False`` lets every
    query see every key (whisper's encoder)."""

    def __init__(self, cfg: ModelConfig, dtype: torch.dtype, *, causal: bool = True):
        super().__init__()
        self.cfg = cfg
        self.causal = causal
        for name, spec in gqa_specs(cfg).items():
            dt = dtype if len(spec.shape) > 1 else torch.float32
            self.register_parameter(
                name, torch.nn.Parameter(torch.empty(spec.shape, dtype=dt), requires_grad=False)
            )

    @staticmethod
    def _proj(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        """``x [B, S, d]`` times ``w [d, heads, k]`` -> ``[B, S, heads, k]``."""
        B, S, d = x.shape
        y = _heads_flat(x @ w.to(x.dtype).reshape(d, -1), w.shape[1])
        return y.view(B, S, *w.shape[1:])

    def _qkv(self, x: torch.Tensor, positions: torch.Tensor):
        cfg = self.cfg
        x = gather_sequence(x)
        q, k, v = self._proj(x, self.wq), self._proj(x, self.wk), self._proj(x, self.wv)
        if cfg.use_qk_norm:  # per head over head_dim, before RoPE, as the reference
            q = rmsnorm(q, self.q_norm, cfg.norm_eps)
            k = rmsnorm(k, self.k_norm, cfg.norm_eps)
        if not cfg.is_encoder_decoder:  # the reference's use_rope
            q = apply_rope(q, positions, theta=cfg.rope_theta, fraction=cfg.rope_fraction)
            k = apply_rope(k, positions, theta=cfg.rope_theta, fraction=cfg.rope_fraction)
        return q, k, v

    def _out(self, o: torch.Tensor) -> torch.Tensor:
        B, S, H = o.shape[:3]
        o = _heads_flat(o.reshape(B, S, -1), H)
        return whole_sequence_grad(o @ self.wo.to(o.dtype).reshape(-1, self.cfg.d_model))

    def prefill(self, x, positions, kv_out, *, kv_dtype, impl: str, cache=None) -> torch.Tensor:
        """x ``[B, S, d]``, positions ``[B, S]``; ``kv_out`` (``[B, S, 2, G, D]``
        or None) receives the fresh K/V in ``kv_dtype``.  A prompt longer
        than the sliding window must be a whole number of windows
        (``ValueError``): the reference's rolling prefill, into the
        window-sized cache its engine gives a context past the window,
        asserts it.  ``cache`` (a contiguous layer cache ``{"k", "v",
        "pos"}``, ``[B, T, ...]``) instead receives the K/V at slot 0
        (``write_prefill``; ``kv_dtype`` is then its dtype), and the
        rolling prefill is that of a prompt longer than ``T``."""
        window, S = self.cfg.sliding_window, x.shape[1]
        T = window if cache is None else cache["pos"].shape[1]
        rolling = bool(T) and S > T
        check_rolling(S, T or S)
        q, k, v = self._qkv(x, positions)
        if kv_out is not None:
            kv_out[:, :, 0] = k
            kv_out[:, :, 1] = v
        if cache is not None:
            write_prefill(cache, {"k": k, "v": v}, positions)
            kv_dtype = cache["k"].dtype
        if not rolling:
            # attention reads the K/V back as stored, as the reference reads its
            # cache; its rolling prefill (a prompt past the window) attends over
            # the fresh K/V in the compute dtype instead
            k, v = k.to(kv_dtype).to(x.dtype), v.to(kv_dtype).to(x.dtype)
        flash = ATTENTION[impl][0]
        q, k, v = _attn_io(q, k, v)
        return self._out(_flash(flash, q, k, v, causal=True, window=window))

    def forward(self, x, positions, *, impl: str) -> torch.Tensor:
        """Self-attention over the fresh K/V of ``x [B, S, d]`` in its dtype,
        with no cache (whisper's encoder: the reference's ``gqa_attention``
        without one)."""
        q, k, v = _attn_io(*self._qkv(x, positions))
        flash = ATTENTION[impl][0]
        return self._out(_flash(flash, q, k, v, causal=self.causal, window=self.cfg.sliding_window))

    def forward_train(self, x, positions, *, impl: str) -> torch.Tensor:
        """Self-attention over ``x [B, S, d]`` (causal unless built
        otherwise, windowed where the config says), differentiable."""
        q, k, v = _attn_io(*self._qkv(x, positions))
        flash = TRAIN_ATTENTION[impl]
        qkv = (q.contiguous(), k.contiguous(), v.contiguous())
        return self._out(_flash(flash, *qkv, causal=self.causal, window=self.cfg.sliding_window))

    def decode_cache(self, x, positions, cache: dict, view: CacheView, *, impl: str):
        """One token a sequence over a contiguous layer cache (``{"k", "v",
        "pos"}``, ``[B, T, ...]``): its K/V written at slot ``pos % T``,
        then the paged kernel over the cache's slots through ``view``
        (the reference's ``direct_attention`` over its cache, read in the
        compute dtype).  In a sharded decode step each rank attends over its
        own slots and the ranks merge by log-sum-exp (the registered
        ``sharding_hooks.cache_ops``)."""
        q, k, v = self._qkv(x, positions)
        if (ops := cache_ops()) is not None:
            o = ops.attention(self.cfg, q[:, 0], {"k": k, "v": v}, positions, cache, impl=impl)
            return self._out(o[:, None])
        write_kv_cache(cache, {"k": k, "v": v}, positions, positions[:, 0] % cache["pos"].shape[1])
        paged = ATTENTION[impl][1]
        o = paged(
            q[:, 0].contiguous(),
            view.pool(cache["k"]).to(q.dtype),
            view.pool(cache["v"]).to(q.dtype),
            view.block_table,
            view.lengths,
            window=self.cfg.sliding_window,
        )
        return self._out(o[:, None])

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


@dataclass
class CrossKV:
    """Each decode slot's cross-attention K/V, kept beside the pool as an SSM
    stack's state is (the reference's ``ck``/``cv``, ``[L, B, T_enc, G,
    D]``, in the KV dtype).

    ``kv`` ``[slots * nb, bs, L, 2, G, D]`` holds slot ``s``'s encoder rows
    in blocks ``s * nb .. s * nb + nb - 1`` (``nb = ceil(T_enc / bs)``), K at
    index 0 and V at 1 of every decoder layer, so one layer's K (or V) is a
    strided view laid out as the pool's, and the paged kernel reads it
    through ``block_table [slots, nb]`` with ``lengths [slots]`` = ``T_enc``
    (every slot attends to all its encoder rows, as the reference's batched
    decode does; an idle slot's rows are those of its last request, or
    zeros).  The pool's blocks, placement and KV record stay the
    reference's: these rows are no pool blocks."""

    kv: torch.Tensor
    block_table: torch.Tensor
    lengths: torch.Tensor
    enc_len: int

    @classmethod
    def empty(cls, cfg: ModelConfig, slots: int, block_size: int, *, dtype, device) -> "CrossKV":
        nb = -(-cfg.encoder_seq_len // block_size)
        shape = (slots * nb, block_size, cfg.num_layers, 2, cfg.num_kv_heads)
        kv = torch.zeros((*shape, cfg.resolved_head_dim), dtype=dtype, device=device)
        table = torch.arange(slots * nb, dtype=torch.int32, device=device).view(slots, nb)
        lengths = torch.full((slots,), cfg.encoder_seq_len, dtype=torch.int32, device=device)
        return cls(kv, table, lengths, cfg.encoder_seq_len)

    def slot(self, s: int) -> torch.Tensor:
        """Slot ``s``'s rows as prefill writes them: ``[1, T_enc, L, 2, G, D]``."""
        nb = self.block_table.shape[1]
        rows = self.kv[s * nb : (s + 1) * nb]
        return rows.reshape(1, -1, *rows.shape[2:])[:, : self.enc_len]

    def nbytes(self) -> int:
        return self.kv.numel() * self.kv.element_size()


class CrossAttention(GQAAttention):
    """Whisper's cross-attention (the reference's ``_encdec_layer``, its
    cross part): queries from the decoder, K and V from the encoder's
    output, no RoPE, never causal; ``gqa_specs`` parameters.

      prefill, training : K/V projected from ``encoder_out`` and attended
                in the compute dtype through the flash kernel (non-causal,
                keys masked by their true length ``T_enc``; the reference:
                ``chunked_attention``), as the reference attends over the
                fresh K/V; prefill also writes them to the slot's rows of the
                cross buffer in the KV dtype (the reference's ``ck``/``cv``).
      decode  : the paged kernel over the cross buffer's K/V of the layer,
                read back in the KV dtype through ``CrossKV``'s block table
                (the reference: ``direct_attention`` over ``ck``/``cv``):
                one query a slot over its ``T_enc`` rows, split over the
                rows' spans as the pool's decode is.
    """

    def __init__(self, cfg: ModelConfig, dtype: torch.dtype):
        super().__init__(cfg, dtype, causal=False)

    def prefill(self, x, encoder_out, cross_out, *, impl: str, cache=None) -> torch.Tensor:
        """x ``[B, S, d]``, encoder_out ``[B, T_enc, d]``; ``cross_out``
        (``[B, T_enc, 2, G, D]`` or None) receives the K/V in its dtype, as
        ``cache`` (a contiguous layer cache: ``ck``/``cv [B, T_enc, G, D]``)
        does."""
        q, k, v = self._cross_qkv(x, encoder_out)
        if cross_out is not None:
            cross_out[:, :, 0] = k
            cross_out[:, :, 1] = v
        if cache is not None:
            cache["ck"].copy_(k)
            cache["cv"].copy_(v)
        flash = ATTENTION[impl][0]
        return self._out(_flash(flash, *_attn_io(q, k, v), causal=False))

    def forward_train(self, x, encoder_out, *, impl: str) -> torch.Tensor:
        """Differentiable, over the fresh K/V of ``encoder_out``."""
        q, k, v = _attn_io(*self._cross_qkv(x, encoder_out))
        flash = TRAIN_ATTENTION[impl]
        qkv = (q.contiguous(), k.contiguous(), v.contiguous())
        return self._out(_flash(flash, *qkv, causal=False))

    def _cross_qkv(self, x, encoder_out):
        """q from the decoder's ``x``, K/V from ``encoder_out``, each input
        gathered from sequence parallelism first as ``_qkv`` gathers its
        own (a product over a batch x sequence dim split over two mesh dims
        has no DTensor strategy)."""
        x, encoder_out = gather_sequence(x), gather_sequence(encoder_out)
        k, v = self._proj(encoder_out, self.wk), self._proj(encoder_out, self.wv)
        return self._proj(x, self.wq), k, v

    def decode_cache(self, x, cache: dict, *, impl: str) -> torch.Tensor:
        """x ``[B, 1, d]`` over a contiguous layer cache's ``ck``/``cv``
        ``[B, T_enc, G, D]``: the paged kernel over every row of each
        sequence (``CacheView``; the reference's ``direct_attention``, non-
        causal, over ``ck``/``cv`` in the compute dtype).  On DTensors each
        rank attends for its own batch rows (``on_batch_rows``)."""
        q = self._proj(gather_sequence(x), self.wq)[:, 0]
        paged = ATTENTION[impl][1]

        def rows(q, ck, cv):
            B, T = ck.shape[:2]
            view = CacheView.make(torch.full((B,), T - 1, device=q.device), T)
            kv = view.pool(ck).to(q.dtype), view.pool(cv).to(q.dtype)
            return paged(q.contiguous(), *kv, view.block_table, view.lengths)

        o = on_batch_rows(rows, (q, cache["ck"], cache["cv"]))
        return self._out(o[:, None])

    def decode(self, x, cross: CrossKV, layer: int, *, impl: str) -> torch.Tensor:
        """x ``[B, 1, d]`` for the ``B`` slots of ``cross``."""
        paged = ATTENTION[impl][1]
        kv = cross.kv[:, :, layer]
        q = self._proj(x, self.wq)[:, 0].contiguous()
        o = paged(q, kv[:, :, 0], kv[:, :, 1], cross.block_table, cross.lengths)
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
        x = gather_sequence(x)
        B, S, d = x.shape
        dn = cfg.qk_nope_dim
        q = _heads_flat(x @ self.wq.to(x.dtype).reshape(d, -1), cfg.num_heads)
        q = q.view(B, S, cfg.num_heads, -1)
        q_pe = apply_rope(q[..., dn:], positions, theta=cfg.rope_theta)
        # the latent rows' gradient comes back summed over the heads' split
        # (``w_uk``/``w_uv``, ``k_pe`` on every head): laid out as the rows
        c_kv = grad_as_value(x @ self.w_dkv.to(x.dtype))
        k_pe = grad_as_value(x @ self.w_kpe.to(x.dtype))
        c_kv = rmsnorm(c_kv, self.kv_norm, cfg.norm_eps)
        k_pe = apply_rope(k_pe[:, :, None], positions, theta=cfg.rope_theta)
        return q[..., :dn], q_pe, torch.cat([c_kv, k_pe[:, :, 0]], dim=-1)

    def _out(self, o: torch.Tensor) -> torch.Tensor:
        B, S, H = o.shape[:3]
        o = _heads_flat(o.reshape(B, S, -1), H)
        return whole_sequence_grad(o @ self.wo.to(o.dtype).reshape(-1, self.cfg.d_model))

    def _up(self, rows: torch.Tensor, w_up=None):
        """Latent rows ``[B, T, r + dr]`` -> per-head ``(k [B, T, h, dn + dr],
        v [B, T, h, dv])``: ``c_kv`` up-projected, ``k_pe`` on every head.
        ``w_up``: ``(w_uk, w_uv)`` as given (a rank's whole copies), else
        the module's."""
        cfg = self.cfg
        B, T, _ = rows.shape
        r, h = cfg.kv_lora_rank, cfg.num_heads
        w_uk, w_uv = w_up or (self.w_uk, self.w_uv)
        c_all, pe_all = rows[..., :r], rows[..., r:]
        k_nope = (c_all @ w_uk.to(rows.dtype).reshape(r, -1)).view(B, T, h, -1)
        v = (c_all @ w_uv.to(rows.dtype).reshape(r, -1)).view(B, T, h, -1)
        k = torch.cat([k_nope, pe_all[:, :, None].expand(B, T, h, cfg.qk_rope_dim)], dim=-1)
        return k, v

    def prefill(self, x, positions, kv_out, *, kv_dtype, impl: str, cache=None) -> torch.Tensor:
        """x ``[B, S, d]``, positions ``[B, S]``; ``kv_out`` (``[B, S, r + dr]``
        or None) receives the latent rows in ``kv_dtype``; ``cache`` (a
        contiguous layer cache ``{"latent", "pos"}``) receives them at slot
        0 in its dtype instead."""
        q_nope, q_pe, rows = self._project(x, positions)
        if cache is not None:
            check_rolling(x.shape[1], cache["pos"].shape[1])
            kv_dtype = cache["latent"].dtype
            write_prefill(cache, {"latent": rows}, positions)
        rows = rows.to(kv_dtype)
        if kv_out is not None:
            kv_out.copy_(rows)
        k, v = self._up(rows.to(x.dtype))
        q, k, v = _attn_io(torch.cat([q_nope, q_pe], dim=-1), k, v)
        flash = ATTENTION[impl][0]
        k, v = k.contiguous(), v.contiguous()
        return self._out(_flash(flash, q, k, v, causal=True, scale=self.scale))

    def forward_train(self, x, positions, *, impl: str) -> torch.Tensor:
        """Causal self-attention over ``x [B, S, d]``, differentiable: the
        reference's non-absorbed form with no cache, the fresh latent rows
        up-projected in x's dtype (``k_pe`` reaches every head through
        ``expand``, so its gradient sums over the heads) and attended at QK
        width ``qk_nope + qk_rope``, V width ``v_head_dim``."""
        q_nope, q_pe, rows = self._project(x, positions)
        k, v = self._up(rows)
        q, k, v = _attn_io(torch.cat([q_nope, q_pe], dim=-1), k, v)
        flash = TRAIN_ATTENTION[impl]
        qkv = (q.contiguous(), k.contiguous(), v.contiguous())
        return self._out(_flash(flash, *qkv, causal=True, scale=self.scale))

    def decode(
        self, x, positions, cache: PagedKV, layer: int, *, impl: str, absorbed: bool = True
    ) -> torch.Tensor:
        """x ``[B, 1, d]``, positions ``[B, 1]``; ``cache.pool`` the latent
        view ``[NB, bs, L, r + dr]``."""
        q_nope, q_pe, rows = self._project(x, positions)
        pool, i = cache.pool, cache.write_slot
        pool[cache.write_blk, cache.write_row, layer] = rows[i, 0].to(pool.dtype)
        return self._out(
            self.attend_latent(q_nope, q_pe, pool[:, :, layer], cache, impl, absorbed)[:, None]
        )

    def decode_cache(
        self, x, positions, cache: dict, view: CacheView, *, impl: str, absorbed: bool = True
    ) -> torch.Tensor:
        """One token a sequence over a contiguous layer cache (``{"latent",
        "pos"}``, ``[B, T, ...]``): its latent row written at slot ``pos %
        T``, then, ``absorbed``, the latent call over the cache's rows
        through ``view`` (blocks of ``view_block_size(T, latent=True)``),
        else the reference's non-absorbed form over the rows up-projected
        (plain PyTorch, as the pool form's).  In a sharded decode step each
        rank attends over its own slots (``sharding_hooks.cache_ops``)."""
        q_nope, q_pe, rows = self._project(x, positions)
        if (ops := cache_ops()) is not None:
            o = ops.attention(
                self.cfg, (q_nope[:, 0], q_pe[:, 0]), {"latent": rows}, positions, cache,
                impl=impl, mla=(self, absorbed),
            )
            return self._out(o[:, None])
        write_kv_cache(cache, {"latent": rows}, positions, positions[:, 0] % cache["pos"].shape[1])
        lat = view.pool(cache["latent"]).to(x.dtype)
        return self._out(self.attend_latent(q_nope, q_pe, lat, view, impl, absorbed)[:, None])

    def attend_latent(
        self, q_nope, q_pe, lat, view, impl: str, absorbed: bool, *, lse=False, w_up=None
    ):
        """Attention of ``q_nope``/``q_pe [B, 1, h, ...]`` over latent rows
        ``lat [NB, bs, r + dr]`` read through ``view`` (a ``CacheView`` or
        ``PagedKV``: ``block_table``, ``lengths``): ``[B, h, dv]``, and with
        ``lse`` each head's log-sum-exp ``[B, h]`` float32 besides.
        ``w_up``: ``(w_uk, w_uv)`` as given (a rank's whole copies), else
        the module's."""
        w_uk, w_uv = w_up or (self.w_uk, self.w_uv)
        if not absorbed:
            return self._decode_up(q_nope, q_pe, lat, view, lse=lse, w_up=(w_uk, w_uv))
        r = self.cfg.kv_lora_rank
        q_lat = torch.einsum("bhk,rhk->bhr", q_nope[:, 0], w_uk.to(q_nope.dtype))
        q = torch.cat([q_lat, q_pe[:, 0]], dim=-1).contiguous()
        kv = lat[:, :, None]  # [NB, bs, 1, r + dr]: one KV group of all the heads
        paged = ATTENTION[impl][1]
        kw = {"return_lse": True} if lse else {}
        res = paged(q, kv, kv[..., :r], view.block_table, view.lengths, scale=self.scale, **kw)
        o_lat, m = res if lse else (res, None)
        o = torch.einsum("bhr,rhk->bhk", o_lat, w_uv.to(q_nope.dtype))
        return (o, m) if lse else o

    def _decode_up(self, q_nope, q_pe, lat, view, *, lse: bool = False, w_up=None):
        """The reference's non-absorbed decode over each sequence's rows,
        gathered through ``view``'s block table: ``[B, h, dv]`` in q's dtype
        (and with ``lse`` each head's log-sum-exp, float32, -inf where no
        row is valid)."""
        B, mb = view.block_table.shape
        bs = lat.shape[1]
        tbl = view.block_table.long()
        rows = lat[tbl.clamp(min=0)].reshape(B, mb * bs, -1).to(q_nope.dtype)
        tok = torch.arange(mb * bs, device=rows.device)
        valid = (tok[None] < view.lengths[:, None].long()) & (tbl >= 0).repeat_interleave(bs, 1)
        k, v = self._up(rows, w_up)
        q = torch.cat([q_nope, q_pe], dim=-1)[:, 0]  # [B, h, dn + dr]
        s = torch.einsum("bhk,bthk->bht", q.float(), k.float()) * self.scale
        s = s.masked_fill(~valid[:, None], NEG_INF)
        w = torch.softmax(s, dim=-1)
        o = torch.einsum("bht,bthk->bhk", w.to(v.dtype).float(), v.float()).to(q.dtype)
        if not lse:
            return o
        m = torch.logsumexp(s, dim=-1)
        return o, torch.where(valid.any(-1)[:, None], m, -torch.inf)
