"""The sharded serving steps over the contiguous cache: the port's
``prefill_cache``/``decode_step_cache`` on DTensors over a ``DeviceMesh``
(the reference's jitted prefill and decode steps under the cells'
``NamedSharding``s, ``launch.specs``).

The cache is laid out by ``sharding.cache_shardings``: the batch over the
data-parallel axes and, for attention, the sequence over ``model``
(``long_500k``: over ``data`` and ``model``), as the reference's
``cache_pspecs``.  The model's parameters are laid out as a serving cell's
(``distributed.train.shard_train_state`` with ``fsdp`` where the weights
need it), and DTensor's sharding propagation places the collectives of
the products, as in the sharded train step.

Attention over a sequence-sharded cache runs as each rank's code
(``cache_attention``, a ``local_map``): the new token's K/V (MLA: latent
row) lands on the one rank that holds slot ``pos % T``, every rank attends
over its own slots through the paged kernel, which also returns each
head's log-sum-exp, and the ranks' outputs are merged by those
(``merge_lse``) over each mesh dim that splits the sequence, with the
port's collectives (``distributed.comm``).  The reference leaves the same
merge to GSPMD (its softmax reductions become all-reduces).  The prefill
writes its rows into the cache with ``copy_``, which lays them out as the
cache's leaves.
"""

from __future__ import annotations

import functools
import math

import torch
from torch.distributed.tensor import DTensor, Replicate, Shard
from torch.distributed.tensor.experimental import implicit_replication

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed import comm
from repro_torch.distributed import sharding as SH
from repro_torch.distributed.train import _plain, shard_batch
from repro_torch.models import model as M
from repro_torch.models.sharding_hooks import (
    CacheOps,
    replicated,
    set_activation_sharder,
    shard_activations,
)


def merge_lse(o: torch.Tensor, lse: torch.Tensor, group) -> tuple:
    """Attention outputs ``o [B, H, Dv]`` over disjoint sets of keys, one
    set a rank of ``group``, with each head's log-sum-exp ``lse [B, H]``
    (-inf for an empty set): the output over the union and its
    log-sum-exp, alike on every rank (an all-gather of both, then the
    weighted sum in rank order, float32)."""
    os = comm.all_gather(o.float()[None], 0, group, varying=False)
    ls = comm.all_gather(lse.float()[None], 0, group, varying=False)
    big = ls.amax(0)
    big = torch.where(torch.isfinite(big), big, 0.0)
    w = torch.exp(ls - big)  # exp(-inf) = 0 for a rank with no key
    total = w.sum(0)
    out = (w[..., None] * os).sum(0) / torch.where(total > 0, total, 1.0)[..., None]
    return out.to(o.dtype), torch.where(total > 0, big + torch.log(total), -torch.inf)


def _slots(leaf: DTensor) -> tuple:
    """Of a layer cache leaf ``[B, T, ...]``: the mesh dims that split its
    slots (dim 1), and this rank's first slot and slot count."""
    mesh = leaf.device_mesh
    seq = [i for i, p in enumerate(leaf.placements) if p.is_shard(1)]
    coord = mesh.get_coordinate()
    idx = 0
    for i in seq:  # major to minor, as DTensor splits a dim over several mesh dims
        idx = idx * mesh.size(i) + coord[i]
    Tl = leaf.shape[1] // math.prod(mesh.size(i) for i in seq)
    return seq, idx * Tl, Tl


def write_prefill(layer: dict, updates: dict, positions) -> None:
    """``attention.write_prefill`` into a layer cache of DTensors whose
    slots a mesh dim splits: each rank copies the prompt rows of its own
    slots (the prompt's rows whole on every rank, its batch rows as the
    cache's)."""
    from torch.distributed.tensor.experimental import local_map

    ref = layer["pos"]
    mesh = ref.device_mesh
    _, lo, Tl = _slots(ref)
    S, T = positions.shape[1], ref.shape[1]
    keep = min(S, T)
    names = sorted(updates) + ["pos"]
    vals = [updates[k] for k in sorted(updates)] + [positions.to(torch.int32)]
    rows = _rows(mesh, ref.placements)
    a, b = max(lo, 0), min(lo + Tl, keep)  # this rank's slots among the kept rows

    def local(vals, bufs):
        for v, buf in zip(vals, bufs):
            if b > a:
                buf[:, a - lo : b - lo] = v[:, S - keep + a : S - keep + b].to(buf.dtype)
        return torch.zeros(())  # local_map wants an output

    local_map(
        local,
        out_placements=(None,),
        in_placements=(rows,) * len(vals) + tuple(tuple(layer[k].placements) for k in names),
        device_mesh=mesh,
        redistribute_inputs=True,
    )([replicated(mesh, v) for v in vals], [layer[k] for k in names])


def _rows(mesh, placements) -> tuple:
    """Placements that keep the batch split of ``placements`` and replicate
    every other mesh dim."""
    return tuple(Shard(0) if p.is_shard(0) else Replicate() for p in placements)


def cache_attention(cfg: ModelConfig, q, new: dict, positions, cache: dict, *, impl, mla=None):
    """One decode step's attention over a layer's contiguous cache of
    DTensors (``[B, T, ...]``, the sequence split over the mesh dims that
    shard its dim 1), as each rank's code: the new rows ``new`` (``{"k",
    "v"}`` ``[B, 1, G, D]``, MLA ``{"latent"}``) written where slot ``pos %
    T`` lives, then attention over the rank's slots, then ``merge_lse``
    over the sequence's mesh dims.  ``q``: ``[B, H, D]`` (MLA: ``(q_nope,
    q_pe)``, each ``[B, h, ...]``, and ``mla = (module, absorbed)``).
    Returns ``[B, H, Dv]`` as a DTensor with the cache's batch split,
    replicated elsewhere.  A sliding window narrower than the cache is not
    split (its start would fall inside another rank's slots)."""
    from torch.distributed.tensor.experimental import local_map

    from repro_torch.models.attention import ATTENTION, CacheView

    ref = cache["pos"]
    mesh, pl = ref.device_mesh, tuple(ref.placements)
    T = ref.shape[1]
    seq, lo, Tl = _slots(ref)
    window = cfg.sliding_window
    if seq and window and T > window:
        raise NotImplementedError(
            f"a {T}-slot cache split over the sequence with a {window}-token window"
        )
    rows = _rows(mesh, pl)
    dt = functools.partial(replicated, mesh)

    names = sorted(cache)
    weights = ()
    if mla is not None:
        module, absorbed = mla
        weights = (dt(module.w_uk), dt(module.w_uv))
    qs = tuple(dt(t) for t in (q if isinstance(q, tuple) else (q,)))

    def local(qs, new, positions, leaves, weights):
        lc = dict(zip(names, leaves))
        pos = positions[:, 0].long()
        Bl = pos.shape[0]
        b = torch.arange(Bl, device=pos.device)
        slot = pos % T - lo
        mine = (slot >= 0) & (slot < Tl)
        at = slot.clamp(0, Tl - 1)
        for name, val in (*new.items(), ("pos", positions.to(torch.int32))):
            buf = lc[name]
            cur = buf[b, at]
            keep = mine.view(-1, *([1] * (cur.dim() - 1)))
            buf[b, at] = torch.where(keep, val[:, 0].to(buf.dtype), cur)
        n = (torch.clamp(pos + 1, max=T) - lo).clamp(0, Tl)
        if mla is None:
            view = CacheView.make(n - 1, Tl)
            kv = (view.pool(lc["k"]).to(qs[0].dtype), view.pool(lc["v"]).to(qs[0].dtype))
            o, lse = ATTENTION[impl][1](
                qs[0].contiguous(), *kv, view.block_table, view.lengths, window=window,
                return_lse=True,
            )
        else:
            view = CacheView.make(n - 1, Tl, latent=absorbed)
            lat = view.pool(lc["latent"]).to(qs[0].dtype)
            o, lse = module.attend_latent(
                qs[0][:, None], qs[1][:, None], lat, view, impl, absorbed, lse=True, w_up=weights
            )
        for i in seq:
            o, lse = merge_lse(o, lse, mesh.get_group(i))
        return o

    run = local_map(
        local,
        out_placements=(rows,),
        in_placements=(
            (rows,) * len(qs)
            + (rows,) * len(new)
            + (rows,)
            + tuple(tuple(cache[k].placements) for k in names)
            + ((Replicate(),) * mesh.ndim,) * len(weights)
        ),
        device_mesh=mesh,
        redistribute_inputs=True,
    )
    new = {k: dt(v) for k, v in new.items()}
    return run(qs, new, dt(positions), [cache[k] for k in names], weights)


def lookup_moves_less(table_bytes: int, rows_bytes: int, *, seq_split: bool) -> bool:
    """Whether a sharded serving step looks its tokens up vocab-parallel
    (``models.model.embed_lookup``: each rank finds the rows it holds, and
    the rows, ``rows_bytes`` of ``[B_rank, S, d]`` a rank, are summed over
    ``model``) rather than gathering the table (``table_bytes`` of ``[Vp,
    d]``, which the rules shard over the vocab only) and indexing it: the
    one that moves less over ``model``.  The rows are reduce-scattered into
    a residual split by sequence (``seq_split``, the prefill) and
    all-reduced into a whole one (the decode), twice their bytes on the
    ring; every payload moves (n - 1) / n of itself a rank, so the group's
    size cancels.  Static shapes only, so every rank chooses alike.

    On the (16, 16) mesh in bf16: a decode_32k step's rows are ``[8, 1,
    2048]``, 32 KiB, against mamba2-1.3b's 209.7 MB table (``[51200,
    2048]``) and stablelm-1.6b's 411.0 MB (``[100352, 2048]``), so decode
    looks up; a prefill_32k step's rows are ``[2, 32768, 2048]``, 268.4 MB,
    so mamba2 gathers its table and stablelm looks up.  The train step
    always looks up (``forward_train``): its lookup carries the
    deterministic backward, which the gather has not."""
    return rows_bytes * (1 if seq_split else 2) < table_bytes


def _embed(table: DTensor, tokens, *, seq_parallel: bool):
    """``CacheOps.embed``: the tokens' rows of the vocab-sharded ``table``
    laid out as the residual (``make_activation_sharder``), by the payload
    ``lookup_moves_less`` picks.  The lookup's rows come out ``Partial``
    over ``model`` and are reduced straight into that layout: a
    reduce-scatter where it splits the sequence, else an all-reduce.  The
    gathered table's rows are whole on every rank and are sliced into it
    (no collective): either way the first block takes the residual as the
    sharder lays it out, so the two payloads are all that differ."""
    B, S = tokens.shape
    mesh, d, size = table.device_mesh, table.shape[1], table.dtype.itemsize
    spec = SH.activation_spec(mesh, (B, S, d), "resid", seq_parallel=seq_parallel)
    seq_split = spec is not None and spec[1] is not None
    local = tokens.to_local() if isinstance(tokens, DTensor) else tokens
    rows_bytes = local.shape[0] * S * d * size
    if lookup_moves_less(table.numel() * size, rows_bytes, seq_split=seq_split):
        x = M.embed_lookup(table, tokens)
    else:
        x = table[tokens.long()]
    x = shard_activations(x, "resid")
    if any(p.is_partial() for p in x.placements):  # no constraint: a batch dp does not divide
        x = x.redistribute(mesh, [Replicate() if p.is_partial() else p for p in x.placements])
    return x


#: what the sharded prefill and decode steps register for the model's cache
#: layers and its embedding table
PREFILL_OPS = CacheOps(
    attention=cache_attention,
    write_prefill=write_prefill,
    embed=functools.partial(_embed, seq_parallel=True),
)
DECODE_OPS = PREFILL_OPS._replace(embed=functools.partial(_embed, seq_parallel=False))


def make_sharded_prefill(cfg: ModelConfig, mesh):
    """``prefill(model, batch, cache) -> (logits [B, 1, Vp], cache)``: the
    port's ``prefill_cache`` on a model whose parameters are DTensors,
    writing a cache of DTensors laid out by ``cache_shardings`` (in place);
    the logits come back whole on every rank."""
    sharder = SH.make_activation_sharder(mesh, seq_parallel=True)

    @torch.no_grad()
    def prefill(model, batch, cache):
        set_activation_sharder(sharder, mesh=mesh, fsdp=False, cache_ops=PREFILL_OPS)
        try:
            b = shard_batch(cfg, mesh, {"tokens": batch["tokens"]})
            with implicit_replication():
                frames = batch.get("frames")
                logits, cache = M.prefill_cache(model, b["tokens"], cache, frames=frames)
            return _plain(logits), cache
        finally:
            set_activation_sharder(None)

    return prefill


def make_sharded_decode(cfg: ModelConfig, mesh, *, mla_absorbed: bool = False):
    """``decode(model, cache, tokens, pos) -> (logits [B, 1, Vp], cache)``:
    the port's ``decode_step_cache`` on DTensor parameters and a cache laid
    out by ``cache_shardings`` (updated in place); ``tokens [B, 1]`` whole,
    ``pos`` a scalar or ``[B]``; the logits come back whole."""
    sharder = SH.make_activation_sharder(mesh, seq_parallel=False)

    @torch.no_grad()
    def decode(model, cache, tokens, pos):
        set_activation_sharder(sharder, mesh=mesh, fsdp=False, cache_ops=DECODE_OPS)
        try:
            t = shard_batch(cfg, mesh, {"tokens": tokens})["tokens"]
            with implicit_replication():
                logits, cache = M.decode_step_cache(
                    model, cache, t, pos, mla_absorbed=mla_absorbed
                )
            return _plain(logits), cache
        finally:
            set_activation_sharder(None)

    return decode


def shard_cache(cfg: ModelConfig, mesh, shape, cache: dict, batch: int, length: int) -> dict:
    """A whole cache tree (``models.model.init_cache(cfg, batch, length)``,
    every rank holding the same values) laid out by
    ``sharding.cache_shardings`` for the cell ``shape`` (a ``ShapeConfig``)."""
    from torch.distributed.tensor import distribute_tensor

    def walk(node, s):
        if isinstance(node, dict):
            return {k: walk(node[k], s[k]) for k in node}
        return distribute_tensor(node, mesh, s.placements)

    return walk(cache, SH.cache_shardings(cfg, mesh, shape, batch, length))
