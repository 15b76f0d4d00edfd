"""Batched serving engine: continuous batching with QoS-isolated KV blocks.

The reference's ``serving/engine.py`` with its API, admission, round-robin
slot filling, decode cadence and free rules.  Where the reference keeps a
dense per-slot cache and leaves the pool to decide placement and ownership
only, here the KV bytes live where the pool places them: the TPU-target
layout that the reference's ``paged_attention`` and ``banked_copy`` kernels
define.

Device KV store: one tensor ``kv [NB, bs, W]`` holding, for each pool block
and each of its ``bs`` token rows, every layer's cache of that token, laid
out as the model says (``Transformer.kv_row_shape``): for GQA every layer's K
and V (``W = L * 2 * G * D``, viewed ``[NB, bs, L, 2, G, D]``), for MLA every
layer's latent row ``[c_kv | k_pe]`` (``W = L * (kv_lora_rank +
qk_rope_dim)``, viewed ``[NB, bs, L, 576]`` at deepseek-v2's width).  A block
is thus one contiguous tile, the unit ``banked_copy`` moves, and one layer's
K (or V, or latent rows) of the pool is a strided view that paged attention
reads.

  * admission: prefill at B=1 writes the prompt's fresh K/V into a staging
    burst ``[1, nblk, bs, W]`` (the reference's temporary cache), and one
    ``banked_copy`` launch scatters it to the request's first ``nblk`` blocks
    (the reference's splice into the slot).
  * decode: each active slot's new K/V row goes to block ``tbl[pos // bs]``,
    row ``pos % bs``, by an indexed write; paged attention then reads tokens
    ``0 .. pos`` through the table.  Idle slots have an all -1 table row and
    length 0.  MLA decodes in the absorbed form (``decode_step(...,
    mla_absorbed=True)``), where the reference's engine takes the
    non-absorbed one: only the absorbed form reads the pool's latent rows as
    they are stored (``w_uk`` folded into q, ``w_uv`` into the output), where
    the other would up-project every slot's whole cache to per-head K and V
    at every step.  Both forms are the reference's and compute the same
    function; ``tests/test_torch_model_mla.py`` holds each to it.

A sliding-window model (h2o-danube) keeps every block of a request in the
pool, where the reference rolls a cache of ``window`` slots; the paged
kernel masks the rows before ``pos - window + 1`` (``models.attention``), so
the tokens are the reference's.  An SSM model (mamba2) keeps no KV rows: the
engine holds each slot's SSM state and conv window (``models.ssm.SSMCache``,
``[L, max_batch, ...]``) beside the pool, prefill at B = 1 writes the slot's
state (from zero, as the reference's fresh cache) and each decode step
updates every slot's in place (idle slots step theirs on token 0, as the
reference's batched decode does, and are zeroed at their next admission);
there is no ``banked_copy`` launch.  A hybrid model (jamba) keeps both: KV
rows in the pool for its attention layers only (``W = nb * 2 * G * D``,
one attention layer a super-block; prefill through flash and
``banked_copy``, decode through paged attention) and each slot's SSM state
beside it (``[nb, P - 1, max_batch, ...]``, batch on axis 2 as the
reference's hybrid cache).  An encoder-decoder model (whisper) keeps its
decoder's self-attention K/V in the pool as a GQA stack does and each
slot's cross-attention K/V beside it (``models.attention.CrossKV``: the
reference's ``ck``/``cv``, ``nb = ceil(T_enc / bs)`` blocks of its own a
slot): each admission encodes zero frames ``[1, T_enc, d]`` (the
reference's engine feeds no audio: ``engine.py``'s zeros), and its prefill
writes the slot's cross rows there, while ``banked_copy`` scatters the
prompt's self K/V into the pool; each decode step then reads both, the
pool and the cross buffer, through the paged kernel, every layer.  The
pool still allocates and frees blocks per request whatever the family, as
the reference's does, so the KV access record is the reference's.

Tokens, slot assignment, block placement and step count equal the
reference's.  Greedy argmax runs over the padded vocabulary, as there.
``params=None`` runs the engine traffic-only: the same control flow with no
model and no device.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.banked_copy.ops import banked_copy
from repro_torch.kernels.banked_copy.ref import banked_copy_ref
from repro_torch.models import model as M
from repro_torch.serving.pool import BankedKVPool

#: the pool copy per attention implementation (see ``models.attention``)
BANKED_COPY = {"kernel": banked_copy, "ref": banked_copy_ref}


@dataclass
class Request:
    rid: int
    prompt: np.ndarray  # [S] int32
    max_new_tokens: int = 16
    out_tokens: List[int] = field(default_factory=list)
    done: bool = False


@dataclass
class EngineStats:
    """Counts and host seconds of the engine's two kinds of device work.
    Each prefill and each decode step ends in a host read of the picked
    tokens, so the seconds include the device's time."""

    admissions: int = 0
    decode_steps: int = 0
    prefill_tokens: int = 0
    decode_tokens: int = 0
    prefill_s: float = 0.0
    decode_s: float = 0.0


class ServingEngine:
    """``params`` is the port's :class:`~repro_torch.models.model.Transformer`
    (its device is the engine's), or None for a traffic-only run.  Attach a
    :class:`~repro_torch.serving.record.KVAccessRecorder` with ``recorder=``
    to capture the KV access stream for the fabric co-sim; it is the same
    stream either way, since no control decision reads a logit."""

    def __init__(
        self,
        cfg: Optional[ModelConfig],
        params: Optional[M.Transformer],
        *,
        max_batch: int = 4,
        max_len: int = 128,
        block_size: int = 16,
        greedy: bool = True,
        recorder=None,
    ):
        if not greedy:
            raise NotImplementedError("the engine decodes greedily, as the reference's does")
        if params is not None and params.cfg != cfg:
            raise ValueError(f"params were built for {params.cfg.name}, not {cfg.name}")
        self.cfg = cfg
        self.params = params
        self.max_batch = max_batch
        self.max_len = max_len
        self.block_size = block_size
        self.recorder = recorder
        nblocks = max(1, max_batch * max_len // block_size * 2)
        nblocks = -(-nblocks // 8) * 8  # round to a bank multiple
        self.pool = BankedKVPool(
            num_blocks=nblocks, block_size=block_size, num_banks=8, recorder=recorder
        )
        if recorder is not None:
            recorder.bind_pool(nblocks, block_size, self.pool.num_banks, max_batch)
        self.table_width = -(-max_len // block_size)  # blocks a slot can reach
        self.slot_req: List[Optional[Request]] = [None] * max_batch
        self.slot_pos = np.zeros(max_batch, np.int64)
        self.queue: List[Request] = []
        self._rr = 0
        self._next_rid = 0
        self.steps = 0
        self.stats = EngineStats()
        self.kv = self.ssm = self.cross = None
        if params is None:  # traffic-only: no device store
            return
        if cfg.family in ("ssm", "hybrid"):  # per-slot recurrent state beside the pool
            self.ssm = params.init_ssm_cache(max_batch)
        if cfg.is_encoder_decoder:  # per-slot cross K/V beside the pool
            self.cross = params.init_cross_kv(max_batch, block_size)
        if not cfg.num_attn_layers:  # an SSM stack keeps no KV rows
            return
        self.kv = torch.zeros(
            (nblocks, block_size, params.kv_width()), dtype=params.kv_dtype, device=params.device
        )
        self.kv_layers = self.kv.view(nblocks, block_size, *params.kv_row_shape())

    # ---- API ----
    def submit(self, prompt: np.ndarray, max_new_tokens: int = 16) -> Request:
        prompt = np.asarray(prompt)
        if not 1 <= len(prompt) < self.max_len:
            raise ValueError(
                f"prompt of {len(prompt)} tokens; the engine takes 1..{self.max_len - 1}"
            )
        r = Request(rid=1000 + self._next_rid, prompt=prompt, max_new_tokens=max_new_tokens)
        self._next_rid += 1
        self.queue.append(r)
        return r

    def _admit(self) -> None:
        """Deterministic round-robin slot filling."""
        for i in range(self.max_batch):
            slot = (self._rr + i) % self.max_batch
            if self.slot_req[slot] is not None or not self.queue:
                continue
            r = self.queue.pop(0)
            n_blocks = -(-(len(r.prompt) + r.max_new_tokens) // self.block_size)
            blocks = self.pool.alloc(r.rid, n_blocks)
            if blocks is None:  # pool exhausted: retry next round
                self.queue.insert(0, r)
                break
            self._prefill_into_slot(slot, r)
        self._rr = (self._rr + 1) % self.max_batch

    def _pick(self, reqs: List[Request], logits: torch.Tensor) -> List[int]:
        """Next token of each request from its logits row ``[n, Vp]``:
        greedy argmax over the padded vocabulary, as the reference."""
        return torch.argmax(logits, dim=-1).tolist()

    def _device(self, a) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a), device=self.params.device)

    def _prefill_into_slot(self, slot: int, r: Request) -> None:
        S = len(r.prompt)
        self.stats.admissions += 1
        self.stats.prefill_tokens += S
        if self.params is None:  # traffic-only: control flow without math
            r.out_tokens.append(0)
            self.slot_req[slot] = r
            self.slot_pos[slot] = S
            self._record_prefill(slot, r)
            return
        t0 = time.perf_counter()
        model, bs = self.params, self.block_size
        tokens = self._device(r.prompt.astype(np.int64))[None]
        state = None
        if self.ssm is not None:  # from a zero state, as the reference's fresh cache
            state = self.ssm.slot(slot)
            state.ssm.zero_()
            state.conv.zero_()
        if self.kv is None:
            logits = M.prefill(model, tokens, ssm_out=state)
            self._admitted(slot, r, logits, t0)
            return
        nblk = -(-S // bs)
        burst = self.kv.new_zeros((1, nblk, bs, self.kv.shape[2]))
        kv_out = burst.view(1, nblk * bs, *self.kv_layers.shape[2:])[:, :S]
        kw = {}
        if self.cross is not None:  # zero frames, as the reference's engine
            cfg = self.cfg
            frames = torch.zeros((1, cfg.encoder_seq_len, cfg.d_model), device=model.device)
            kw = dict(frames=frames, cross_out=self.cross.slot(slot))
        logits = M.prefill(model, tokens, kv_out, ssm_out=state, **kw)
        table = self._device(np.asarray([self.pool.by_request[r.rid][:nblk]], np.int32))
        BANKED_COPY[model.impl](self.kv, burst, table)
        self._admitted(slot, r, logits, t0)

    def _admitted(self, slot: int, r: Request, logits: torch.Tensor, t0: float) -> None:
        r.out_tokens.append(self._pick([r], logits[:, -1])[0])
        self.slot_req[slot] = r
        self.slot_pos[slot] = len(r.prompt)
        self.stats.prefill_s += time.perf_counter() - t0
        self._record_prefill(slot, r)

    def _record_prefill(self, slot: int, r: Request) -> None:
        if self.recorder is not None:
            self.recorder.on_prefill(slot, r.rid, len(r.prompt), self.pool.by_request[r.rid])

    def _decode(self, active: List[int]) -> List[int]:
        """One batched decode step over every slot; returns the active
        slots' next tokens."""
        model, bs, B = self.params, self.block_size, self.max_batch
        toks = np.zeros((B, 1), np.int64)
        if self.kv is None:  # every slot steps its state; idle slots read token 0
            for i in active:
                toks[i, 0] = self.slot_req[i].out_tokens[-1]
            logits = M.decode_step(model, self._device(toks), None, self.ssm)  # no position
            return self._pick([self.slot_req[i] for i in active], logits[active, 0])
        table = np.full((B, self.table_width), -1, np.int32)
        lengths = np.zeros(B, np.int32)
        write = np.zeros((3, len(active)), np.int64)  # slot, block, row
        for n, i in enumerate(active):
            r = self.slot_req[i]
            blocks = self.pool.by_request[r.rid][: self.table_width]
            pos = int(self.slot_pos[i])
            toks[i, 0] = r.out_tokens[-1]
            table[i, : len(blocks)] = blocks
            lengths[i] = pos + 1
            write[:, n] = (i, blocks[pos // bs], pos % bs)
        w = self._device(write)
        cache = M.PagedKV(
            self.kv_layers, self._device(table), self._device(lengths), w[0], w[1], w[2]
        )
        logits = M.decode_step(
            model,
            self._device(toks),
            self._device(self.slot_pos),
            cache,
            self.ssm,
            cross=self.cross,
            mla_absorbed=True,
        )
        return self._pick([self.slot_req[i] for i in active], logits[active, 0])

    def step(self) -> int:
        """One engine iteration: admit + one batched decode step.
        Returns the number of active slots."""
        if self.recorder is not None:
            self.recorder.step = self.steps
        self._admit()
        active = [i for i, r in enumerate(self.slot_req) if r is not None]
        if not active:
            self.steps += 1
            if self.recorder is not None:
                self.recorder.end_step()
            return 0
        if self.recorder is not None:  # the full allocation, not the table's slice
            for i in active:
                r = self.slot_req[i]
                self.recorder.on_decode(
                    i, r.rid, int(self.slot_pos[i]), self.pool.by_request[r.rid]
                )
        t0 = time.perf_counter()
        if self.params is None:  # traffic-only decode: cadence only
            nxt = [0] * len(active)
        else:
            nxt = self._decode(active)
            self.stats.decode_s += time.perf_counter() - t0
        self.stats.decode_steps += 1
        self.stats.decode_tokens += len(active)
        for i, tok in zip(active, nxt):
            r = self.slot_req[i]
            r.out_tokens.append(int(tok))
            self.slot_pos[i] += 1
            if len(r.out_tokens) >= r.max_new_tokens or self.slot_pos[i] >= self.max_len - 1:
                r.done = True
                self.pool.free(r.rid)
                self.slot_req[i] = None
        if not self.pool.check_isolation():
            raise RuntimeError("KV block isolation violated")
        self.steps += 1
        if self.recorder is not None:
            self.recorder.end_step()
        return len(active)

    def run(self, max_steps: int = 1000) -> None:
        for _ in range(max_steps):
            if not self.queue and all(r is None for r in self.slot_req):
                break
            self.step()
