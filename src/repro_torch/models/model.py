"""Model stacks of the port: the reference's ``models/model.py`` for
uniform GQA or MLA architectures, dense or with an MoE FFN on every layer,
with or without a sliding window, for uniform SSM stacks (mamba2), for
hybrid stacks of super-blocks (jamba) and for encoder-decoder stacks
(whisper).

Public API (each mirrors the reference's function of the same name):
  param_specs(cfg)                         -> ParamSpec tree (layers stacked [L, ...])
  init_params(cfg, seed, device=...)       -> Transformer with seeded random weights
  prefill(model, tokens, kv_out, ssm_out=None, frames=, cross_out=) -> logits [B, 1, Vp]
  decode_step(model, tokens, pos, cache, ssm_cache=None, cross=, mla_absorbed=) -> [B, 1, Vp]
  forward_train(model, tokens, frames=None, remat_policy=...) -> (logits [B, S, Vp], aux)
  init_cache(cfg, batch, cache_len, dtype=bf16, device=...) -> the contiguous cache tree
  cache_length(cfg, seq_len)               -> slots a sequence's cache takes (a window rolls)
  prefill_cache(model, tokens, cache, frames=) -> (logits [B, 1, Vp], cache)
  decode_step_cache(model, cache, tokens, pos, mla_absorbed=) -> (logits [B, 1, Vp], cache)

``prefill``/``decode_step`` are the serving engine's pool form: K/V rows in
the banked pool (``serving.pool``), read through block tables.  The
reference's ``prefill``/``decode_step`` over its contiguous cache (``k``/
``v [L, B, T, G, D]``, ``pos`` -1 for an empty slot, written at ``pos %
T``) are ``prefill_cache``/``decode_step_cache``: names of their own, as
the pool form holds the reference's names.  Their decode attention runs on
the same paged kernel, each sequence's ``T`` slots read as consecutive
blocks (``attention.CacheView``); MLA's cache keeps ``c_kv`` and ``k_pe``
in one row (``attention.init_mla_cache``).

The stack is a ``ModuleList`` of blocks run in a Python loop (the reference
scans stacked params).  Weight matrices and the embedding are stored in the
compute dtype, cast once at load where the reference casts per einsum; norm
scales and biases stay float32, as the reference's norms read them.  The KV
dtype is bfloat16 by default, the reference's cache dtype.  A layer holds
``"moe"`` in place of ``"ffn"`` where ``cfg.is_moe_layer(0)``, as the
reference's ``_ffn_layer_specs``; its ``aux`` loss is dropped (serving).
An MLA config (``cfg.use_mla``, deepseek-v2) holds ``mla_specs`` under
``"attn"`` and stores one latent row per token and layer in the pool
(``kv_row_shape``); it trains as GQA does, through ``MLAAttention.forward_train``.
A sliding window (``cfg.sliding_window``, h2o-danube) reaches every
attention call (``models.attention``).  An SSM stack (family ``ssm``) holds
``mixer_norm`` and ``ssm`` per layer and no FFN, as the reference's
``_uniform_layer_specs``; it keeps no KV rows (``kv_row_shape`` is ``(0,)``)
and its state is an ``SSMCache`` (``models.ssm``) that ``prefill`` writes
(``ssm_out``) and ``decode_step`` updates in place.  A hybrid stack (family
``hybrid``, jamba) is ``num_layers / attn_layer_period`` super-blocks
(``HybridBlock``, the reference's ``_jamba_block``): attention at position
0, SSM at the others, a dense FFN at even positions and MoE at odd ones;
its tree is the reference's, ``layers.attn`` leaves ``[nb, ...]`` and
``layers.mamba``/``dense``/``moe`` leaves ``[nb, k, ...]``; its pool rows
hold the ``nb`` attention layers' K and V, and its SSM state is an
``SSMCache`` of ``[nb, P - 1, B, ...]`` (batch on axis 2, as the
reference's), passed to ``prefill`` as ``ssm_out`` and to ``decode_step``
as ``ssm_cache`` beside the pool.  Tied embeddings (``cfg.tie_embeddings``,
mamba2) keep no ``lm_head``: the logits are ``x @ embed.T``, as the
reference's ``_logits``.  An encoder-decoder stack (whisper) adds an
``Encoder`` (``encoder.layers`` stacked ``[Le, ...]``: non-causal
self-attention over ``encoder_seq_len`` frames and a GELU FFN, then
``encoder.final_norm``; the reference's ``_whisper_encode``) and gives each
decoder layer ``cross_norm`` and ``cross`` (``CrossAttention``) between its
self-attention and its FFN (the reference's ``_encdec_layer``); neither
side rotates q and k, and the decoder's embedding adds the sin/cos table
at each token's absolute position.  ``prefill`` encodes ``frames`` and
writes the cross K/V to ``cross_out``; ``decode_step`` reads them from a
``CrossKV`` beside the pool.  What the port does not carry raises
``NotImplementedError`` (``configs.base.check_supported``).

Training takes a model built with ``param_dtype`` (float32, the reference's
master parameters): every parameter is stored in that dtype with
``requires_grad``, and each use casts it to the compute dtype, as the
reference's ``p[...].astype(x.dtype)``.  ``forward_train`` runs the stack
under the reference's remat policies: ``"full"`` checkpoints each layer
(``torch.utils.checkpoint``, non-reentrant, nothing saved), ``"minimal"``
saves the layer's weight-matrix products (``aten.mm``: the reference's
``dots_with_no_batch_dims_saveable``) and recomputes the rest, ``"none"``
saves everything; the three give the same values.  A hybrid stack
checkpoints each mixer and each FFN of a super-block on its own, nothing
saved, under ``"minimal"`` and ``"full"`` alike (the reference's
``remat_positions``).  The embedding's backward adds the rows of repeated
tokens in a fixed order (``embed_lookup``), so that two runs of a step agree
to the bit.
"""

from __future__ import annotations

import contextlib
import functools
import math
from typing import Any, Mapping, Optional

import numpy as np
import torch
import torch.utils.checkpoint as ckpt
from torch.distributed.tensor import DTensor

from repro_torch.configs.base import ModelConfig, check_supported
from repro_torch.models.attention import (
    ATTENTION,
    CacheView,
    CrossAttention,
    CrossKV,
    GQAAttention,
    MLAAttention,
    PagedKV,
    gqa_specs,
    init_gqa_cache,
    init_mla_cache,
    mla_specs,
)
from repro_torch.models.layers import (
    Norm,
    ParamSpec,
    init_leaf,
    iter_specs,
    leaf_seed,
    norm_spec,
    sinusoidal_at,
    sinusoidal_positions,
)
from repro_torch.models.mlp import MLP, mlp_specs
from repro_torch.models.moe import MoE, moe_specs
from repro_torch.models.sharding_hooks import gather_sequence, shard_activations
from repro_torch.models.ssm import SSMBlock, SSMCache, init_ssm_cache, ssm_specs


def _attn_layer_specs(cfg: ModelConfig, cross: bool = False) -> dict:
    spec = {
        "attn_norm": norm_spec(cfg, cfg.d_model),
        "attn": mla_specs(cfg) if cfg.use_mla else gqa_specs(cfg),
    }
    if cross:
        spec["cross_norm"] = norm_spec(cfg, cfg.d_model)
        spec["cross"] = gqa_specs(cfg)
    return spec


def _ffn_layer_specs(cfg: ModelConfig, moe: bool) -> dict:
    if moe:
        return {"ffn_norm": norm_spec(cfg, cfg.d_model), "moe": moe_specs(cfg)}
    return {"ffn_norm": norm_spec(cfg, cfg.d_model), "ffn": mlp_specs(cfg, cfg.d_ff)}


def _ssm_layer_specs(cfg: ModelConfig) -> dict:
    return {"mixer_norm": norm_spec(cfg, cfg.d_model), "ssm": ssm_specs(cfg)}


def _hybrid_block_specs(cfg: ModelConfig) -> dict:
    """One super-block (the reference's ``_jamba_block_specs``): attention
    at position 0, SSM at 1 .. P - 1, a dense FFN at even positions and MoE
    at odd ones, each kind stacked over its positions."""
    P = cfg.attn_layer_period
    n_moe = P // 2
    return {
        "attn": _attn_layer_specs(cfg),
        "mamba": _stack(_ssm_layer_specs(cfg), P - 1),
        "dense": _stack(_ffn_layer_specs(cfg, moe=False), P - n_moe),
        "moe": _stack(_ffn_layer_specs(cfg, moe=True), n_moe),
    }


def param_specs(cfg: ModelConfig) -> dict:
    check_supported(cfg)
    d, Vp = cfg.d_model, cfg.padded_vocab
    specs = {
        "embed": ParamSpec((Vp, d), ("vocab", "embed_table"), stddev=0.02),
        "final_norm": norm_spec(cfg, d),
    }
    if not cfg.tie_embeddings:
        specs["lm_head"] = ParamSpec((d, Vp), ("embed", "vocab"), init="fan_in")
    if cfg.is_encoder_decoder:
        enc_layer = {
            "attn_norm": norm_spec(cfg, d),
            "attn": gqa_specs(cfg),
            "ffn_norm": norm_spec(cfg, d),
            "ffn": mlp_specs(cfg, cfg.d_ff),
        }
        specs["encoder"] = {
            "layers": _stack(enc_layer, cfg.num_encoder_layers),
            "final_norm": norm_spec(cfg, d),
        }
    if cfg.family == "hybrid":
        nb = cfg.num_layers // cfg.attn_layer_period
        specs["layers"] = _stack(_hybrid_block_specs(cfg), nb)
    elif cfg.family == "ssm":
        specs["layers"] = _stack(_ssm_layer_specs(cfg), cfg.num_layers)
    else:
        layer = _attn_layer_specs(cfg, cross=cfg.is_encoder_decoder)
        layer.update(_ffn_layer_specs(cfg, moe=cfg.is_moe_layer(0)))
        specs["layers"] = _stack(layer, cfg.num_layers)
    return specs


def is_stacked(keys) -> bool:
    """Whether the leaf at ``keys`` is stacked over layers: the decoder's
    ``layers`` and an encoder-decoder stack's ``encoder.layers``."""
    return keys[0] == "layers" or tuple(keys[:2]) == ("encoder", "layers")


def _stack(tree: dict, n: int) -> dict:
    return {
        k: v.stacked(n) if isinstance(v, ParamSpec) else _stack(v, n) for k, v in tree.items()
    }


class SSMLayer(torch.nn.Module):
    """One layer of an SSM stack: ``x + ssm(mixer_norm(x))``, no FFN."""

    def __init__(self, cfg: ModelConfig, dtype: torch.dtype):
        super().__init__()
        self.mixer_norm = Norm(cfg, cfg.d_model)
        self.ssm = SSMBlock(cfg, dtype)

    def forward(self, x, cache: Optional[SSMCache] = None, *, decode: bool = False):
        h = shard_activations(self.mixer_norm(x), "resid")
        return x + self.ssm(h, cache, decode=decode)


class AttnLayer(torch.nn.Module):
    """A hybrid stack's attention position: ``x + attn(attn_norm(x))``."""

    def __init__(self, cfg: ModelConfig, dtype: torch.dtype):
        super().__init__()
        self.attn_norm = Norm(cfg, cfg.d_model)
        self.attn = (MLAAttention if cfg.use_mla else GQAAttention)(cfg, dtype)

    def prefill(self, x, positions, kv_out, *, kv_dtype, impl: str, cache=None):
        h = shard_activations(self.attn_norm(x), "resid")
        return x + self.attn.prefill(
            h, positions, kv_out, kv_dtype=kv_dtype, impl=impl, cache=cache
        )

    def forward_train(self, x, positions, *, impl: str):
        h = shard_activations(self.attn_norm(x), "resid")
        return x + self.attn.forward_train(h, positions, impl=impl)


class FFNLayer(torch.nn.Module):
    """A hybrid stack's FFN position, dense or MoE: ``(x + out, aux)``, aux
    float32 (0 for a dense FFN), as the reference's ``_apply_ffn``."""

    def __init__(self, cfg: ModelConfig, dtype: torch.dtype, *, moe: bool):
        super().__init__()
        self.ffn_norm = Norm(cfg, cfg.d_model)
        self.is_moe = moe
        if moe:
            self.moe = MoE(cfg, dtype)
        else:
            self.ffn = MLP(cfg, cfg.d_ff, dtype)

    def forward(self, x: torch.Tensor):
        h = shard_activations(self.ffn_norm(x), "resid")
        if self.is_moe:
            out, aux = self.moe.forward_aux(h)
        else:
            out, aux = self.ffn(h), torch.zeros((), device=x.device)
        return x + out, aux


class HybridBlock(torch.nn.Module):
    """One super-block of a hybrid stack (the reference's ``_jamba_block``):
    at each of its ``P = attn_layer_period`` positions a mixer (attention at
    position 0, SSM layer ``pos - 1`` elsewhere), then an FFN (dense layer
    ``pos // 2`` at even positions, MoE layer ``pos // 2`` at odd ones).
    Its modules mirror the parameter tree: ``attn``, and ``mamba``,
    ``dense`` and ``moe`` lists of the layers stacked ``[nb, k, ...]``."""

    def __init__(self, cfg: ModelConfig, dtype: torch.dtype):
        super().__init__()
        P = cfg.attn_layer_period
        self.attn = AttnLayer(cfg, dtype)
        self.mamba = torch.nn.ModuleList(SSMLayer(cfg, dtype) for _ in range(P - 1))
        self.dense = torch.nn.ModuleList(
            FFNLayer(cfg, dtype, moe=False) for _ in range(P - P // 2)
        )
        self.moe = torch.nn.ModuleList(FFNLayer(cfg, dtype, moe=True) for _ in range(P // 2))

    def positions(self):
        """``(pos, mixer, ffn)`` for each position of the super-block."""
        for pos in range(len(self.mamba) + 1):
            mixer = self.attn if pos == 0 else self.mamba[pos - 1]
            ffn = (self.dense if pos % 2 == 0 else self.moe)[pos // 2]
            yield pos, mixer, ffn


class EncoderLayer(torch.nn.Module):
    """One layer of whisper's encoder (the reference's ``_whisper_encode``
    scan body): ``x + attn(attn_norm(x))`` non-causal and unrotated, then
    ``x + ffn(ffn_norm(x))``."""

    def __init__(self, cfg: ModelConfig, dtype: torch.dtype):
        super().__init__()
        self.attn_norm = Norm(cfg, cfg.d_model)
        self.attn = GQAAttention(cfg, dtype, causal=False)
        self.ffn_norm = Norm(cfg, cfg.d_model)
        self.ffn = MLP(cfg, cfg.d_ff, dtype)

    def forward(self, x, positions, impl: str, train: bool = False):
        h = self.attn_norm(x)
        x = x + (self.attn.forward_train if train else self.attn)(h, positions, impl=impl)
        return x + self.ffn(self.ffn_norm(x))


class Encoder(torch.nn.Module):
    """Whisper's encoder: frames plus the sin/cos table, the layers, the
    final norm (``encoder.layers`` stacked ``[Le, ...]``, ``encoder.final_norm``)."""

    def __init__(self, cfg: ModelConfig, dtype: torch.dtype):
        super().__init__()
        self.layers = torch.nn.ModuleList(
            EncoderLayer(cfg, dtype) for _ in range(cfg.num_encoder_layers)
        )
        self.final_norm = Norm(cfg, cfg.d_model)


class Block(torch.nn.Module):
    """One layer of a uniform stack: attention, then (whisper's decoder)
    cross-attention over the encoder's output, then the FFN."""

    def __init__(self, cfg: ModelConfig, dtype: torch.dtype):
        super().__init__()
        self.attn_norm = Norm(cfg, cfg.d_model)
        self.attn = (MLAAttention if cfg.use_mla else GQAAttention)(cfg, dtype)
        self.cross = None
        if cfg.is_encoder_decoder:
            self.cross_norm = Norm(cfg, cfg.d_model)
            self.cross = CrossAttention(cfg, dtype)
        self.ffn_norm = Norm(cfg, cfg.d_model)
        self.is_moe = cfg.is_moe_layer(0)
        if self.is_moe:
            self.moe = MoE(cfg, dtype)
        else:
            self.ffn = MLP(cfg, cfg.d_ff, dtype)

    def feed_forward(self, x: torch.Tensor) -> torch.Tensor:
        """The FFN sub-layer's residual branch (dense MLP or MoE)."""
        h = shard_activations(self.ffn_norm(x), "resid")
        return self.moe(h) if self.is_moe else self.ffn(h)

    def train_layer(self, x, positions, impl: str, encoder_out=None):
        """One layer of the training forward: ``(x, aux)``, aux float32 (0
        for a dense FFN, as the reference's ``_apply_ffn``); whisper's
        decoder attends to ``encoder_out`` after its self-attention."""
        h = shard_activations(self.attn_norm(x), "resid")
        x = x + self.attn.forward_train(h, positions, impl=impl)
        if self.cross is not None:
            x = x + self.cross.forward_train(self.cross_norm(x), encoder_out, impl=impl)
        h = shard_activations(self.ffn_norm(x), "resid")
        if self.is_moe:
            out, aux = self.moe.forward_aux(h)
        else:
            out, aux = self.ffn(h), torch.zeros((), device=x.device)
        return shard_activations(x + out, "resid"), aux


class Transformer(torch.nn.Module):
    """The decoder stack.  ``impl`` picks the attention functions: ``"kernel"``
    (the wrappers: the Hopper kernels on CUDA tensors, their plain versions
    on CPU tensors) or ``"ref"`` (the plain versions on any device).
    ``param_dtype`` (None: serving) makes a training model: parameters in
    that dtype with ``requires_grad``, cast to ``compute_dtype`` per use."""

    def __init__(
        self,
        cfg: ModelConfig,
        *,
        compute_dtype: torch.dtype = torch.bfloat16,
        kv_dtype: torch.dtype = torch.bfloat16,
        impl: str = "kernel",
        param_dtype: Optional[torch.dtype] = None,
    ):
        super().__init__()
        check_supported(cfg)
        if impl not in ATTENTION:
            raise ValueError(f"impl must be one of {sorted(ATTENTION)}; got {impl!r}")
        self.cfg = cfg
        self.kv_dtype = kv_dtype
        self.impl = impl
        self.compute_dtype = compute_dtype
        wdt = param_dtype or compute_dtype
        d, Vp = cfg.d_model, cfg.padded_vocab
        self.embed = torch.nn.Parameter(torch.empty(Vp, d, dtype=wdt), False)
        self.final_norm = Norm(cfg, d)
        self.lm_head = None  # tied: the logits read ``embed``
        if not cfg.tie_embeddings:
            self.lm_head = torch.nn.Parameter(torch.empty(d, Vp, dtype=wdt), False)
        self.encoder = Encoder(cfg, wdt) if cfg.is_encoder_decoder else None
        layer_cls = {"ssm": SSMLayer, "hybrid": HybridBlock}.get(cfg.family, Block)
        n = cfg.num_layers // (cfg.attn_layer_period if cfg.family == "hybrid" else 1)
        self.layers = torch.nn.ModuleList(layer_cls(cfg, wdt) for _ in range(n))
        if param_dtype is not None:
            for p in self.parameters():
                p.requires_grad_(True)

    @property
    def device(self) -> torch.device:
        return self.embed.device

    def kv_row_shape(self) -> tuple:
        """How the engine views one token's pool row: ``(La, 2, G, D)``,
        every attention layer's K and V, for GQA; ``(La, kv_lora_rank +
        qk_rope_dim)``, every layer's latent row, for MLA; ``(0,)`` for an
        SSM stack, which keeps no KV rows.  ``La`` counts the attention
        layers only (a hybrid stack's one a super-block)."""
        cfg, La = self.cfg, self.cfg.num_attn_layers
        if not La:
            return (0,)
        if cfg.use_mla:
            return (La, cfg.latent_dim)
        return (La, 2, cfg.num_kv_heads, cfg.resolved_head_dim)

    def kv_width(self) -> int:
        """Elements of one token's cache across every layer (a pool row)."""
        return math.prod(self.kv_row_shape())

    def stacked(self, keys) -> list:
        """``(index, parameter)`` for every slice of the stacked layer leaf
        at ``keys`` (``("layers", ...)``, or ``("encoder", "layers", ...)``
        for whisper's encoder): index ``(i,)`` for layer ``i`` of a uniform
        stack or of the encoder; in a hybrid stack ``(b,)`` for block
        ``b``'s attention leaves and ``(b, j)`` for its ``j``-th SSM, dense
        or MoE layer's (leaves stacked ``[nb, k, ...]``)."""
        if keys[0] == "encoder":
            return [((i,), _param(m, keys[2:])) for i, m in enumerate(self.encoder.layers)]
        out = []
        for i, layer in enumerate(self.layers):
            sub = getattr(layer, keys[1])
            if isinstance(sub, torch.nn.ModuleList):
                out += [((i, j), _param(m, keys[2:])) for j, m in enumerate(sub)]
            else:
                out.append(((i,), _param(layer, keys[1:])))
        return out

    def load_tree(self, tree: Mapping[str, Any]) -> "Transformer":
        """Copy a parameter tree laid out as ``param_specs`` (the reference's
        tree: nested dicts, layer leaves stacked ``[L, ...]``, a hybrid
        stack's ``[nb, ...]`` and ``[nb, k, ...]``, array-likes) into the
        modules, casting each leaf to its parameter's dtype."""
        for keys, spec in iter_specs(param_specs(self.cfg)):
            leaf = tree
            for k in keys:
                leaf = leaf[k]
            self._assign(keys, leaf, spec)
        return self

    def state_tree(self) -> dict:
        """The parameters as a float32 numpy tree laid out as ``param_specs``
        (the inverse of ``load_tree``)."""
        tree: dict = {}
        for keys, spec in iter_specs(param_specs(self.cfg)):
            if is_stacked(keys):
                val = torch.stack([p for _, p in self.stacked(keys)]).reshape(spec.shape)
            else:
                val = _param(self, keys)
            node = tree
            for k in keys[:-1]:
                node = node.setdefault(k, {})
            node[keys[-1]] = val.float().cpu().numpy()
        return tree

    @torch.no_grad()
    def _assign(self, keys, value, spec: ParamSpec) -> None:
        value = value if torch.is_tensor(value) else torch.from_numpy(np.array(value))
        if tuple(value.shape) != spec.shape:
            raise ValueError(f"{keys}: shape {tuple(value.shape)}, expected {spec.shape}")
        if is_stacked(keys):
            for idx, p in self.stacked(keys):
                p.copy_(value[idx])
        else:
            _param(self, keys).copy_(value)

    def _embed(self, tokens: torch.Tensor, positions=None) -> torch.Tensor:
        """Token rows; whisper's decoder adds the sin/cos table at the
        tokens' absolute ``positions`` (the reference's ``_embed_tokens``)."""
        x = self.embed[tokens.long()]
        return x if self.encoder is None else self._add_sinusoid(x, positions)

    def _add_sinusoid(self, x: torch.Tensor, positions: torch.Tensor) -> torch.Tensor:
        return x + sinusoidal_at(positions, self.cfg.d_model).to(x.dtype)

    def encode(self, frames: torch.Tensor, *, train: bool = False) -> torch.Tensor:
        """Whisper's encoder over ``frames [B, T_enc, d]`` (the audio front
        end's stub: frame embeddings, cast to the compute dtype): the
        sin/cos table added, each layer, the final norm (the reference's
        ``_whisper_encode``).  ``train``: differentiable, each layer
        checkpointed on its own under the ``"minimal"`` policy, as the
        reference checkpoints its scan body (weight products saved)."""
        if frames is None:
            raise ValueError(f"{self.cfg.name} is an encoder-decoder stack: it needs frames")
        x = frames.to(self.compute_dtype)
        B, T, _ = x.shape
        x = x + sinusoidal_positions(T, self.cfg.d_model, x.device).to(x.dtype)
        positions = torch.arange(T, device=x.device).expand(B, T)
        for layer in self.encoder.layers:
            if train:
                x = _remat(layer, "minimal")(x, positions, self.impl, True)
            else:
                x = layer(x, positions, self.impl)
        return self.encoder.final_norm(x)

    def init_cross_kv(self, slots: int, block_size: int) -> CrossKV:
        """A zero cross buffer (``attention.CrossKV``) for ``slots`` decode
        slots in blocks of ``block_size`` rows, in the KV dtype, on the
        model's device."""
        return CrossKV.empty(self.cfg, slots, block_size, dtype=self.kv_dtype, device=self.device)

    def _logits(self, x: torch.Tensor) -> torch.Tensor:
        head = self.embed.T if self.lm_head is None else self.lm_head
        x = gather_sequence(self.final_norm(x))
        return shard_activations(x @ head.to(x.dtype), "logits")

    def init_ssm_cache(self, batch: int) -> SSMCache:
        """A zero SSM state for ``batch`` sequences on the model's device:
        float32 state, conv window in the KV dtype (bf16, the reference's).
        A hybrid stack's is ``[nb, P - 1, batch, ...]``, batch on axis 2,
        and keeps its conv window in bf16 whatever the KV dtype, as the
        reference's hybrid cache does beside an attention cache of any
        dtype."""
        cfg = self.cfg
        lead, conv_dtype = cfg.num_layers, self.kv_dtype
        if cfg.family == "hybrid":
            lead, conv_dtype = (len(self.layers), cfg.attn_layer_period - 1), torch.bfloat16
        return init_ssm_cache(cfg, lead, batch, device=self.device, conv_dtype=conv_dtype)


def _param(module: torch.nn.Module, keys) -> torch.Tensor:
    for k in keys:
        module = getattr(module, k)
    return module


def resolve_device(device=None) -> torch.device:
    """``None`` means the CUDA device; there is no silent CPU fallback."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "the port runs on the CUDA device by default and this machine has none; "
                "pass device='cpu' to run the plain PyTorch path on the host"
            )
        return torch.device("cuda")
    return torch.device(device)


def empty_model(cfg: ModelConfig, *, device=None, **kwargs) -> Transformer:
    """A :class:`Transformer` with uninitialised parameters on ``device``
    (default: CUDA); ``kwargs`` go to its constructor."""
    dev = resolve_device(device)
    with torch.device("meta"):
        model = Transformer(cfg, **kwargs)
    return model.to_empty(device=dev)


@torch.no_grad()
def init_params(
    cfg: ModelConfig,
    seed: int = 0,
    *,
    device=None,
    compute_dtype: torch.dtype = torch.bfloat16,
    kv_dtype: torch.dtype = torch.bfloat16,
    impl: str = "kernel",
    param_dtype: Optional[torch.dtype] = None,
) -> Transformer:
    """A :class:`Transformer` with random weights drawn on ``device``
    (default: CUDA) by the reference's init rules, each leaf from its own
    generator seeded from ``seed`` and the leaf's path; a stacked layer leaf
    slice by slice (a layer; a hybrid stack's block, or block and position),
    straight into that slice's parameter, each slice's generator seeded from
    the path and the slice's index (``leaf_seed``), so that no float32 copy
    of a whole stack exists."""
    model = empty_model(
        cfg,
        device=device,
        compute_dtype=compute_dtype,
        kv_dtype=kv_dtype,
        impl=impl,
        param_dtype=param_dtype,
    )
    for keys, spec in iter_specs(param_specs(cfg)):
        if not is_stacked(keys):
            model._assign(keys, init_leaf(spec, leaf_seed(seed, keys), model.device), spec)
            continue
        for idx, p in model.stacked(keys):
            x = init_leaf(spec, leaf_seed(seed, keys, idx), model.device, spec.shape[len(idx) :])
            p.copy_(x)
    return model


@torch.no_grad()
def prefill(
    model: Transformer,
    tokens: torch.Tensor,
    kv_out=None,
    ssm_out: Optional[SSMCache] = None,
    *,
    frames: Optional[torch.Tensor] = None,
    cross_out: Optional[torch.Tensor] = None,
    cache: Optional[dict] = None,
) -> torch.Tensor:
    """Run the prompt ``tokens [B, S]``.  ``kv_out`` (``[B, S, *kv_row_shape]``,
    or None) receives every attention layer's fresh K/V (MLA: latent rows).
    An SSM or hybrid stack starts its SSM layers from ``ssm_out``'s state (a
    zero state if None), as the reference's prefill starts from its cache's,
    and writes their final state and conv window there.  An encoder-decoder
    stack (whisper) encodes ``frames [B, T_enc, d]`` (the reference's
    ``batch["frames"]``), and ``cross_out`` (``[B, T_enc, L, 2, G, D]``,
    ``CrossKV.slot``, or None) receives every decoder layer's cross K/V in
    the KV dtype (the reference's ``ck``/``cv``).  ``cache`` (a contiguous
    cache, ``init_cache``) takes the place of all three: each layer's K/V,
    SSM state and cross K/V are written into its leaves (``prefill_cache``).
    Returns the last position's logits ``[B, 1, Vp]`` in the compute dtype."""
    B, S = tokens.shape
    positions = torch.arange(S, device=tokens.device).expand(B, S)
    x = model._embed(tokens, positions)
    family = model.cfg.family
    enc = model.encode(frames) if model.encoder is not None else None
    tree = None if cache is None else _attn_tree(model, cache)
    if family in ("ssm", "hybrid"):
        if cache is not None:
            ssm_out = _ssm_of(model, cache)
        ssm = model.init_ssm_cache(B) if ssm_out is None else ssm_out
    if family == "ssm":
        for layer, blk in enumerate(model.layers):
            x = blk(x, ssm.layer(layer))
        return model._logits(x[:, -1:])
    kw = dict(kv_dtype=model.kv_dtype, impl=model.impl)
    for layer, blk in enumerate(model.layers):
        kv = None if kv_out is None else kv_out[:, :, layer]
        lc = None if tree is None else _at(tree, layer)
        if family == "hybrid":
            for pos, mixer, ffn in blk.positions():
                if pos == 0:
                    x = mixer.prefill(x, positions, kv, cache=lc, **kw)
                else:
                    x = mixer(x, ssm.layer(layer, pos - 1))
                x, _ = ffn(x)
            continue
        h = shard_activations(blk.attn_norm(x), "resid")
        x = x + blk.attn.prefill(h, positions, kv, cache=lc, **kw)
        if blk.cross is not None:
            cross = None if cross_out is None else cross_out[:, :, layer]
            x = x + blk.cross.prefill(blk.cross_norm(x), enc, cross, impl=model.impl, cache=lc)
        x = x + blk.feed_forward(x)
    return model._logits(x[:, -1:])


def _decode_stack(model: Transformer, x, attend, cross_attend, ssm: Optional[SSMCache]):
    """The decode loop both cache forms share, from the embedded tokens
    ``x [B, 1, d]`` to the logits: ``attend(attn, h, layer)`` is an
    attention layer's output for its normed input ``h``,
    ``cross_attend(cross, h, layer)`` a cross-attention's, and ``ssm`` the
    SSM layers' state (stepped in place)."""
    family = model.cfg.family
    for layer, blk in enumerate(model.layers):
        if family == "ssm":
            x = blk(x, ssm.layer(layer), decode=True)
            continue
        if family == "hybrid":
            for p, mixer, ffn in blk.positions():
                if p == 0:
                    x = x + attend(mixer.attn, mixer.attn_norm(x), layer)
                else:
                    x = mixer(x, ssm.layer(layer, p - 1), decode=True)
                x, _ = ffn(x)
            continue
        x = x + attend(blk.attn, blk.attn_norm(x), layer)
        if blk.cross is not None:
            x = x + cross_attend(blk.cross, blk.cross_norm(x), layer)
        x = x + blk.feed_forward(x)
    return model._logits(x)


@torch.no_grad()
def decode_step(
    model: Transformer,
    tokens: torch.Tensor,
    pos: torch.Tensor,
    cache,
    ssm_cache: Optional[SSMCache] = None,
    *,
    cross: Optional[CrossKV] = None,
    mla_absorbed: bool = False,
) -> torch.Tensor:
    """One token per sequence: tokens ``[B, 1]``, pos ``[B]`` absolute index.
    Writes each active slot's K/V into the pool (``cache``, a ``PagedKV``)
    and returns ``[B, 1, Vp]``; an SSM stack takes an ``SSMCache`` of ``B``
    sequences as ``cache`` instead, updated in place (it reads no position),
    and a hybrid stack both: the pool as ``cache`` for its attention layers
    and its SSM layers' state as ``ssm_cache``.  An encoder-decoder stack
    (whisper) reads its ``B`` slots' cross K/V from ``cross`` (a
    ``CrossKV``, written at prefill) and adds the sin/cos table at ``pos``.
    ``mla_absorbed`` picks MLA's decode form, as the reference's does
    (default: the non-absorbed form); GQA ignores it."""
    if model.cfg.family == "ssm":
        return _decode_stack(model, model._embed(tokens), None, None, cache)
    positions = pos.reshape(-1, 1)
    x = model._embed(tokens, positions)
    kw = {"absorbed": mla_absorbed} if model.cfg.use_mla else {}
    impl = model.impl
    return _decode_stack(
        model,
        x,
        lambda attn, h, layer: attn.decode(h, positions, cache, layer, impl=impl, **kw),
        lambda xattn, h, layer: xattn.decode(h, cross, layer, impl=impl),
        ssm_cache,
    )


# ---------------------------------------------------------------------------
# The contiguous cache: the reference's init_cache, prefill and decode_step
# ---------------------------------------------------------------------------


def cache_length(cfg: ModelConfig, seq_len: int) -> int:
    """SWA archs roll a window buffer when the context exceeds the window."""
    if cfg.sliding_window and seq_len > cfg.sliding_window:
        return cfg.sliding_window
    return seq_len


def init_cache(
    cfg: ModelConfig, batch: int, cache_len: int, dtype: torch.dtype = torch.bfloat16, *,
    device=None,
) -> dict:
    """The reference's ``init_cache`` tree on ``device`` (default: CUDA;
    ``"meta"`` for shapes only): K/V (MLA: one latent row, ``attention.
    init_mla_cache``) in ``dtype``, ``pos`` -1, an SSM state float32 and
    its conv window bf16; a hybrid stack's ``{"attn": [nb, ...], "ssm":
    [nb, P - 1, B, ...]}``; whisper's ``ck``/``cv [L, B, T_enc, G, D]``
    beside its self-attention's leaves."""
    check_supported(cfg)
    dev = resolve_device(device)
    L = cfg.num_layers
    if cfg.family == "hybrid":
        nb, P = L // cfg.attn_layer_period, cfg.attn_layer_period
        ssm = init_ssm_cache(cfg, (nb, P - 1), batch, device=dev)
        return {
            "attn": init_gqa_cache(cfg, nb, batch, cache_len, dtype, dev),
            "ssm": {"ssm": ssm.ssm, "conv": ssm.conv},
        }
    if cfg.family == "ssm":
        ssm = init_ssm_cache(cfg, L, batch, device=dev)
        return {"ssm": ssm.ssm, "conv": ssm.conv}
    if cfg.use_mla:
        return init_mla_cache(cfg, L, batch, cache_len, dtype, dev)
    cache = init_gqa_cache(cfg, L, batch, cache_len, dtype, dev)
    if cfg.is_encoder_decoder:
        shape = (L, batch, cfg.encoder_seq_len, cfg.num_kv_heads, cfg.resolved_head_dim)
        cache["ck"] = torch.zeros(shape, dtype=dtype, device=dev)
        cache["cv"] = torch.zeros(shape, dtype=dtype, device=dev)
    return cache


def _at(tree: dict, *idx) -> dict:
    """One layer's leaves (views) of a cache tree stacked over layers."""
    return {k: v[idx] for k, v in tree.items()}


def _attn_tree(model: Transformer, cache: dict) -> dict:
    return cache["attn"] if model.cfg.family == "hybrid" else cache


def _ssm_of(model: Transformer, cache: dict) -> SSMCache:
    """An SSM or hybrid stack's SSM leaves of a cache tree, as an ``SSMCache``."""
    tree = cache if model.cfg.family == "ssm" else cache["ssm"]
    return SSMCache(tree["ssm"], tree["conv"])


@torch.no_grad()
def prefill_cache(
    model: Transformer, tokens: torch.Tensor, cache: dict, *, frames=None
) -> tuple:
    """The reference's ``prefill``: run the prompt ``tokens [B, S]``,
    writing every layer's K/V (MLA: latent rows; an SSM layer's final state
    and conv window; whisper's cross K/V of ``frames [B, T_enc, d]``) into
    ``cache`` (``init_cache``) at slot 0, a prompt longer than the cache
    rolling into it (``attention.write_prefill``).  Returns ``(logits [B,
    1, Vp], cache)``, the cache updated in place.  On DTensors (a sharded
    prefill) the writes lay the rows out as the cache's leaves."""
    return prefill(model, tokens, frames=frames, cache=cache), cache


@torch.no_grad()
def decode_step_cache(
    model: Transformer, cache: dict, tokens: torch.Tensor, pos, *, mla_absorbed: bool = False
) -> tuple:
    """The reference's ``decode_step``: one token a sequence, tokens ``[B,
    1]``, ``pos`` its absolute position (an int, a scalar or a ``[B]``
    tensor).  Each attention layer writes its K/V at slot ``pos % T`` of
    its ``T``-slot cache and attends over the cache through the paged
    kernel (``attention.CacheView``: ``lengths = min(pos + 1, T)``); an SSM
    layer steps its state; whisper attends to its cross K/V.  Returns
    ``(logits [B, 1, Vp], cache)``, the cache updated in place.
    ``mla_absorbed`` picks MLA's form, as the reference's (default: the
    non-absorbed one)."""
    cfg, impl = model.cfg, model.impl
    if cfg.family == "ssm":
        return _decode_stack(model, model._embed(tokens), None, None, _ssm_of(model, cache)), cache
    B = tokens.shape[0]
    pos = torch.as_tensor(pos, device=tokens.device).long()
    positions = (pos.reshape(-1, 1) if pos.dim() else pos.reshape(1, 1)).expand(B, 1)
    tree = _attn_tree(model, cache)
    length = tree["pos"].shape[-1]
    view = CacheView.make(positions[:, 0], length, latent=cfg.use_mla and mla_absorbed)
    kw = {"absorbed": mla_absorbed} if cfg.use_mla else {}

    def attend(attn, h, layer):
        return attn.decode_cache(h, positions, _at(tree, layer), view, impl=impl, **kw)

    def cross_attend(xattn, h, layer):
        return xattn.decode_cache(h, _at(tree, layer), impl=impl)

    ssm = _ssm_of(model, cache) if cfg.family == "hybrid" else None
    x = model._embed(tokens, positions)
    return _decode_stack(model, x, attend, cross_attend, ssm), cache


@contextlib.contextmanager
def _deterministic():
    """Deterministic algorithms for the ops inside (restored after)."""
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(was)


class _EmbedLookup(torch.autograd.Function):
    """Rows of ``table`` by ``ids``; the backward adds the gradients of
    repeated ids in a fixed order (PyTorch's deterministic ``index_put_``
    with accumulate, where its default on CUDA adds with atomics)."""

    @staticmethod
    def forward(ctx, table, ids):
        ctx.save_for_backward(ids)
        ctx.table_shape = table.shape
        return table[ids]

    @staticmethod
    def backward(ctx, grad):
        (ids,) = ctx.saved_tensors
        out = grad.new_zeros(ctx.table_shape)
        with _deterministic():
            out.index_put_((ids.reshape(-1),), grad.reshape(-1, grad.shape[-1]), accumulate=True)
        return out, None


def embed_lookup(table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """``table[tokens]``, differentiable with a deterministic backward.  On
    DTensors (a sharded step) ``_embed_lookup_sharded``."""
    if isinstance(table, DTensor):
        return _embed_lookup_sharded(table, tokens)
    return _EmbedLookup.apply(table, tokens.long())


def _embed_lookup_sharded(table, tokens):
    """The vocab-parallel lookup, as each rank's code: DTensor has no
    strategy for ``_EmbedLookup``'s deterministic backward, so every rank
    looks its tokens up in its own rows of the table (vocab sharded over
    ``model`` by the rules, replicated elsewhere), zeroes the tokens other
    ranks hold, and the rows come out ``Partial`` over the vocab's mesh dims
    (one rank adds each row, the others exact zeros: an all-reduce where
    DTensor next needs them whole).  The table's gradient is ``Partial``
    over the mesh dims that split the tokens."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    mesh = table.device_mesh
    if not isinstance(tokens, DTensor):
        tokens = DTensor.from_local(tokens, mesh, [Replicate()] * mesh.ndim, run_check=False)
    vocab = [i for i, pl in enumerate(table.placements) if pl.is_shard(0)]
    t_pl = [Shard(0) if i in vocab else Replicate() for i in range(mesh.ndim)]
    ids_pl = [Replicate() if i in vocab else pl for i, pl in enumerate(tokens.placements)]
    out_pl = [Partial() if i in vocab else pl for i, pl in enumerate(ids_pl)]
    grad_pl = [
        Shard(0) if i in vocab else (Partial() if pl.is_shard() else Replicate())
        for i, pl in enumerate(ids_pl)
    ]

    def lookup(t, ids):
        ids = ids.long()
        if not vocab:
            return _EmbedLookup.apply(t, ids)
        lo = 0
        for i in vocab:
            lo = lo * mesh.size(i) + mesh.get_local_rank(i)
        lo *= t.shape[0]
        mine = (ids >= lo) & (ids < lo + t.shape[0])
        rows = _EmbedLookup.apply(t, torch.where(mine, ids - lo, 0))
        return rows * mine[..., None].to(rows.dtype)

    run = local_map(
        lookup,
        out_placements=out_pl,
        in_placements=(t_pl, ids_pl),
        in_grad_placements=(grad_pl, ids_pl),
        device_mesh=mesh,
        redistribute_inputs=True,
    )
    return run(table, tokens)


def _save_matmuls(ctx, op, *args, **kwargs):
    if op in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default):
        return ckpt.CheckpointPolicy.MUST_SAVE
    return ckpt.CheckpointPolicy.PREFER_RECOMPUTE


REMAT_POLICIES = ("none", "minimal", "full")


def _remat(fn, policy: str):
    """``fn`` under the reference's remat policy ``none``/``minimal``/``full``."""
    if policy == "none":
        return fn
    if policy == "full":
        return functools.partial(ckpt.checkpoint, fn, use_reentrant=False)
    if policy == "minimal":
        context = functools.partial(ckpt.create_selective_checkpoint_contexts, _save_matmuls)
        return functools.partial(ckpt.checkpoint, fn, use_reentrant=False, context_fn=context)
    raise ValueError(f"remat_policy must be none, minimal or full; got {policy!r}")


def forward_train(
    model: Transformer,
    tokens: torch.Tensor,
    *,
    frames: Optional[torch.Tensor] = None,
    remat_policy: str = "minimal",
):
    """tokens ``[B, S]`` -> ``(logits [B, S, Vp]`` in the compute dtype,
    ``aux`` float32 scalar, the layers' summed MoE load-balancing loss``)``:
    the reference's ``forward_train``, with gradients to every parameter of
    a training model.  A uniform stack takes ``remat_policy`` per layer; a
    hybrid stack checkpoints each mixer and each FFN of a super-block on its
    own under any policy but ``"none"`` (the reference's
    ``remat_positions``: nothing saved, so the backward holds one
    sub-layer's activations at a time).  An encoder-decoder stack (whisper)
    encodes ``frames [B, T_enc, d]`` (the reference's ``batch["frames"]``),
    each encoder layer checkpointed on its own whatever the policy, as the
    reference's, and its decoder layers attend to the encoder's output."""
    B, S = tokens.shape
    positions = torch.arange(S, device=tokens.device).expand(B, S)
    x = shard_activations(embed_lookup(model.embed, tokens).to(model.compute_dtype), "resid")
    enc = None
    if model.encoder is not None:
        x = model._add_sinusoid(x, positions)
        enc = model.encode(frames, train=True)
    aux = torch.zeros((), device=tokens.device)
    family = model.cfg.family
    if family == "hybrid":
        if remat_policy not in REMAT_POLICIES:
            raise ValueError(f"remat_policy must be one of {REMAT_POLICIES}; got {remat_policy!r}")
        policy = "none" if remat_policy == "none" else "full"
        for blk in model.layers:
            for pos, mixer, ffn in blk.positions():
                if pos == 0:
                    fn = functools.partial(mixer.forward_train, impl=model.impl)
                    x = _remat(fn, policy)(x, positions)
                else:
                    x = _remat(mixer, policy)(x)
                x, a = _remat(ffn, policy)(x)
                aux = aux + a
            x = shard_activations(x, "resid")
        return model._logits(x), aux
    for blk in model.layers:
        if family == "ssm":
            x = _remat(blk, remat_policy)(x)
            continue
        x, a = _remat(functools.partial(blk.train_layer, impl=model.impl), remat_policy)(
            x, positions, encoder_out=enc
        )
        aux = aux + a
    return model._logits(x), aux


__all__ = [
    "CacheView",
    "CrossKV",
    "HybridBlock",
    "PagedKV",
    "SSMCache",
    "Transformer",
    "cache_length",
    "decode_step",
    "decode_step_cache",
    "embed_lookup",
    "empty_model",
    "forward_train",
    "init_cache",
    "init_params",
    "param_specs",
    "prefill",
    "prefill_cache",
    "resolve_device",
]
