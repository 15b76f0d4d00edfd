"""Decoder stack of the port: the reference's ``models/model.py`` for
uniform GQA or MLA architectures, dense or with an MoE FFN on every layer,
with or without a sliding window, and for uniform SSM stacks (mamba2).

Public API (each mirrors the reference's function of the same name):
  param_specs(cfg)                         -> ParamSpec tree (layers stacked [L, ...])
  init_params(cfg, seed, device=...)       -> Transformer with seeded random weights
  prefill(model, tokens, kv_out, ssm_out=None) -> logits [B, 1, Vp] of the last position
  decode_step(model, tokens, pos, cache, mla_absorbed=False) -> logits [B, 1, Vp]
  forward_train(model, tokens, remat_policy=...) -> (logits [B, S, Vp], aux)

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
(``ssm_out``) and ``decode_step`` updates in place; its training comes with
the hybrid stacks, and ``forward_train`` refuses it.  Tied embeddings
(``cfg.tie_embeddings``, mamba2) keep no ``lm_head``: the logits are
``x @ embed.T``, as the reference's ``_logits``.  The families the port does
not carry yet raise ``NotImplementedError`` (``configs.base.check_supported``).

Training takes a model built with ``param_dtype`` (float32, the reference's
master parameters): every parameter is stored in that dtype with
``requires_grad``, and each use casts it to the compute dtype, as the
reference's ``p[...].astype(x.dtype)``.  ``forward_train`` runs the stack
under the reference's remat policies: ``"full"`` checkpoints each layer
(``torch.utils.checkpoint``, non-reentrant, nothing saved), ``"minimal"``
saves the layer's weight-matrix products (``aten.mm``: the reference's
``dots_with_no_batch_dims_saveable``) and recomputes the rest, ``"none"``
saves everything; the three give the same values.  The embedding's backward
adds the rows of repeated tokens in a fixed order (``embed_lookup``), so that
two runs of a step agree to the bit.
"""

from __future__ import annotations

import contextlib
import functools
import math
from typing import Any, Mapping, Optional

import numpy as np
import torch
import torch.utils.checkpoint as ckpt

from repro_torch.configs.base import ModelConfig, check_supported
from repro_torch.models.attention import (
    ATTENTION,
    GQAAttention,
    MLAAttention,
    PagedKV,
    gqa_specs,
    mla_specs,
)
from repro_torch.models.layers import Norm, ParamSpec, init_leaf, iter_specs, leaf_seed, norm_spec
from repro_torch.models.mlp import MLP, mlp_specs
from repro_torch.models.moe import MoE, moe_specs
from repro_torch.models.ssm import SSMBlock, SSMCache, init_ssm_cache, ssm_specs


def param_specs(cfg: ModelConfig) -> dict:
    check_supported(cfg)
    d, Vp = cfg.d_model, cfg.padded_vocab
    if cfg.family == "ssm":
        layer = {"mixer_norm": norm_spec(cfg, d), "ssm": ssm_specs(cfg)}
    else:
        layer = {
            "attn_norm": norm_spec(cfg, d),
            "attn": mla_specs(cfg) if cfg.use_mla else gqa_specs(cfg),
            "ffn_norm": norm_spec(cfg, d),
        }
        if cfg.is_moe_layer(0):
            layer["moe"] = moe_specs(cfg)
        else:
            layer["ffn"] = mlp_specs(cfg, cfg.d_ff)
    specs = {
        "embed": ParamSpec((Vp, d), ("vocab", "embed_table"), stddev=0.02),
        "final_norm": norm_spec(cfg, d),
    }
    if not cfg.tie_embeddings:
        specs["lm_head"] = ParamSpec((d, Vp), ("embed", "vocab"), init="fan_in")
    specs["layers"] = _stack(layer, cfg.num_layers)
    return specs


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
        return x + self.ssm(self.mixer_norm(x), cache, decode=decode)


class Block(torch.nn.Module):
    def __init__(self, cfg: ModelConfig, dtype: torch.dtype):
        super().__init__()
        self.attn_norm = Norm(cfg, cfg.d_model)
        self.attn = (MLAAttention if cfg.use_mla else GQAAttention)(cfg, dtype)
        self.ffn_norm = Norm(cfg, cfg.d_model)
        self.is_moe = cfg.is_moe_layer(0)
        if self.is_moe:
            self.moe = MoE(cfg, dtype)
        else:
            self.ffn = MLP(cfg, cfg.d_ff, dtype)

    def feed_forward(self, x: torch.Tensor) -> torch.Tensor:
        """The FFN sub-layer's residual branch (dense MLP or MoE)."""
        h = self.ffn_norm(x)
        return self.moe(h) if self.is_moe else self.ffn(h)

    def train_layer(self, x, positions, impl: str):
        """One layer of the training forward: ``(x, aux)``, aux float32 (0
        for a dense FFN, as the reference's ``_apply_ffn``)."""
        x = x + self.attn.forward_train(self.attn_norm(x), positions, impl=impl)
        h = self.ffn_norm(x)
        if self.is_moe:
            out, aux = self.moe.forward_aux(h)
        else:
            out, aux = self.ffn(h), torch.zeros((), device=x.device)
        return x + out, aux


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
        layer_cls = SSMLayer if cfg.family == "ssm" else Block
        self.layers = torch.nn.ModuleList(layer_cls(cfg, wdt) for _ in range(cfg.num_layers))
        if param_dtype is not None:
            for p in self.parameters():
                p.requires_grad_(True)

    @property
    def device(self) -> torch.device:
        return self.embed.device

    def kv_row_shape(self) -> tuple:
        """How the engine views one token's pool row: ``(L, 2, G, D)``, every
        layer's K and V, for GQA; ``(L, kv_lora_rank + qk_rope_dim)``, every
        layer's latent row, for MLA; ``(0,)`` for an SSM stack, which keeps
        no KV rows."""
        cfg = self.cfg
        if cfg.family == "ssm":
            return (0,)
        if cfg.use_mla:
            return (cfg.num_layers, cfg.latent_dim)
        return (cfg.num_layers, 2, cfg.num_kv_heads, cfg.resolved_head_dim)

    def kv_width(self) -> int:
        """Elements of one token's cache across every layer (a pool row)."""
        return math.prod(self.kv_row_shape())

    def load_tree(self, tree: Mapping[str, Any]) -> "Transformer":
        """Copy a parameter tree laid out as ``param_specs`` (the reference's
        tree: nested dicts, layer leaves stacked ``[L, ...]``, array-likes)
        into the modules, casting each leaf to its parameter's dtype."""
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
        for keys, _ in iter_specs(param_specs(self.cfg)):
            if keys[0] == "layers":
                val = torch.stack([_param(layer, keys[1:]) for layer in self.layers])
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
        if keys[0] == "layers":
            for layer, v in zip(self.layers, value):
                _param(layer, keys[1:]).copy_(v)
        else:
            _param(self, keys).copy_(value)

    def _embed(self, tokens: torch.Tensor) -> torch.Tensor:
        return self.embed[tokens.long()]

    def _logits(self, x: torch.Tensor) -> torch.Tensor:
        head = self.embed.T if self.lm_head is None else self.lm_head
        return self.final_norm(x) @ head.to(x.dtype)

    def init_ssm_cache(self, batch: int) -> SSMCache:
        """A zero SSM state for ``batch`` sequences on the model's device:
        float32 state, conv window in the KV dtype (bf16, the reference's)."""
        return init_ssm_cache(
            self.cfg, self.cfg.num_layers, batch, device=self.device, conv_dtype=self.kv_dtype
        )


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
    layer by layer, straight into that layer's parameter, each layer's
    generator seeded from the path and the layer's index (``leaf_seed``)."""
    model = empty_model(
        cfg,
        device=device,
        compute_dtype=compute_dtype,
        kv_dtype=kv_dtype,
        impl=impl,
        param_dtype=param_dtype,
    )
    for keys, spec in iter_specs(param_specs(cfg)):
        if keys[0] != "layers":
            model._assign(keys, init_leaf(spec, leaf_seed(seed, keys), model.device), spec)
            continue
        for i, layer in enumerate(model.layers):
            x = init_leaf(spec, leaf_seed(seed, keys, i), model.device, spec.shape[1:])
            _param(layer, keys[1:]).copy_(x)
    return model


@torch.no_grad()
def prefill(
    model: Transformer, tokens: torch.Tensor, kv_out=None, ssm_out: Optional[SSMCache] = None
) -> torch.Tensor:
    """Run the prompt ``tokens [B, S]``.  ``kv_out`` (``[B, S, *kv_row_shape]``,
    or None) receives every layer's fresh K/V (MLA: latent rows).  An SSM
    stack starts from ``ssm_out``'s state (a zero state if None), as the
    reference's prefill starts from its cache's, and writes its final state
    and conv window there.  Returns the last position's logits ``[B, 1,
    Vp]`` in the compute dtype."""
    B, S = tokens.shape
    x = model._embed(tokens)
    if model.cfg.family == "ssm":
        cache = model.init_ssm_cache(B) if ssm_out is None else ssm_out
        for layer, blk in enumerate(model.layers):
            x = blk(x, SSMCache(cache.ssm[layer], cache.conv[layer]))
        return model._logits(x[:, -1:])
    positions = torch.arange(S, device=tokens.device).expand(B, S)
    for layer, blk in enumerate(model.layers):
        kv = None if kv_out is None else kv_out[:, :, layer]
        x = x + blk.attn.prefill(
            blk.attn_norm(x), positions, kv, kv_dtype=model.kv_dtype, impl=model.impl
        )
        x = x + blk.feed_forward(x)
    return model._logits(x[:, -1:])


@torch.no_grad()
def decode_step(
    model: Transformer,
    tokens: torch.Tensor,
    pos: torch.Tensor,
    cache,
    *,
    mla_absorbed: bool = False,
) -> torch.Tensor:
    """One token per sequence: tokens ``[B, 1]``, pos ``[B]`` absolute index.
    Writes each active slot's K/V into the pool (``cache``, a ``PagedKV``)
    and returns ``[B, 1, Vp]``; an SSM stack takes an ``SSMCache`` of ``B``
    sequences instead, updated in place (it reads no position).
    ``mla_absorbed`` picks MLA's decode form, as the reference's does
    (default: the non-absorbed form); GQA ignores it."""
    x = model._embed(tokens)
    if model.cfg.family == "ssm":
        for layer, blk in enumerate(model.layers):
            x = blk(x, SSMCache(cache.ssm[layer], cache.conv[layer]), decode=True)
        return model._logits(x)
    positions = pos.reshape(-1, 1)
    kw = {"absorbed": mla_absorbed} if model.cfg.use_mla else {}
    for layer, blk in enumerate(model.layers):
        x = x + blk.attn.decode(blk.attn_norm(x), positions, cache, layer, impl=model.impl, **kw)
        x = x + blk.feed_forward(x)
    return model._logits(x)


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
    """``table[tokens]``, differentiable with a deterministic backward."""
    return _EmbedLookup.apply(table, tokens.long())


def _save_matmuls(ctx, op, *args, **kwargs):
    if op in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default):
        return ckpt.CheckpointPolicy.MUST_SAVE
    return ckpt.CheckpointPolicy.PREFER_RECOMPUTE


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


def forward_train(model: Transformer, tokens: torch.Tensor, *, remat_policy: str = "minimal"):
    """tokens ``[B, S]`` -> ``(logits [B, S, Vp]`` in the compute dtype,
    ``aux`` float32 scalar, the layers' summed MoE load-balancing loss``)``:
    the reference's ``forward_train`` for a decoder-only stack, with
    gradients to every parameter of a training model.  An SSM stack raises
    ``NotImplementedError``: its training comes with the hybrid stacks."""
    if model.cfg.family == "ssm":
        raise NotImplementedError(
            f"{model.cfg.name}: training an SSM stack is not ported yet; ROADMAP Queue 1, "
            "hybrid stacks (jamba-1.5-large-398b), brings it (the port serves SSM stacks)"
        )
    B, S = tokens.shape
    positions = torch.arange(S, device=tokens.device).expand(B, S)
    x = embed_lookup(model.embed, tokens).to(model.compute_dtype)
    aux = torch.zeros((), device=tokens.device)
    for blk in model.layers:
        x, a = _remat(functools.partial(blk.train_layer, impl=model.impl), remat_policy)(
            x, positions
        )
        aux = aux + a
    return model._logits(x), aux


__all__ = [
    "PagedKV",
    "SSMCache",
    "Transformer",
    "decode_step",
    "embed_lookup",
    "empty_model",
    "forward_train",
    "init_params",
    "param_specs",
    "prefill",
    "resolve_device",
]
