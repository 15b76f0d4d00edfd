"""Model configurations: a copy of the reference package's ``ModelConfig``.

Plain frozen dataclasses with the published hyper-parameters of each
architecture, plus ``smoke()``, the reduced same-family variant the CPU tests
use.  The fields are the reference's, so a config converts across by
``dataclasses.asdict``; what the port can run is checked by
``check_supported``.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Tuple

VOCAB_PAD_MULTIPLE = 2048  # the reference pads so the vocabulary shards evenly


def pad_vocab(v: int, multiple: int = VOCAB_PAD_MULTIPLE) -> int:
    return ((v + multiple - 1) // multiple) * multiple


@dataclass(frozen=True)
class ModelConfig:
    """Architecture hyper-parameters, one instance per architecture."""

    name: str
    family: str  # dense | moe | ssm | hybrid | encdec | vlm
    num_layers: int
    d_model: int
    vocab_size: int

    # ---- attention ----
    num_heads: int = 0
    num_kv_heads: int = 0
    head_dim: int = 0  # 0 -> d_model // num_heads
    rope_theta: float = 10_000.0
    rope_fraction: float = 1.0  # fraction of head dims carrying rotary
    use_qk_norm: bool = False
    sliding_window: int = 0  # >0 -> sliding-window attention (SWA)

    # ---- MLA (deepseek-v2) ----
    use_mla: bool = False
    kv_lora_rank: int = 0
    q_lora_rank: int = 0
    qk_nope_dim: int = 0
    qk_rope_dim: int = 0
    v_head_dim: int = 0

    # ---- FFN ----
    d_ff: int = 0
    mlp_type: str = "swiglu"  # swiglu | gelu

    # ---- MoE ----
    moe_num_experts: int = 0
    moe_top_k: int = 0
    moe_d_ff: int = 0
    moe_num_shared: int = 0
    moe_layer_period: int = 1
    moe_capacity_factor: float = 1.25
    moe_aux_loss_weight: float = 0.01

    # ---- SSM (mamba2 / SSD) ----
    ssm_state_dim: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_conv_width: int = 4
    ssm_chunk: int = 256
    ssm_num_groups: int = 1

    # ---- hybrid (jamba) ----
    attn_layer_period: int = 0
    attn_layer_offset: int = 0

    # ---- encoder-decoder (whisper) ----
    is_encoder_decoder: bool = False
    num_encoder_layers: int = 0
    encoder_seq_len: int = 1500

    # ---- misc ----
    norm_type: str = "rmsnorm"  # rmsnorm | layernorm
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    frontend: str = "none"
    source: str = ""

    @property
    def resolved_head_dim(self) -> int:
        if self.head_dim:
            return self.head_dim
        if self.num_heads:
            return self.d_model // self.num_heads
        return 0

    @property
    def padded_vocab(self) -> int:
        return pad_vocab(self.vocab_size)

    @property
    def supports_long_context(self) -> bool:
        """True iff a 500k-token decode is sub-quadratic for this arch."""
        return self.family in ("ssm", "hybrid") or self.sliding_window > 0

    def is_attn_layer(self, layer_idx: int) -> bool:
        """Hybrid stacks: which layers carry attention (the rest are SSM)."""
        if not self.attn_layer_period:
            return self.ssm_state_dim == 0
        return layer_idx % self.attn_layer_period == self.attn_layer_offset

    @property
    def num_attn_layers(self) -> int:
        """Layers with attention: all of a GQA or MLA stack, one a
        super-block of a hybrid stack, none of an SSM stack."""
        return sum(self.is_attn_layer(i) for i in range(self.num_layers))

    def is_moe_layer(self, layer_idx: int) -> bool:
        if not self.moe_num_experts:
            return False
        if self.moe_layer_period > 1:
            return layer_idx % self.moe_layer_period == self.moe_layer_period - 1
        return True

    @property
    def latent_dim(self) -> int:
        """Width of one token's MLA latent row, ``c_kv`` then ``k_pe``
        (0 without MLA): what the cache stores per layer."""
        return self.kv_lora_rank + self.qk_rope_dim if self.use_mla else 0

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_num_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim if self.ssm_state_dim else 0

    @property
    def ssm_conv_dim(self) -> int:
        """Channels of the SSM's causal conv: x, then B, then C."""
        return self.d_inner + 2 * self.ssm_num_groups * self.ssm_state_dim

    def num_params(self) -> int:
        """The reference's analytic parameter count, layer by layer, for the
        stacks the port runs (it counts one scale vector per norm, no
        QK-norm scales and no MLA ``kv_norm``; an SSM layer's projections,
        conv taps, ``A_log``, ``D``, ``dt_bias``, gated norm and
        ``out_proj``; one vocabulary matrix where the embeddings are tied).
        A hybrid stack counts attention where ``is_attn_layer`` and SSM
        elsewhere, MoE where ``is_moe_layer`` and a dense FFN elsewhere.  An
        encoder-decoder stack adds its encoder layers (attention, FFN, two
        norms) and each decoder layer's cross-attention and its norm (the
        FFN's biases uncounted, as there)."""
        check_supported(self)
        d, hd, h = self.d_model, self.resolved_head_dim, self.num_heads
        n = (1 if self.tie_embeddings else 2) * self.padded_vocab * d
        for li in range(self.num_layers):
            if not self.is_attn_layer(li):
                di, hs = self.d_inner, self.ssm_num_heads
                gn = self.ssm_num_groups * self.ssm_state_dim
                n += d * (2 * di + 2 * gn + hs) + self.ssm_conv_dim * self.ssm_conv_width
                n += 3 * hs + di + di * d
            elif self.use_mla:
                dn, dr, dv = self.qk_nope_dim, self.qk_rope_dim, self.v_head_dim
                r = self.kv_lora_rank
                n += d * h * (dn + dr) + d * (r + dr) + r * h * (dn + dv) + h * dv * d
            else:
                n += d * h * hd * 2 + 2 * d * self.num_kv_heads * hd
            if self.is_moe_layer(li):
                f = self.moe_d_ff or self.d_ff
                n += self.moe_num_experts * 3 * d * f + d * self.moe_num_experts
                n += 3 * d * self.moe_num_shared * f
            elif self.d_ff:
                n += (3 if self.mlp_type == "swiglu" else 2) * d * self.d_ff
            n += 2 * d
        if self.is_encoder_decoder:
            n += self.num_encoder_layers * (4 * d * h * hd + 2 * d * self.d_ff + 2 * d)
            n += self.num_layers * (4 * d * h * hd + d)
        return n


def check_supported(cfg: ModelConfig) -> None:
    """Raise ``NotImplementedError`` for a stack the port does not run.  It
    carries every config of the reference's registry: uniform stacks of GQA
    or MLA attention, dense or with an MoE FFN on every layer, with or
    without QK-norm and sliding windows; uniform SSM stacks (family
    ``ssm``: mamba2); hybrid stacks (family ``hybrid``: jamba's super-blocks
    of one attention and ``attn_layer_period - 1`` SSM layers, MoE on every
    ``moe_layer_period``-th layer); and encoder-decoder stacks (family
    ``encdec``: whisper, a non-causal encoder over ``encoder_seq_len``
    frames and decoder layers of causal self-attention, cross-attention and
    a dense FFN, no RoPE); with tied or separate embeddings.  Every stack it
    lets through also trains.  What it refuses is no config of the
    registry: MLA with query compression, MoE on every k-th layer of a
    uniform stack, SSM layers outside an SSM or hybrid stack, a part
    super-block, and an encoder-decoder stack that is not dense MHA or GQA.
    Family ``vlm`` (chameleon-34b) runs as a dense stack: the reference's
    model code branches only on ``ssm``, ``hybrid`` and
    ``is_encoder_decoder`` and never reads ``frontend``, so its VQ front end
    is the embedding table and nothing more (whisper's audio front end is a
    stub too: the encoder takes frame embeddings)."""
    later = []
    hybrid = cfg.family == "hybrid"
    if cfg.family not in ("dense", "moe", "vlm", "ssm", "hybrid", "encdec"):
        later.append(f"family {cfg.family!r}")
    if (cfg.family == "encdec") != cfg.is_encoder_decoder:
        later.append("family 'encdec' without is_encoder_decoder, or the reverse")
    if cfg.is_encoder_decoder and (
        cfg.use_mla or cfg.moe_num_experts or cfg.ssm_state_dim or not cfg.num_heads
    ):
        later.append("an encoder-decoder stack that is not dense MHA or GQA")
    if cfg.use_mla and cfg.q_lora_rank:
        later.append("MLA with query compression")
    if cfg.moe_num_experts and cfg.moe_layer_period != 1 and not hybrid:
        later.append("MoE on every k-th layer of a uniform stack")
    if not hybrid and (cfg.attn_layer_period or (cfg.ssm_state_dim and cfg.family != "ssm")):
        later.append("attention and SSM layers outside a hybrid stack")
    if hybrid and not (cfg.attn_layer_period and cfg.ssm_state_dim and cfg.num_heads):
        later.append("a hybrid stack without attention, SSM or its period")
    if hybrid and cfg.num_layers % max(cfg.attn_layer_period, 1):
        later.append("a hybrid stack of a part super-block")
    if later:
        raise NotImplementedError(
            f"{cfg.name}: {', '.join(later)} not carried by the port: it runs uniform GQA "
            "or MLA stacks (dense or MoE), uniform SSM stacks, hybrid stacks and "
            "encoder-decoder stacks, every config of the reference's registry"
        )


@dataclass(frozen=True)
class ShapeConfig:
    """One assigned input-shape cell (the reference's ``ShapeConfig``)."""

    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


SHAPES: Tuple[ShapeConfig, ...] = (
    ShapeConfig("train_4k", 4_096, 256, "train"),
    ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    ShapeConfig("decode_32k", 32_768, 128, "decode"),
    ShapeConfig("long_500k", 524_288, 1, "decode"),
)

SHAPES_BY_NAME = {s.name: s for s in SHAPES}


def shape_applicable(cfg: ModelConfig, shape: ShapeConfig) -> Tuple[bool, str]:
    """Whether an (arch, shape) cell runs, per the assignment footnotes."""
    if shape.name == "long_500k" and not cfg.supports_long_context:
        return False, "skipped: pure full-attention arch (needs sub-quadratic)"
    return True, ""

#: the reference's ``RunConfig.attn_impl`` values and the port's ``impl`` for each
ATTN_IMPLS = {"jnp": "ref", "pallas": "kernel"}


@dataclass(frozen=True)
class RunConfig:
    """Runtime and training knobs orthogonal to the architecture: the
    reference's ``RunConfig``, field for field.

    ``attn_impl`` picks the attention of the training forward through
    ``ATTN_IMPLS``: ``"pallas"`` (the reference's kernel path) is the port's
    hand-written kernels, ``"jnp"`` their plain PyTorch versions.  The default
    is ``"pallas"`` where the reference's is ``"jnp"``: there the jnp path is
    the one a host without a TPU runs, and here the kernel wrappers already
    take their plain versions on CPU tensors.  ``param_dtype`` is the dtype
    of the master parameters (the reference keeps float32; each use casts to
    ``compute_dtype``).  ``seq_parallel`` (Megatron sequence parallelism) shards the
    residual stream over ``model`` between blocks where a mesh is registered
    (``distributed.sharding.make_activation_sharder``) and means nothing on
    one device; ``scan_unroll`` (layer-scan unrolling for XLA costing) means
    nothing with an eager Python layer loop: it is kept so that the fields
    stay the reference's, and ignored.  ``triangular_attn`` changes no
    value: the kernels and the plain versions skip fully masked blocks
    always.  ``arch`` names the model the launcher trains, ``shape`` the
    ``SHAPES`` cell whose sequence length a full-width step takes.
    ``checkpoint_dir`` defaults to ``""``, no checkpoints, where the
    reference's names a fixed directory under ``/tmp``: a run writes only
    where it is told to."""

    arch: str = "stablelm-1.6b"
    shape: str = "train_4k"
    steps: int = 100
    learning_rate: float = 3e-4
    weight_decay: float = 0.1
    warmup_steps: int = 20
    grad_clip: float = 1.0
    optimizer: str = "adamw"  # adamw | adafactor
    remat_policy: str = "full"  # none | minimal | full
    microbatches: int = 1  # >1 -> gradient accumulation
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    seed: int = 0
    grad_compression: str = "none"  # none | int8_ef
    checkpoint_dir: str = ""  # "" = no checkpoints
    checkpoint_every: int = 50
    attn_impl: str = "pallas"  # pallas | jnp (see ATTN_IMPLS)
    seq_parallel: bool = True  # Megatron-SP residual sharding (a mesh; no-op on one device)
    triangular_attn: bool = False  # no value changes
    scan_unroll: bool = False  # no-op: the port loops over layers in Python

    @property
    def impl(self) -> str:
        """The port's attention implementation for ``attn_impl``."""
        if self.attn_impl not in ATTN_IMPLS:
            raise ValueError(
                f"attn_impl must be one of {sorted(ATTN_IMPLS)}; got {self.attn_impl!r}"
            )
        return ATTN_IMPLS[self.attn_impl]


def smoke(cfg: ModelConfig, **overrides) -> ModelConfig:
    """Reduced same-family config for CPU tests (tiny widths, real structure),
    as the reference's ``smoke`` makes it: two layers of a uniform stack, one
    whole super-block (``attn_layer_period`` layers) of a hybrid one, two
    encoder and two decoder layers over 16 frames of an encoder-decoder
    one."""
    check_supported(cfg)
    changes = dict(
        name=cfg.name + "-smoke",
        d_model=64,
        vocab_size=256,
        d_ff=(128 if cfg.d_ff else 0),
        num_layers=cfg.attn_layer_period or 2,
    )
    if cfg.num_heads:
        changes["num_heads"] = 4
        changes["num_kv_heads"] = max(1, int(round(4 * cfg.num_kv_heads / cfg.num_heads)))
        changes["head_dim"] = 16
    if cfg.use_mla:
        changes.update(kv_lora_rank=32, qk_nope_dim=16, qk_rope_dim=8, v_head_dim=16, head_dim=0)
    if cfg.moe_num_experts:
        changes.update(moe_num_experts=4, moe_top_k=min(2, cfg.moe_top_k), moe_d_ff=64)
    if cfg.ssm_state_dim:
        changes.update(ssm_state_dim=16, ssm_head_dim=16, ssm_chunk=32)
    if cfg.is_encoder_decoder:
        changes.update(num_encoder_layers=2, encoder_seq_len=16)
    if cfg.sliding_window:
        changes["sliding_window"] = 16
    changes.update(overrides)
    return dataclasses.replace(cfg, **changes)
