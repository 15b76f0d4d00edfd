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
        """The reference's analytic parameter count, for the uniform stacks
        the port runs (it counts one scale vector per norm, no QK-norm
        scales and no MLA ``kv_norm``; an SSM layer's projections, conv
        taps, ``A_log``, ``D``, ``dt_bias``, gated norm and ``out_proj``; one
        vocabulary matrix where the embeddings are tied)."""
        check_supported(self)
        d, V, hd = self.d_model, self.padded_vocab, self.resolved_head_dim
        h = self.num_heads
        if self.family == "ssm":
            di, gn, hs = self.d_inner, self.ssm_num_groups * self.ssm_state_dim, self.ssm_num_heads
            mixer = d * (2 * di + 2 * gn + hs) + self.ssm_conv_dim * self.ssm_conv_width
            mixer += 3 * hs + di + di * d
        elif self.use_mla:
            dn, dr, dv, r = self.qk_nope_dim, self.qk_rope_dim, self.v_head_dim, self.kv_lora_rank
            mixer = d * h * (dn + dr) + d * (r + dr) + r * h * (dn + dv) + h * dv * d
        else:
            mixer = d * h * hd * 2 + 2 * d * self.num_kv_heads * hd
        if self.is_moe_layer(0):
            f = self.moe_d_ff or self.d_ff
            ffn = self.moe_num_experts * 3 * d * f + d * self.moe_num_experts
            ffn += 3 * d * self.moe_num_shared * f
        else:
            ffn = (3 if self.mlp_type == "swiglu" else 2) * d * self.d_ff
        vocab = (1 if self.tie_embeddings else 2) * V * d
        return vocab + self.num_layers * (mixer + ffn + 2 * d)


def check_supported(cfg: ModelConfig) -> None:
    """Raise ``NotImplementedError`` for what the port does not run yet: it
    carries uniform stacks of GQA or MLA attention, dense or with an MoE FFN
    on every layer, with or without QK-norm and sliding windows, and
    uniform SSM stacks (family ``ssm``: mamba2), with tied or separate
    embeddings (ROADMAP Queue 1 lists the rest under "the remaining model
    families", with the slice that brings each).  The attention stacks also
    train; an SSM stack serves, and its training comes with the hybrid
    stacks (``models.model.forward_train`` refuses it).  Family ``vlm``
    (chameleon-34b) runs as a dense stack: the reference's model code
    branches only on ``ssm`` and ``hybrid`` and never reads ``frontend``, so
    its VQ front end is the embedding table and nothing more."""
    later = []
    if cfg.family not in ("dense", "moe", "vlm", "ssm"):
        later.append(f"family {cfg.family!r}")
    if cfg.use_mla and cfg.q_lora_rank:
        later.append("MLA with query compression")
    if cfg.moe_num_experts and cfg.moe_layer_period != 1:
        later.append("MoE on every k-th layer")
    if cfg.attn_layer_period or (cfg.ssm_state_dim and cfg.family != "ssm"):
        later.append("hybrid stacks")
    if cfg.is_encoder_decoder:
        later.append("encoder-decoder")
    if later:
        raise NotImplementedError(
            f"{cfg.name}: {', '.join(later)} not ported yet; the port runs uniform GQA or "
            "MLA stacks (dense or MoE) and uniform SSM stacks, and the later slices of "
            "ROADMAP Queue 1 (the remaining model families) bring the rest"
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
    ``compute_dtype``).  ``seq_parallel`` (Megatron sequence parallelism) and
    ``scan_unroll`` (layer-scan unrolling for XLA costing) mean nothing on one
    device with an eager Python layer loop: they are kept so that the
    fields stay the reference's, and ignored.  ``triangular_attn`` changes no
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
    seq_parallel: bool = True  # no-op on one device
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
    as the reference's ``smoke`` makes it for a uniform stack."""
    check_supported(cfg)
    changes = dict(
        name=cfg.name + "-smoke",
        d_model=64,
        vocab_size=256,
        d_ff=(128 if cfg.d_ff else 0),
        num_layers=2,
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
    if cfg.sliding_window:
        changes["sliding_window"] = 16
    changes.update(overrides)
    return dataclasses.replace(cfg, **changes)
