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

    def num_params(self) -> int:
        """The reference's analytic parameter count, for the uniform stacks
        the port runs (it counts one scale vector per norm, and no QK-norm
        scales)."""
        check_supported(self)
        d, V, hd = self.d_model, self.padded_vocab, self.resolved_head_dim
        attn = d * self.num_heads * hd * 2 + 2 * d * self.num_kv_heads * hd
        if self.is_moe_layer(0):
            f = self.moe_d_ff or self.d_ff
            ffn = self.moe_num_experts * 3 * d * f + d * self.moe_num_experts
            ffn += 3 * d * self.moe_num_shared * f
        else:
            ffn = (3 if self.mlp_type == "swiglu" else 2) * d * self.d_ff
        return 2 * V * d + self.num_layers * (attn + ffn + 2 * d)


def check_supported(cfg: ModelConfig) -> None:
    """Raise ``NotImplementedError`` for what the port does not run yet: it
    carries uniform GQA stacks, dense or with an MoE FFN on every layer, with
    or without QK-norm (ROADMAP Queue 1 item 13 lists the rest and the slice
    that brings it)."""
    later = []
    if cfg.family not in ("dense", "moe"):
        later.append(f"family {cfg.family!r}")
    if cfg.use_mla:
        later.append("MLA")
    if cfg.moe_num_experts and cfg.moe_layer_period != 1:
        later.append("MoE on every k-th layer")
    if cfg.ssm_state_dim or cfg.attn_layer_period:
        later.append("SSM / hybrid stacks")
    if cfg.is_encoder_decoder:
        later.append("encoder-decoder")
    if cfg.sliding_window > 0:
        later.append("sliding-window attention")
    if cfg.tie_embeddings:
        later.append("tied embeddings")
    if later:
        raise NotImplementedError(
            f"{cfg.name}: {', '.join(later)} not ported yet; the port runs uniform GQA "
            "stacks (dense or MoE), and the later slices of ROADMAP Queue 1 item 13 bring "
            "the rest"
        )


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
    if cfg.moe_num_experts:
        changes.update(moe_num_experts=4, moe_top_k=min(2, cfg.moe_top_k), moe_d_ff=64)
    changes.update(overrides)
    return dataclasses.replace(cfg, **changes)
