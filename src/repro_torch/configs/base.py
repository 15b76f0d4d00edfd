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

    def num_params(self) -> int:
        """The reference's analytic parameter count, for the dense uniform
        stacks the port runs (it counts one scale vector per norm)."""
        check_supported(self)
        d, V, hd = self.d_model, self.padded_vocab, self.resolved_head_dim
        attn = d * self.num_heads * hd * 2 + 2 * d * self.num_kv_heads * hd
        ffn = (3 if self.mlp_type == "swiglu" else 2) * d * self.d_ff
        return 2 * V * d + self.num_layers * (attn + ffn + 2 * d)


def check_supported(cfg: ModelConfig) -> None:
    """Raise ``NotImplementedError`` for what the port does not run yet: it
    carries the dense uniform GQA stack (ROADMAP Queue 1 item 13 lists the
    rest and the slice that brings it)."""
    later = []
    if cfg.family != "dense":
        later.append(f"family {cfg.family!r}")
    if cfg.use_mla:
        later.append("MLA")
    if cfg.moe_num_experts:
        later.append("MoE")
    if cfg.ssm_state_dim or cfg.attn_layer_period:
        later.append("SSM / hybrid stacks")
    if cfg.is_encoder_decoder:
        later.append("encoder-decoder")
    if cfg.sliding_window > 0:
        later.append("sliding-window attention")
    if cfg.use_qk_norm:
        later.append("QK-norm")
    if cfg.tie_embeddings:
        later.append("tied embeddings")
    if later:
        raise NotImplementedError(
            f"{cfg.name}: {', '.join(later)} not ported yet; the port runs dense GQA "
            "stacks, and the later slices of ROADMAP Queue 1 item 13 bring the rest"
        )


def smoke(cfg: ModelConfig, **overrides) -> ModelConfig:
    """Reduced same-family config for CPU tests (tiny widths, real structure),
    as the reference's ``smoke`` makes it for a dense stack."""
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
    changes.update(overrides)
    return dataclasses.replace(cfg, **changes)
