"""Jamba-1.5-Large (398B total): hybrid Mamba + attention in a 1:7
interleave with MoE (16 experts, top-2) on every second layer.  72 layers =
9 super-blocks of 8 (attention at block position 0, SSM elsewhere; MoE at
odd positions).

As in the reference, the SSM layers are the SSD (mamba2-style) mixer of
``models/ssm.py`` where Jamba uses Mamba-1 internals: the same 1:7
interleave, the same MoE.  [arXiv:2403.19887]"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="jamba-1.5-large-398b",
    family="hybrid",
    num_layers=72,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,  # GQA on the attention layers
    d_ff=24576,
    vocab_size=65536,
    moe_num_experts=16,
    moe_top_k=2,
    moe_d_ff=24576,
    moe_layer_period=2,  # MoE every 2nd layer
    attn_layer_period=8,  # attention every 8th layer (1:7 with mamba)
    attn_layer_offset=0,
    ssm_state_dim=128,
    ssm_head_dim=64,  # d_inner = 16384 -> 256 SSD heads
    ssm_expand=2,
    norm_type="rmsnorm",
    mlp_type="swiglu",
    source="arXiv:2403.19887",
)
