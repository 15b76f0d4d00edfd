"""OLMoE-1B-7B: 64-expert top-8 MoE on every layer, QK-norm. [arXiv:2409.02060]

One deviation from the published model (allenai/OLMoE-1B-7B-0924), inherited
from the reference package and kept so that both compute the same function:
QK-norm here is an RMSNorm per head over ``head_dim`` (a ``[head_dim]``
scale shared by the heads), where the published model normalises the whole
``[heads * head_dim]`` projection with one scale per channel.
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="olmoe-1b-7b",
    family="moe",
    num_layers=16,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    d_ff=1024,
    vocab_size=50304,
    moe_num_experts=64,
    moe_top_k=8,
    moe_d_ff=1024,
    use_qk_norm=True,
    norm_type="rmsnorm",
    mlp_type="swiglu",
    source="arXiv:2409.02060",
)
