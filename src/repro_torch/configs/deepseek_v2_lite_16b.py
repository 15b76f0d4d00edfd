"""DeepSeek-V2-Lite (16B total / 2.4B active): MLA attention (kv_lora_rank=512,
decoupled RoPE) and MoE with 2 shared and 64 routed experts, top-6.
[arXiv:2405.04434]

One deviation from the released model, inherited from the reference package
and kept so that both compute the same function: the released model keeps
layer 0 dense; here every one of the 27 layers is MoE (the stack stays
uniform; the parameter count moves by under 1 %).
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v2-lite-16b",
    family="moe",
    num_layers=27,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,  # MLA: one shared latent; per head after up-projection
    d_ff=1408,  # routed expert hidden size
    vocab_size=102400,
    use_mla=True,
    kv_lora_rank=512,
    q_lora_rank=0,  # v2-lite has no query compression
    qk_nope_dim=128,
    qk_rope_dim=64,
    v_head_dim=128,
    moe_num_experts=64,
    moe_top_k=6,
    moe_d_ff=1408,
    moe_num_shared=2,
    norm_type="rmsnorm",
    mlp_type="swiglu",
    source="arXiv:2405.04434",
)
