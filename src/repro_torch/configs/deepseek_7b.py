"""DeepSeek-7B: llama-architecture dense model, full MHA. [arXiv:2401.02954]"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-7b",
    family="dense",
    num_layers=30,
    d_model=4096,
    num_heads=32,
    num_kv_heads=32,
    d_ff=11008,
    vocab_size=102400,
    norm_type="rmsnorm",
    mlp_type="swiglu",
    source="arXiv:2401.02954",
)
