"""StableLM-2-1.6B: dense MHA (kv=32), LayerNorm, partial rotary (25%).
[hf:stabilityai/stablelm-2-1_6b]"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="stablelm-1.6b",
    family="dense",
    num_layers=24,
    d_model=2048,
    num_heads=32,
    num_kv_heads=32,  # full MHA
    d_ff=5632,
    vocab_size=100352,
    norm_type="layernorm",
    mlp_type="swiglu",
    rope_fraction=0.25,  # partial rotary
    source="hf:stabilityai/stablelm-2-1_6b",
)
