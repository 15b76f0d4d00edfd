"""StableLM-3B (stablelm-2 family): dense MHA, LayerNorm, partial rotary;
head dim 80.  [hf:stabilityai/stablelm-2 family]"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="stablelm-3b",
    family="dense",
    num_layers=32,
    d_model=2560,
    num_heads=32,
    num_kv_heads=32,
    d_ff=6912,
    vocab_size=50304,
    norm_type="layernorm",
    mlp_type="swiglu",
    rope_fraction=0.25,
    source="hf:stabilityai/stablelm-2-1_6b (3b sibling)",
)
