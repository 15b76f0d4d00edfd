"""H2O-Danube-1.8B: llama and mistral mixed, with sliding-window attention.
The window makes a long decode sub-quadratic.  [arXiv:2401.16818]"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="h2o-danube-1.8b",
    family="dense",
    num_layers=24,
    d_model=2560,
    num_heads=32,
    num_kv_heads=8,  # GQA
    d_ff=6912,
    vocab_size=32000,
    sliding_window=4096,  # mistral-style SWA
    norm_type="rmsnorm",
    mlp_type="swiglu",
    source="arXiv:2401.16818",
)
