"""Chameleon-34B: early-fusion mixed-modal transformer (VQ image tokens share
the text vocabulary, so the modality front end is the embedding table
itself; the VQ tokenizer is a stub, as in the reference).  [arXiv:2405.09818]"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="chameleon-34b",
    family="vlm",
    num_layers=48,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,  # GQA
    d_ff=22016,
    vocab_size=65536,
    use_qk_norm=True,  # Chameleon's QK-norm stabilizer
    norm_type="rmsnorm",
    mlp_type="swiglu",
    frontend="vq_stub",
    source="arXiv:2405.09818",
)
