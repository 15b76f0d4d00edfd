"""Mamba2-1.3B: attention-free SSM with state-space duality (SSD), O(1)
decode state.  [arXiv:2405.21060]"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-1.3b",
    family="ssm",
    num_layers=48,
    d_model=2048,
    vocab_size=50280,
    d_ff=0,  # attention-free, FFN-free (mamba block only)
    ssm_state_dim=128,
    ssm_head_dim=64,  # d_inner = 4096 -> 64 SSD heads
    ssm_expand=2,
    ssm_conv_width=4,
    ssm_chunk=256,
    norm_type="rmsnorm",
    tie_embeddings=True,  # mamba2 ties the input and output embeddings
    source="arXiv:2405.21060",
)
