"""Whisper-base: encoder-decoder; the conv audio front end is a stub: the
encoder takes precomputed 512-wide frame embeddings, 1500 of them (30 s of
audio at 50 frames a second).  ``seq_len`` of a shape is the decoder's
length.  [arXiv:2212.04356]"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-base",
    family="encdec",
    num_layers=6,  # decoder layers
    num_encoder_layers=6,
    d_model=512,
    num_heads=8,
    num_kv_heads=8,
    d_ff=2048,
    vocab_size=51865,
    is_encoder_decoder=True,
    encoder_seq_len=1500,
    norm_type="layernorm",
    mlp_type="gelu",
    frontend="audio_stub",
    source="arXiv:2212.04356",
)
