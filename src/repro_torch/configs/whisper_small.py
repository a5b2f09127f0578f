"""whisper-small [audio] — enc-dec backbone; mel+conv frontend stubbed.

[arXiv:2212.04356]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-small",
    family="audio",
    num_layers=12,              # decoder layers
    encoder_layers=12,
    encoder_seq=1500,           # conv-downsampled mel frames (stub supplies embeds)
    d_model=768,
    num_heads=12,
    num_kv_heads=12,            # MHA
    d_ff=3072,
    vocab_size=51865,
    mlp="gelu",
    rope_theta=0.0,             # whisper uses learned/sinusoidal positions, not rope
    source="arXiv:2212.04356",
)
