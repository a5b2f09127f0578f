"""rwkv6-3b [ssm] — Finch, data-dependent decay; attention-free.

[arXiv:2404.05892]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-3b",
    family="ssm",
    num_layers=32,
    d_model=2560,
    num_heads=0,
    num_kv_heads=0,
    d_ff=8960,
    vocab_size=65536,
    ssm_head_dim=64,
    mlp="rwkv_channel_mix",
    source="arXiv:2404.05892",
)
