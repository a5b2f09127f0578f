"""mixtral-8x7b [moe] — 8 experts top-2, sliding-window attention.

[arXiv:2401.04088]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="mixtral-8x7b",
    family="moe",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    d_ff=14336,
    vocab_size=32000,
    num_experts=8,
    experts_per_token=2,
    attn_window=4096,           # native SWA -> long_500k is sub-quadratic
    source="arXiv:2401.04088",
)
