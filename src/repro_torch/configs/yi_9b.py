"""yi-9b [dense] — llama-arch GQA kv=4.

[arXiv:2403.04652]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="yi-9b",
    family="dense",
    num_layers=48,
    d_model=4096,
    num_heads=32,
    num_kv_heads=4,
    d_ff=11008,
    vocab_size=64000,
    long_context_window=4096,
    source="arXiv:2403.04652",
)
