"""qwen3-8b [dense] — qk_norm, GQA kv=8.

[hf:Qwen/Qwen3-8B]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-8b",
    family="dense",
    num_layers=36,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    d_ff=12288,
    vocab_size=151936,
    qk_norm=True,
    long_context_window=4096,
    source="hf:Qwen/Qwen3-8B",
)
