"""qwen1.5-110b [dense] — QKV bias, GQA kv=8.

[hf:Qwen/Qwen1.5-0.5B (family card)]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen1.5-110b",
    family="dense",
    num_layers=80,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    d_ff=49152,
    vocab_size=152064,
    qkv_bias=True,
    long_context_window=4096,
    source="hf:Qwen/Qwen1.5-0.5B",
)
