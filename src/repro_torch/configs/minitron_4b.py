"""minitron-4b [dense] — pruned nemotron (squared-relu MLP).

[arXiv:2407.14679]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="minitron-4b",
    family="dense",
    num_layers=32,
    d_model=3072,
    num_heads=24,
    num_kv_heads=8,
    d_ff=9216,
    vocab_size=256000,
    mlp="relu2",
    long_context_window=4096,
    source="arXiv:2407.14679",
)
