"""qwen2-vl-2b [vlm] — M-RoPE, dynamic resolution (vision tower stubbed).

[arXiv:2409.12191]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-2b",
    family="vlm",
    num_layers=28,
    d_model=1536,
    num_heads=12,
    num_kv_heads=2,
    d_ff=8960,
    vocab_size=151936,
    mrope=True,
    mrope_sections=(16, 24, 24),
    vision_tokens=256,          # patch embeddings supplied by the stub frontend
    long_context_window=4096,
    source="arXiv:2409.12191",
)
