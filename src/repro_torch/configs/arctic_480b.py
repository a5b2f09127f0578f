"""arctic-480b [moe] — 128 experts top-2 + dense residual.

[hf:Snowflake/snowflake-arctic-base]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="arctic-480b",
    family="moe",
    num_layers=35,
    d_model=7168,
    num_heads=56,
    num_kv_heads=8,
    d_ff=4864,
    vocab_size=32000,
    num_experts=128,
    experts_per_token=2,
    moe_dense_residual=True,
    long_context_window=4096,
    source="hf:Snowflake/snowflake-arctic-base",
)
