"""Architecture registry: ``--arch <id>`` resolution."""

from repro_torch.configs.base import (
    DECODE_32K,
    LONG_500K,
    PREFILL_32K,
    SHAPES,
    TRAIN_4K,
    ModelConfig,
    ShapeConfig,
    smoke_variant,
)

from repro_torch.configs.arctic_480b import CONFIG as _arctic
from repro_torch.configs.mixtral_8x7b import CONFIG as _mixtral
from repro_torch.configs.qwen15_110b import CONFIG as _qwen15
from repro_torch.configs.minitron_4b import CONFIG as _minitron
from repro_torch.configs.rwkv6_3b import CONFIG as _rwkv6
from repro_torch.configs.zamba2_2p7b import CONFIG as _zamba2
from repro_torch.configs.qwen3_8b import CONFIG as _qwen3
from repro_torch.configs.qwen2_vl_2b import CONFIG as _qwen2vl
from repro_torch.configs.yi_9b import CONFIG as _yi
from repro_torch.configs.whisper_small import CONFIG as _whisper

ARCHS = {
    c.name: c
    for c in (
        _arctic,
        _mixtral,
        _qwen15,
        _minitron,
        _rwkv6,
        _zamba2,
        _qwen3,
        _qwen2vl,
        _yi,
        _whisper,
    )
}


def get_arch(name: str) -> ModelConfig:
    if name.endswith("-smoke"):
        return smoke_variant(get_arch(name[: -len("-smoke")]))
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; choose from {sorted(ARCHS)}")
    return ARCHS[name]


def get_shape(name: str) -> ShapeConfig:
    if name not in SHAPES:
        raise KeyError(f"unknown shape {name!r}; choose from {sorted(SHAPES)}")
    return SHAPES[name]


def applicable(arch: ModelConfig, shape: ShapeConfig) -> bool:
    """Which (arch, shape) pairs run — see DESIGN.md §Arch-applicability."""
    if shape.name == "long_500k":
        if arch.family == "audio":
            return False  # enc-dec audio: 448-token decoder context, skip (DESIGN.md)
        # sub-quadratic required: SSM/hybrid native; attention archs need a window
        return (
            arch.attention_free
            or arch.family == "hybrid"
            or arch.attn_window is not None
            or arch.long_context_window is not None
        )
    return True


__all__ = [
    "ARCHS",
    "SHAPES",
    "ModelConfig",
    "ShapeConfig",
    "get_arch",
    "get_shape",
    "smoke_variant",
    "applicable",
    "TRAIN_4K",
    "PREFILL_32K",
    "DECODE_32K",
    "LONG_500K",
]
