"""Model / input-shape configuration system.

Every assigned architecture gets a ``ModelConfig`` (full scale) plus a
``smoke_variant`` reduction (2 layers, d_model<=512, <=4 experts) that runs on
the CPU in tests.  Pure data, identical field for field to the JAX package's
configs, so a configuration means the same model in both.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Architecture description (pure data; consumed by repro_torch.models.transformer)."""

    name: str
    family: str                      # dense | moe | ssm | hybrid | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                # 0 -> d_model // num_heads

    # --- attention variants -------------------------------------------------
    qkv_bias: bool = False           # qwen1.5
    qk_norm: bool = False            # qwen3
    attn_window: Optional[int] = None          # native sliding window (mixtral)
    long_context_window: Optional[int] = None  # SWA used only for long_500k on
                                               # otherwise-full-attention archs
    rope_theta: float = 1e6
    mrope: bool = False              # qwen2-vl multimodal rope (t/h/w sections)
    mrope_sections: tuple = (16, 24, 24)  # head_dim/2 split

    # --- mlp -----------------------------------------------------------------
    mlp: str = "swiglu"              # swiglu | relu2 | gelu

    # --- moe -----------------------------------------------------------------
    num_experts: int = 0
    experts_per_token: int = 0
    moe_dense_residual: bool = False  # arctic: dense MLP in parallel w/ experts
    capacity_factor: float = 1.25

    # --- ssm / hybrid --------------------------------------------------------
    ssm_state: int = 0               # mamba2 state size (zamba2)
    ssm_head_dim: int = 64           # rwkv6/mamba2 per-head channel dim
    attn_every: int = 0              # zamba2: shared attn block every N layers
    ssm_expand: int = 2              # mamba2 d_inner = expand * d_model

    # --- enc-dec (whisper) ---------------------------------------------------
    encoder_layers: int = 0
    encoder_seq: int = 0             # 1500 frames for whisper

    # --- vlm -----------------------------------------------------------------
    vision_tokens: int = 0           # patch embeddings per image (stub frontend)

    # --- misc ----------------------------------------------------------------
    unroll_layers: bool = False      # python-loop layers (accurate HLO cost
                                     # accounting; scan hides trip counts)
    tie_embeddings: bool = False
    norm_eps: float = 1e-5
    dtype: str = "bfloat16"
    source: str = ""                 # citation bracket from the assignment

    def __post_init__(self):
        if self.head_dim == 0 and self.num_heads:
            object.__setattr__(self, "head_dim", self.d_model // self.num_heads)
        assert self.num_heads % max(self.num_kv_heads, 1) == 0, self.name

    @property
    def q_per_kv(self) -> int:
        return self.num_heads // self.num_kv_heads if self.num_kv_heads else 0

    @property
    def torch_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    @property
    def attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def is_moe(self) -> bool:
        return self.num_experts > 0

    @property
    def d_inner(self) -> int:
        """Mamba2 inner width."""
        return self.ssm_expand * self.d_model

    # -- parameter count (for 6ND model-flops accounting) ---------------------
    def param_count(self, active_only: bool = False) -> int:
        D, F, V, L = self.d_model, self.d_ff, self.vocab_size, self.num_layers
        hd, H, K = self.head_dim, self.num_heads, self.num_kv_heads
        n = V * D  # embed
        if not self.tie_embeddings:
            n += D * V
        if self.family == "ssm":  # rwkv6
            heads = D // self.ssm_head_dim
            per_layer = (
                5 * D * D          # r,k,v,w,g projections (approx; w low-rank folded)
                + D * D            # output proj
                + 2 * D * F        # channel-mix
                + heads * self.ssm_head_dim  # u bonus
            )
            return n + L * per_layer
        if self.family == "hybrid":
            di, S = self.d_inner, self.ssm_state
            heads = di // self.ssm_head_dim
            mamba = (
                D * (2 * di + 2 * S + heads)  # in_proj -> x,z,B,C,dt
                + di * 4                      # conv (depthwise, width 4)
                + di * D                      # out proj
            )
            n_attn_blocks = 1  # shared/tied
            attn = D * (H + 2 * K) * hd + H * hd * D + 2 * D * F
            return n + L * (mamba + 2 * D * F // 2) + n_attn_blocks * attn

        attn = D * (H + 2 * K) * hd + H * hd * D
        if self.mlp == "swiglu":
            mlp_dense = 3 * D * F
        else:
            mlp_dense = 2 * D * F
        per_layer = attn + mlp_dense
        if self.is_moe:
            moe_mlp = 3 * D * F
            router = D * self.num_experts
            dense_part = attn + router
            if self.moe_dense_residual:
                dense_part += 3 * D * self.d_ff
            if active_only:
                per_layer = dense_part + self.experts_per_token * moe_mlp
            else:
                per_layer = dense_part + self.num_experts * moe_mlp
        total = n + L * per_layer
        if self.encoder_layers:
            total += self.encoder_layers * (D * 3 * D * hd // hd + 2 * D * F)
        return total


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """One of the four assigned input shapes."""

    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


TRAIN_4K = ShapeConfig("train_4k", 4096, 256, "train")
PREFILL_32K = ShapeConfig("prefill_32k", 32768, 32, "prefill")
DECODE_32K = ShapeConfig("decode_32k", 32768, 128, "decode")
LONG_500K = ShapeConfig("long_500k", 524288, 1, "decode")

SHAPES = {s.name: s for s in (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)}


def smoke_variant(cfg: ModelConfig) -> ModelConfig:
    """Reduced config of the same family: 2 layers, d_model<=512, <=4 experts."""
    d_model = min(cfg.d_model, 256)
    head_dim = 32
    num_heads = max(2, d_model // 64)
    num_kv_heads = max(1, num_heads // max(1, cfg.q_per_kv)) if cfg.num_kv_heads else 0
    if cfg.family == "ssm":
        num_heads = num_kv_heads = 0
        d_model = 128
    changes = dict(
        name=cfg.name + "-smoke",
        num_layers=2,
        d_model=d_model,
        num_heads=num_heads or 4,
        num_kv_heads=num_kv_heads or (4 if cfg.family != "ssm" else 4),
        head_dim=head_dim,
        d_ff=min(cfg.d_ff, 512),
        vocab_size=min(cfg.vocab_size, 1024),
        num_experts=min(cfg.num_experts, 4) if cfg.num_experts else 0,
        experts_per_token=min(cfg.experts_per_token, 2) if cfg.num_experts else 0,
        # dropless at smoke scale: capacity covers the all-tokens-to-one-expert
        # worst case, so prefill+decode exactly reproduces full-seq forward
        capacity_factor=float(max(cfg.capacity_factor,
                                  min(cfg.num_experts, 4))) if cfg.num_experts
        else cfg.capacity_factor,
        encoder_layers=2 if cfg.encoder_layers else 0,
        encoder_seq=min(cfg.encoder_seq, 64) if cfg.encoder_seq else 0,
        vision_tokens=min(cfg.vision_tokens, 16) if cfg.vision_tokens else 0,
        attn_every=2 if cfg.attn_every else 0,
        attn_window=min(cfg.attn_window, 32) if cfg.attn_window else None,
        ssm_state=min(cfg.ssm_state, 16) if cfg.ssm_state else 0,
        ssm_head_dim=32 if cfg.ssm_head_dim else 0,
        dtype="float32",  # CPU smoke runs in f32 for numerics
    )
    if cfg.family == "ssm":
        changes["num_heads"] = 4
        changes["num_kv_heads"] = 4
    if cfg.mrope:
        # rescale the t/h/w frequency sections to the reduced head_dim
        full = sum(cfg.mrope_sections)
        scale = (head_dim // 2) / full
        s0 = int(cfg.mrope_sections[0] * scale)
        s1 = int(cfg.mrope_sections[1] * scale)
        changes["mrope_sections"] = (s0, s1, head_dim // 2 - s0 - s1)
    return dataclasses.replace(cfg, **changes)
