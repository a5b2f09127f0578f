"""The K1 and K3 wrappers' planners: which kernel path each call takes.

Pure Python, so the choice the card will make is checked here on the CPU:
every dense() shape of every config gets a tensor-core or stream path in
bf16, the D-splits cover D exactly, and float32 always takes the FMA path.
"""

import pytest
import torch

from repro_torch.configs import ARCHS
from repro_torch.kernels import flash_attention as k1
from repro_torch.kernels import int8_matmul as k3

SMS = 132   # one H100 SXM


def _dense_shapes(cfg):
    """(D, N) of every dense() weight of one layer: attention and the MLP."""
    shapes = set()
    if cfg.num_heads:
        q, kv = cfg.num_heads * cfg.head_dim, cfg.num_kv_heads * cfg.head_dim
        shapes |= {(cfg.d_model, q), (cfg.d_model, kv), (q, cfg.d_model)}
    if cfg.family != "ssm" and (not cfg.num_experts or cfg.moe_dense_residual):
        shapes |= {(cfg.d_model, cfg.d_ff), (cfg.d_ff, cfg.d_model)}
    return sorted(shapes)


CASES = [(name, M, D, N) for name, cfg in sorted(ARCHS.items())
         for (D, N) in _dense_shapes(cfg) for M in (1, 4, 2048)]


def _covers(p, D):
    assert p.splits >= 1 and p.k_per_split >= 1
    assert p.splits * p.k_per_split >= D > (p.splits - 1) * p.k_per_split


@pytest.mark.parametrize("name,M,D,N", CASES)
def test_int8_plan_every_config_shape(name, M, D, N):
    p = k3.plan(M, N, D, torch.bfloat16, SMS)
    assert p.path == ("stream" if M <= k3.STREAM_MAX_M else "wgmma"), (name, p)
    _covers(p, D)
    if p.path == "stream":
        assert p.k_per_split % 64 == 0 and p.k_per_split <= 4096
        assert p.tile >= M and p.tile in (1, 2, 4, 8)
        strips, groups = -(-N // 512), -(-D // 64)
        assert p.splits * strips >= min(SMS, strips * groups)   # the blocks fill the card
    else:
        assert p.splits == 1 and p.k_per_split == D
        tiles = -(-M // 128) * -(-N // 128)
        assert p.tile == (2 if tiles >= 2 * SMS else 1)   # blocks per SM
    f = k3.plan(M, N, D, torch.float32, SMS)
    assert f.path == "fma"
    _covers(f, D)


@pytest.mark.parametrize("M,D,N", [(1, 64, 32), (8, 520, 144), (9, 520, 144), (16, 64, 32),
                                   (300, 520, 136), (4, 256, 100), (2048, 100000, 48)])
def test_int8_plan_edges(M, D, N):
    p = k3.plan(M, N, D, torch.bfloat16, SMS)
    if N % 16:     # a w row stride TMA and the 16-byte stream loads cannot take
        assert p.path == "fma"
    else:
        assert p.path == ("stream" if M <= 8 else "wgmma")
    _covers(p, D)
    # x rows that are not 16-byte aligned cannot be TMA-copied
    assert k3.plan(M, N, D, torch.bfloat16, SMS, x_row_aligned=False).path in ("fma", "stream")
    assert k3.plan(M, N, D, torch.float32, SMS).path == "fma"


@pytest.mark.parametrize("dh", [32, 64, 128])
def test_flash_plan(dh):
    B, S, H, K = 2, 130, 4, 2
    q = torch.zeros(B, S, H, dh, dtype=torch.bfloat16).transpose(1, 2)
    k = torch.zeros(B, S, K, dh, dtype=torch.bfloat16).transpose(1, 2)
    assert k1.plan_call(q, k, k) == "mma"          # the model's (B, S, heads, dh) views
    qf, kf = q.float(), k.float()
    assert k1.plan_call(qf, kf, kf) == "fma"       # float32: true float32
    odd = torch.zeros(B, S, H, dh + 1, dtype=torch.bfloat16)[..., :dh].transpose(1, 2)
    assert k1.plan_call(odd, k, k) == "fma"        # rows not 16-byte aligned
