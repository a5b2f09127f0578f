"""The K1-K4 wrappers' planners: which kernel path each call takes.

Pure Python, so the choice the card will make is checked here on the CPU:
every dense() shape of every config gets a tensor-core or stream path in
bf16, the D-splits cover D exactly, and float32 always takes the FMA path;
K2's cache splits come from the static shapes alone and cover the cache
once; every moe config's prefill takes K4's wgmma path and its decode the
mma path, whose D splits come from the static shapes alone and cover D
once; K5's column slices come from (B, H, dh, SMs) alone; K1's backward
takes its tensor-core path for the model's bf16 layouts, and splits its dq
pass over the kv range from the static shapes alone; K4's backward takes
wgmma for dx and dw in bf16 at every moe config's training C, and K5's
backward slices its columns and chunks its time from the shapes alone and
puts rwkv6-3b's training shape in one wave; K4's bf16 dx cuts the live
(tile, k-step) space into equal shares for its blocks, each covered once,
with a workspace sized from the grid alone; the constants these planners
share with the kernel sources agree with them.
"""

import inspect
import re

import pytest
import torch

from repro_torch.configs import ARCHS, get_arch
from repro_torch.kernels import decode_attention as k2
from repro_torch.kernels import flash_attention as k1
from repro_torch.kernels import flash_attention_bwd as k1b
from repro_torch.kernels import int8_matmul as k3
from repro_torch.kernels import moe_gmm as k4
from repro_torch.kernels import moe_gmm_bwd as k4b
from repro_torch.kernels import rwkv6_scan as k5
from repro_torch.kernels import rwkv6_scan_bwd as k5b
from repro_torch.models.moe import capacity

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


@pytest.mark.parametrize("dh", [32, 64, 80, 128])
def test_flash_plan(dh):
    B, S, H, K = 2, 130, 4, 2
    q = torch.zeros(B, S, H, dh, dtype=torch.bfloat16).transpose(1, 2)
    k = torch.zeros(B, S, K, dh, dtype=torch.bfloat16).transpose(1, 2)
    assert k1.plan_call(q, k, k) == "mma"          # the model's (B, S, heads, dh) views
    qf, kf = q.float(), k.float()
    assert k1.plan_call(qf, kf, kf) == "fma"       # float32: true float32
    odd = torch.zeros(B, S, H, dh + 1, dtype=torch.bfloat16)[..., :dh].transpose(1, 2)
    assert k1.plan_call(odd, k, k) == "fma"        # rows not 16-byte aligned


@pytest.mark.parametrize("dh", [32, 64, 80, 128])
def test_flash_bwd_plan(dh):
    """The backward's path from q, k, v, o and do: the model's bf16 views
    (o as K1 forward returns it, do as autograd hands it over) take "mma"."""
    B, S, H, K = 2, 130, 4, 2
    q = torch.zeros(B, S, H, dh, dtype=torch.bfloat16).transpose(1, 2)
    k = torch.zeros(B, S, K, dh, dtype=torch.bfloat16).transpose(1, 2)
    o = torch.zeros(B, S, H, dh, dtype=torch.bfloat16).transpose(1, 2)
    do = torch.zeros(B, H, S, dh, dtype=torch.bfloat16)   # a contiguous gradient
    assert k1b.plan_call(q, k, k, o, do) == "mma"
    assert k1b.plan(torch.bfloat16, True) == "mma"
    f = [t.float() for t in (q, k, k, o, do)]
    assert k1b.plan_call(*f) == "fma"                      # float32: true float32
    assert k1b.plan(torch.float32, True) == "fma"
    odd = torch.zeros(B, S, H, dh + 1, dtype=torch.bfloat16)[..., :dh].transpose(1, 2)
    for i in range(5):                                     # any one operand's rows unaligned
        ts = [q, k, k, o, do]
        ts[i] = odd if i in (0, 3, 4) else odd[:, :K]
        assert k1b.plan_call(*ts) == "fma"
    shifted = torch.zeros(B * S * H * dh + 4, dtype=torch.bfloat16)[4:].view(B, S, H, dh)
    assert k1b.plan_call(q, k, k, o, shifted.transpose(1, 2)) == "fma"   # base 8 bytes in


# (B, H, Sq, T) of the four training shapes of chip_smoke.py's TRAIN_ATTN_CASES
TRAIN_BWD_SHAPES = {"minitron-4b": (2, 24, 512, 512), "zamba2-2.7b": (2, 32, 512, 512),
                    "whisper-small encoder": (2, 12, 1500, 1500),
                    "whisper-small cross": (2, 12, 64, 1500)}


def _dq_plan_covers(p, T):
    assert p.splits >= 1 and p.chunk % k1b.TILE == 0
    assert p.splits * p.chunk >= T > (p.splits - 1) * p.chunk   # no empty split


@pytest.mark.parametrize("what", sorted(TRAIN_BWD_SHAPES))
def test_flash_bwd_dq_plan_at_the_training_shapes(what):
    """One split where the q tiles fill the card (minitron's 384 blocks);
    whisper's cross attention (24 blocks) is split to fill it.  The plan sees
    the static shapes and the SM count, never a tensor."""
    assert list(inspect.signature(k1b.dq_plan).parameters) == ["B", "H", "Sq", "T", "sms"]
    B, H, Sq, T = TRAIN_BWD_SHAPES[what]
    p = k1b.dq_plan(B, H, Sq, T, SMS)
    _dq_plan_covers(p, T)
    blocks = B * H * -(-Sq // k1b.TILE)
    if what == "whisper-small cross":
        assert blocks == 24 and p.splits >= 2 and blocks * p.splits >= SMS
    else:
        assert p == k1b.DqPlan(1, -(-T // k1b.TILE) * k1b.TILE)


@pytest.mark.parametrize("B,H,Sq,T", [(1, 1, 1, 1), (1, 2, 64, 1500), (2, 12, 64, 1500),
                                      (1, 4, 130, 130), (3, 5, 64, 65), (2, 32, 512, 512),
                                      (1, 1, 64, 100000)])
@pytest.mark.parametrize("sms", [132, 114, 8])
def test_flash_bwd_dq_plan(B, H, Sq, T, sms):
    p = k1b.dq_plan(B, H, Sq, T, sms)
    _dq_plan_covers(p, T)
    blocks, kv_tiles = B * H * -(-Sq // k1b.TILE), -(-T // k1b.TILE)
    if blocks >= sms:
        assert p.splits == 1
    else:   # enough blocks to fill the card, where the kv range has the tiles for them
        assert blocks * p.splits >= min(k1b.BLOCKS_PER_SM * sms, blocks * kv_tiles) // 2
        assert blocks * p.splits <= max(k1b.BLOCKS_PER_SM * sms + blocks, blocks)


@pytest.mark.parametrize("B,K,S", [(1, 1, 1), (1, 1, 32), (2, 2, 33), (3, 4, 96),
                                   (4, 8, 544), (4, 8, 1024), (64, 8, 4096),
                                   (128, 8, 1024), (1, 8, 32768)])
@pytest.mark.parametrize("sms", [132, 114, 8])
def test_decode_split_plan(B, K, S, sms):
    # the plan sees the static shapes and the SM count, never the lengths, so
    # one captured graph serves every replay while the lengths grow
    assert list(inspect.signature(k2.plan).parameters) == ["B", "K", "S", "sms"]
    p = k2.plan(B, K, S, sms)
    assert p.splits >= 1 and p.chunk % k2.TILE == 0
    # the splits cover [0, S) exactly once, and none of them is empty
    spans = [range(s * p.chunk, min((s + 1) * p.chunk, S)) for s in range(p.splits)]
    assert [i for span in spans for i in span] == list(range(S))
    assert all(len(span) > 0 for span in spans)
    # enough blocks to fill the card, where the cache has the tiles for them
    tiles = -(-S // k2.TILE)
    assert 2 * B * K * p.splits >= min(k2.BLOCKS_PER_SM * sms, B * K * tiles)


def test_decode_split_plan_at_the_serve_shape():
    """minitron-4b and mixtral-8x7b decode: B = 4, K = 8, max_seq 1024."""
    assert k2.plan(4, 8, 1024, 132) == k2.Plan(32, 32)    # 1024 blocks of one tile


def test_flash_plan_at_zamba2s_layout():
    """zamba2-2.7b's shared block at prefill: bf16 q/k/v as (B, S, 32, 80)
    views of its projections (160-byte rows) take the tensor-core path."""
    cfg = ARCHS["zamba2-2.7b"]
    B, S, H, dh = 4, 512, cfg.num_heads, cfg.head_dim
    assert dh == 80 and dh in k1.HEAD_DIMS and dh in k2.HEAD_DIMS
    q = torch.empty(B, S, H * dh, dtype=torch.bfloat16, device="meta")
    q = q.view(B, S, H, dh).transpose(1, 2)
    assert k1.plan(q.dtype, all(s % 8 == 0 for s in k1._bsh(q))) == "mma"


@pytest.mark.parametrize("B,K,S,want", [
    (4, 32, 1024, k2.Plan(8, 128)),    # zamba2-2.7b decode, max_seq 1024
    (4, 12, 448, k2.Plan(14, 32)),     # whisper-small self attention, max_seq 448
    (4, 12, 1500, k2.Plan(16, 96)),    # whisper-small cross attention, 1500 frames
])
def test_decode_split_plan_at_the_new_serve_shapes(B, K, S, want):
    assert k2.plan(B, K, S, 132) == want


MOE_ARCHS = sorted(name for name, cfg in ARCHS.items() if cfg.num_experts)


def _moe_operands(E, C, D, F, dtype):
    """The model's layouts, without memory: the (E, C, D) view of the
    (E*C + 1, D) dispatch buffer, and a contiguous weight."""
    buf = torch.empty((E * C + 1, D), dtype=dtype, device="meta")
    return buf[: E * C].view(E, C, D), torch.empty((E, D, F), dtype=dtype, device="meta")


@pytest.mark.parametrize("name", MOE_ARCHS + [n + "-smoke" for n in MOE_ARCHS])
def test_moe_gmm_plan_every_config(name):
    cfg = get_arch(name)
    E, k, cf = cfg.num_experts, cfg.experts_per_token, cfg.capacity_factor
    prefill_c = capacity(4 * 512, E, k, cf)      # the serve's batch of 4 x 512 tokens
    decode_c = capacity(4, E, k, cf)             # one token of each of 4 sequences
    assert decode_c == 8
    for D, F in ((cfg.d_model, cfg.d_ff), (cfg.d_ff, cfg.d_model)):   # gate/up, down
        x, w = _moe_operands(E, prefill_c, D, F, torch.bfloat16)
        assert k4.plan_call(x, w).path == "wgmma", (name, prefill_c, D, F)
        x, w = _moe_operands(E, decode_c, D, F, torch.bfloat16)
        assert k4.plan_call(x, w).path == "mma"
        for C in (prefill_c, decode_c):
            assert k4.plan(E, C, D, F, torch.float32).path == "fma"
            assert k4.plan(E, C, D, F, torch.bfloat16, tma_ok=False).path == "wmma"


@pytest.mark.parametrize("layout", ["row_stride", "base", "expert_stride"])
def test_moe_gmm_plan_unaligned_is_not_wgmma(layout):
    E, C, D, F = 2, 64, 64, 128
    w = torch.zeros(E, D, F, dtype=torch.bfloat16)
    if layout == "row_stride":     # rows 68 elements apart: not a multiple of 16 bytes
        x = torch.zeros(E * C, D + 4, dtype=torch.bfloat16)[:, :D].view(E, C, D)
    elif layout == "base":         # the first element 8 bytes into the buffer
        x = torch.zeros(E * C * D + 4, dtype=torch.bfloat16)[4:].view(E, C, D)
    else:                          # experts overlap: a stride below C rows
        x = torch.zeros(E * C * D, dtype=torch.bfloat16).as_strided((E, C, D), (C * D // 2, D, 1))
    assert not k4.tma_addressable(x, w)
    assert k4.plan_call(x, w).path == "wmma"
    assert k4.plan_call(torch.zeros(E, C, D, dtype=torch.bfloat16), w).path == "wgmma"


def test_moe_gmm_wgmma_grid():
    assert k4.wgmma_grid(8, 640, 14336, 132) == 132     # persistent: one block per SM
    assert k4.wgmma_grid(1, 40, 64, 132) == 1           # never more blocks than tiles


@pytest.mark.parametrize("name", MOE_ARCHS + [n + "-smoke" for n in MOE_ARCHS])
@pytest.mark.parametrize("sms", [132, 114, 8])
def test_moe_gmm_decode_split_plan_every_config(name, sms):
    """K4's D splits, for every moe config's decode and prefill C, from the
    static shapes and the SM count: never from group_sizes, so one captured
    graph serves every step whoever the experts are."""
    assert list(inspect.signature(k4.plan).parameters) == ["E", "C", "D", "F", "dtype",
                                                           "tma_ok", "sms"]
    cfg = get_arch(name)
    E, k, cf = cfg.num_experts, cfg.experts_per_token, cfg.capacity_factor
    for C in (capacity(4, E, k, cf), capacity(4 * 512, E, k, cf)):
        for D, F in ((cfg.d_model, cfg.d_ff), (cfg.d_ff, cfg.d_model)):
            x, w = _moe_operands(E, C, D, F, torch.bfloat16)
            p = k4.plan_call(x, w, sms)
            if C > k4.MMA_MAX_C:            # prefill: wgmma, no split
                assert p == k4.Plan("wgmma", 1, D)
                continue
            assert p.path == "mma" and p.k_per_split % k4.MMA_BK == 0
            _covers(p, D)
            steps = -(-D // k4.MMA_BK)
            assert p.splits == 1 or p.k_per_split >= k4.MMA_MIN_STAGES * k4.MMA_BK
            # the items of min(E, C) live experts fill the card, where D has
            # the stages for them
            items = k4.mma_grid(E, C, F, p)
            n_tiles = -(-F // k4.MMA_BN)
            assert items == min(E, C) * n_tiles * p.splits
            assert items >= min(k4.MMA_ITEMS_PER_SM * sms,
                                min(E, C) * n_tiles * (steps // k4.MMA_MIN_STAGES))


@pytest.mark.parametrize("E,C,D,F", [(8, 8, 14336, 4096), (8, 8, 4096, 14336),
                                     (128, 8, 7168, 4864), (2, 32, 64, 48), (8, 8, 2056, 264),
                                     (3, 12, 1032, 136)])
def test_moe_gmm_decode_split_plan_shapes(E, C, D, F):
    p = k4.plan(E, C, D, F, torch.bfloat16)
    assert p.path == "mma"
    _covers(p, D)
    assert p.splits * p.k_per_split - D < p.k_per_split   # no empty split


def test_moe_gmm_decode_split_plan_at_the_serve_shapes():
    """mixtral-8x7b's decode: down 5 splits of 2880 (1280 blocks), gate/up 2
    of 2048; arctic-480b's gate/up 4 of 1792."""
    assert k4.plan(8, 8, 14336, 4096, torch.bfloat16) == k4.Plan("mma", 5, 2880)
    assert k4.plan(8, 8, 4096, 14336, torch.bfloat16) == k4.Plan("mma", 2, 2048)
    assert k4.plan(128, 8, 7168, 4864, torch.bfloat16) == k4.Plan("mma", 4, 1792)
    assert k4.mma_grid(8, 8, 4096, k4.plan(8, 8, 14336, 4096, torch.bfloat16)) == 1280


SSM_HEADS = sorted({(cfg.d_model // cfg.ssm_head_dim, cfg.ssm_head_dim)
                    for name in ARCHS for cfg in (get_arch(name), get_arch(name + "-smoke"))
                    if cfg.family == "ssm"})


@pytest.mark.parametrize("H,dh", SSM_HEADS + [(40, 16), (40, 32), (2, 16), (3, 32)])
@pytest.mark.parametrize("B", [1, 4, 64])
@pytest.mark.parametrize("sms", [132, 8])
def test_rwkv6_scan_plan(H, dh, B, sms):
    """K5's column slices from (B, H, dh, SMs) alone: never from T or the
    state, so prefill and every decode step of a batch share one plan."""
    assert list(inspect.signature(k5.plan).parameters) == ["B", "H", "dh", "sms"]
    p = k5.plan(B, H, dh, sms)
    assert p.jb in k5.COLUMN_SLICES and p.jb <= min(dh, 32) and dh % p.jb == 0
    assert p.row_groups * k5.ROWS_PER_GROUP == dh and p.row_groups in (1, 2, 4)
    assert p.jb * p.row_groups <= 256       # threads of one block
    blocks = B * H * (dh // p.jb)
    # the widest slice that gives every SM BLOCKS_PER_SM blocks, else 8 columns
    if blocks >= k5.BLOCKS_PER_SM * sms:
        assert p.jb == min(dh, 32) or B * H * (dh // (2 * p.jb)) < k5.BLOCKS_PER_SM * sms
    else:
        assert p.jb == 8


def test_rwkv6_scan_plan_at_the_serve_shape():
    """rwkv6-3b at B = 4: 40 heads of 64 in 32-column slices, 320 blocks of
    4 row groups."""
    assert k5.plan(4, 40, 64, 132) == k5.Plan(32, 4)


@pytest.mark.parametrize("name", MOE_ARCHS + [n + "-smoke" for n in MOE_ARCHS])
@pytest.mark.parametrize("tokens", [2 * 512, 8 * 64, 2 * 32])
def test_moe_gmm_bwd_plan_every_config(name, tokens):
    """K4's backward at each moe config's training capacity (B 2 x S 512, a
    smoke batch, a short one): bf16 never reaches the FMA kernels (dx and dw
    on wgmma at every C), and the model's operands are tensor maps (x the
    dispatch buffer's view, dy from autograd contiguous); float32 takes fma
    for both."""
    assert list(inspect.signature(k4b.plan).parameters) == ["dtype"]
    cfg = get_arch(name)
    E = cfg.num_experts
    C = capacity(tokens, E, cfg.experts_per_token, cfg.capacity_factor)
    for D, F in ((cfg.d_model, cfg.d_ff), (cfg.d_ff, cfg.d_model)):   # gate/up, down
        x, w = _moe_operands(E, C, D, F, torch.bfloat16)
        dy = torch.empty((E, C, F), dtype=torch.bfloat16, device="meta")
        assert E <= k4b.DX_MAX_E and k4._map_ok(w) and k4._map_ok(dy), (name, C, D, F)
        assert k4._map_ok(x), (name, C, D, F)
        assert k4b.plan_call(x, w, dy) == k4b.Plan("wgmma", "wgmma"), (name, C, D, F)
        x32, w32 = _moe_operands(E, C, D, F, torch.float32)
        assert k4b.plan_call(x32, w32, dy.float()) == k4b.Plan("fma", "fma")


def test_moe_gmm_bwd_plan_at_the_training_shape():
    """mixtral-8x7b at B 2 x S 512: C 320, dx and dw on wgmma for gate/up and
    down, as at every C, and no mma path left; the plan reads no layout: a
    bf16 dy the tensor map cannot take is refused by the wrapper on the
    card, never sent down another path
    (tests/test_torch_cuda.py::test_moe_gmm_bwd_paths)."""
    assert capacity(1024, 8, 2, 1.25) == 320
    assert k4b.plan(torch.bfloat16) == k4b.Plan("wgmma", "wgmma")
    assert set(k4b.PATHS) == {"fma", "wgmma"}
    assert k4b.plan(torch.float32) == k4b.Plan("fma", "fma")
    # a dy the tensor map cannot take (experts 4 elements past a multiple of 8)
    dy = torch.zeros(2 * 64 * 128 + 4, dtype=torch.bfloat16).as_strided(
        (2, 64, 128), (64 * 128 + 4, 128, 1))
    x, w = torch.zeros(2, 64, 64, dtype=torch.bfloat16), torch.zeros(2, 64, 128,
                                                                      dtype=torch.bfloat16)
    assert not k4._map_ok(dy) and k4._map_ok(dy.contiguous())
    assert k4b.plan_call(x, w, dy) == k4b.plan_call(x, w, dy.contiguous())


@pytest.mark.parametrize("T", [1, 15, 16, 17, 512, 1000])
@pytest.mark.parametrize("dh", [16, 32, 64])
def test_rwkv6_scan_bwd_plan(T, dh):
    """K5 backward's blocks and chunks from (B, H, T, dh, SMs) alone:
    16-column slices covering dh, four threads a state row, one chunk per
    forward checkpoint, covering T once; the blocks an SM hold their shared
    bytes and threads, and the waves cover every block."""
    assert list(inspect.signature(k5b.plan).parameters) == ["B", "H", "T", "dh", "sms"]
    p = k5b.plan(2, 40, T, dh, SMS)
    assert p.jb * p.slices == dh and p.jb == 16 and p.threads == 4 * dh
    assert (p.chunks - 1) * k5.CHECKPOINT_EVERY < T <= p.chunks * k5.CHECKPOINT_EVERY
    assert k5.checkpoint_shape(2, 40, T, dh) == (2, 40, p.chunks, dh, dh)
    assert p.blocks_per_sm * (p.smem_bytes + 1024) <= 233_472
    assert p.blocks_per_sm * p.threads <= 2048
    assert (p.waves - 1) * p.blocks_per_sm * SMS < 2 * 40 * p.slices <= \
        p.waves * p.blocks_per_sm * SMS


def test_rwkv6_scan_bwd_plan_at_the_training_shape():
    """rwkv6-3b at B 2 x T 512: 40 heads of 64 in 4 slices (80 clusters of 4),
    320 blocks of 256 threads, 32 chunks of 16 steps (42 MB of checkpoints a
    layer); 8 held states, two buffers of a chunk's inputs and two of a
    half-chunk's partials are 73,728 shared bytes, so three blocks fit an
    SM: 396 slots for 320 blocks, one wave on 132 SMs (two rounds on 106 SMs
    or fewer)."""
    p = k5b.plan(2, 40, 512, 64, SMS)
    assert p == k5b.Plan(16, 4, 32, 256, 73_728, 3, 1)
    assert 3 * (73_728 + 1024) <= 233_472 < 4 * (73_728 + 1024)
    assert 2 * 40 * 32 * 64 * 64 * 4 == 41_943_040
    assert k5b.plan(2, 40, 512, 64, 106).waves == 2


def _check_dx_units(tiles, ktiles, grid):
    """dx_units covers every live (tile, k-step) once; each block runs its
    whole tiles, then at most one piece of a tile left over; a part does not
    start its tile and writes the block's one slot; a head starts its tile
    and lists the later blocks holding the rest of it, whose parts together
    end the tile; every tile left over is cut at the same k-steps.  Returns
    the k-steps of each block."""
    units = k4b.dx_units(tiles, ktiles, grid)
    s = k4b.dx_schedule(tiles, ktiles, grid)
    assert len(units) == grid
    seen, cuts = {}, {}
    for b, us in enumerate(units):
        assert [u.tile for u in us[:s.rounds]] == [r * grid + b for r in range(s.rounds)]
        assert all(u.kind == "whole" for u in us[:s.rounds]) and len(us) <= s.rounds + 1
        for u in us:
            assert 0 <= u.k0 < u.k1 <= ktiles and 0 <= u.tile < tiles
            assert (u.kind == "part") == (u.k0 > 0)
            assert (u.kind == "head") == (u.k0 == 0 and u.k1 < ktiles)
            for k in range(u.k0, u.k1):
                seen[u.tile, k] = seen.get((u.tile, k), 0) + 1
            if u.tile >= s.rounds * grid:
                cuts.setdefault(u.tile, []).append((u.k0, u.k1))
            if u.kind == "head":
                assert u.parts and list(u.parts) == list(range(b + 1, b + 1 + len(u.parts)))
                pieces = [(u.k0, u.k1)] + [next((v.k0, v.k1) for v in units[p]
                                                if v.tile == u.tile) for p in u.parts]
                assert [k1 for _, k1 in pieces[:-1]] == [k0 for k0, _ in pieces[1:]]
                assert pieces[-1][1] == ktiles
    assert len(seen) == tiles * ktiles and set(seen.values()) <= {1}
    assert len({tuple(c) for c in cuts.values()}) <= 1
    return [sum(u.k1 - u.k0 for u in us) for us in units]


@pytest.mark.parametrize("tiles,ktiles,grid", [
    (0, 224, 132), (1, 224, 132), (5, 3, 132), (40, 64, 132), (132, 64, 132),
    (133, 64, 132), (264, 224, 132), (320, 224, 132), (1120, 64, 132), (76, 56, 13),
    (9, 32, 5), (19, 63, 7)])
def test_moe_gmm_bwd_dx_units_cover_the_work_once(tiles, ktiles, grid):
    """The stream-K partition of dx for live tile counts of none, one, fewer
    than the blocks, a multiple of them, one more, and mixtral's: the tiles
    left after the full rounds in grid // left pieces (none below
    SK_MIN_STEPS k-steps), so no block runs more than its full rounds and
    the longest piece."""
    steps = _check_dx_units(tiles, ktiles, grid)
    rounds, rem = divmod(tiles, grid)
    pieces = max(1, min(grid // rem, ktiles // k4b.SK_MIN_STEPS)) if rem else 1
    assert k4b.dx_schedule(tiles, ktiles, grid)[:2] == (rounds, rem)
    assert max(steps) == rounds * ktiles + (-(-ktiles // pieces) if rem else 0)


@pytest.mark.parametrize("part,D,F", [("gate_up", 4096, 14336), ("down", 14336, 4096)])
def test_moe_gmm_bwd_dx_schedule_at_the_training_shape(part, D, F):
    """mixtral-8x7b's training dx on 132 SMs (C 320, a uniform router's 2048
    rows: 20 live row tiles): gate/up 320 tiles of 224 k-steps, two full
    rounds, then each of the 56 tiles left in two pieces of 112 on 112
    blocks: 560 k-steps a block at most (whole tiles: 672; cutting the
    12,544 k-steps left in 132 equal ranges would give ceil(71,680 / 132)
    = 544, but puts sibling tiles at different k-steps and measured slower,
    PERF.md); down 1120 tiles of 64, eight rounds, then 64 tiles in two
    pieces of 32 on 128 blocks: 544 = ceil(71,680 / 132) (whole tiles:
    576).  One partial tile a block at most, one slot each: the workspace
    is 132 slots of 128 KB and flags, within the 34 MB of two a block."""
    sizes = [266, 239, 249, 246, 286, 264, 239, 259]
    assert sum(-(-s // k4b.DX_BM) for s in sizes) == 20
    tiles, ktiles = 20 * -(-D // k4b.DX_BN), -(-F // k4b.DX_BK)
    assert tiles * ktiles == 71_680
    grid = k4b.dx_grid(8, 320, D, F, SMS)
    assert grid == SMS
    steps = _check_dx_units(tiles, ktiles, grid)
    assert max(steps) == {"gate_up": 560, "down": 544}[part]
    assert -(-tiles // SMS) * ktiles == {"gate_up": 672, "down": 576}[part]
    s = k4b.dx_schedule(tiles, ktiles, grid)
    assert s == {"gate_up": (2, 56, 2), "down": (8, 64, 2)}[part]
    assert k4b.workspace_bytes(grid) == 132 * (128 * 256 * 4 + 4) <= 2 * 132 * 128 * 256 * 4


@pytest.mark.parametrize("E,C,D,F,want", [
    (8, 320, 4096, 14336, 132), (8, 24, 128, 64, 8), (2, 32, 64, 48, 2), (1, 130, 256, 128, 4)])
def test_moe_gmm_bwd_dx_grid(E, C, D, F, want):
    """One block an SM, or one a k-step of every tile when fewer; from the
    static shapes alone."""
    assert list(inspect.signature(k4b.dx_grid).parameters) == ["E", "C", "D", "F", "sms"]
    assert k4b.dx_grid(E, C, D, F, SMS) == want


def _csrc(name):
    return (k4b.build.CSRC / name).read_text()


def _constants(text):
    return {m[0]: int(m[1]) for m in re.findall(r"constexpr int (\w+) = (\d+);", text)}


def test_rwkv6_scan_bwd_plan_matches_the_kernel_source():
    """The planner's constants are csrc/rwkv6_scan_bwd.cu's: steps a chunk,
    states held, columns a block and a thread, the shared bytes, and the
    launch bound that keeps three blocks' registers on an SM."""
    src = _csrc("rwkv6_scan_bwd.cu")
    c = _constants(src)
    assert c["CK"] == k5.CHECKPOINT_EVERY and c["HALF"] == k5b.HALF_CHUNK
    assert c["JB"] == k5b.COLUMN_SLICE and c["JB"] // c["QCOLS"] == k5b.THREADS_PER_ROW
    assert "__launch_bounds__(4 * DH, 3)" in src
    assert k5b.smem_bytes(64) == 4 * (c["HALF"] * 64 * c["JB"]
                                      + 2 * (3 * c["CK"] * 64 + 2 * c["CK"] * c["JB"])
                                      + 2 * 3 * c["HALF"] * 64)


def test_moe_gmm_bwd_dx_matches_the_kernel_source():
    """gmm_wgmma.cuh's dx constants are the wrapper's: tile, k-step, the
    shortest stream-K piece, a slot's size and the experts of its tile
    list; dx's 4-stage ring plus its 32 KB epilogue buffer (half a tile),
    barriers and expert list fit the 232,448 bytes a block may hold (a
    whole tile's buffer would not); the forward keeps its 4-stage ring,
    1024-expert list and whole-tile schedule; the fixup adds no atomics."""
    src = _csrc("gmm_wgmma.cuh")
    c = _constants(src)
    assert (c["W_BM"], c["W_BN"], c["W_BK"]) == (k4b.DX_BM, k4b.DX_BN, k4b.DX_BK)
    assert c["SK_MIN_STEPS"] == k4b.SK_MIN_STEPS and c["SK_MAX_E"] == k4b.DX_MAX_E
    assert "SK_PART_FLOATS = W_BM * W_BN;" in src and k4b.SK_PART_BYTES == 128 * 256 * 4
    assert "SK_OUT_BYTES = W_BM * W_BN;" in src
    stage = (c["W_BM"] + c["W_BN"]) * c["W_BK"] * 2
    tile = c["W_BM"] * c["W_BN"] * 2

    def smem(stages, buffer, experts):
        return stages * stage + buffer + 2 * stages * 8 + (experts + 1) * 4 + 1024

    assert ("SK_SMEM = SK_STAGES * (W_X_BYTES + W_W_BYTES) + SK_OUT_BYTES +\n"
            "                        2 * SK_STAGES * 8 + (SK_MAX_E + 1) * 4 + 1024;") in src
    assert c["SK_STAGES"] == 4
    assert smem(4, tile // 2, c["SK_MAX_E"]) == 231_492 <= 232_448 < smem(4, tile, c["SK_MAX_E"])
    assert smem(4, tile // 2, c["W_MAX_E"]) > 232_448
    assert c["W_STAGES"] == 4 and smem(c["W_STAGES"], 0, c["W_MAX_E"]) == 201_796
    assert c["W_MAX_E"] == k4.WGMMA_MAX_E
    assert "gmm_wgmma_body<false, false>" in _csrc("moe_gmm.cu")
    assert "gmm_wgmma_body<true, true>" in _csrc("moe_gmm_bwd.cu")
    assert "E > SK_MAX_E" in _csrc("moe_gmm_bwd.cu")
    for text in (src, _csrc("moe_gmm_bwd.cu")):
        code = re.sub(r"//[^\n]*", "", text)
        assert not re.search(r"\batomic\w*\s*\(|\batom\.|\bred\.", code)


def test_moe_gmm_bwd_matches_the_kernel_source():
    """csrc/moe_gmm_bwd.cu numbers its paths as the wrapper does, has no
    mma.sync dw left, stages dw's contraction in k-tiles of DW_BK rows, and
    its ring and epilogue buffer fit the 227 KB a block may hold."""
    src = _csrc("moe_gmm_bwd.cu")
    paths = {m[0].lower(): int(m[1]) for m in re.findall(r"#define GBWD_PATH_(\w+) (\d+)", src)}
    assert paths == k4b.PATHS
    assert "gmmbwd_mma" not in src and "mma_bf16" not in src
    c = _constants(src)
    assert c["DW_BK"] == k4b.DW_BK
    smem = c["DW_STAGES"] * (c["DW_BM"] + c["DW_BN"]) * c["DW_BK"] * 2 \
        + c["DW_BM"] * c["DW_BN"] * 2 + 2 * c["DW_STAGES"] * 8 + 1024
    assert smem == 214_064 <= 232_448
