"""The CUDA kernels on the card against their plain versions (GPU only).

Run on a machine with an NVIDIA Hopper GPU and nvcc:
    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
Without a GPU every test here skips.
"""

import numpy as np
import pytest
import torch

from repro_torch.configs import get_arch
from repro_torch.core.engines import CompiledEngine, EagerEngine
from repro_torch.kernels import decode_attention as k2
from repro_torch.kernels import flash_attention as k1
from repro_torch.kernels import flash_attention_bwd as k1b
from repro_torch.kernels import int8_matmul as k3
from repro_torch.kernels import moe_gmm as k4
from repro_torch.kernels import moe_gmm_bwd as k4b
from repro_torch.kernels import rwkv6_scan as k5
from repro_torch.kernels import ops, ref
from repro_torch.models import transformer as T
from repro_torch.models.attention import attention
from repro_torch.serving.formats import quantize_params

pytestmark = pytest.mark.cuda


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device="cuda")
    g.manual_seed(0)
    return g


def _tol(dtype):
    return dict(atol=2e-2, rtol=2e-2) if dtype == torch.bfloat16 else dict(
        atol=2e-4, rtol=2e-4)


@pytest.mark.parametrize("B,H,K,S,dh,window", [
    (2, 4, 2, 64, 32, None), (2, 6, 2, 96, 32, 17), (1, 8, 8, 130, 64, None),
    (1, 6, 2, 200, 128, 50)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_kernel(gen, B, H, K, S, dh, window, dtype):
    q = torch.randn(B, S, H, dh, generator=gen, device="cuda").to(dtype).transpose(1, 2)
    k = torch.randn(B, S, K, dh, generator=gen, device="cuda").to(dtype).transpose(1, 2)
    v = torch.randn(B, S, K, dh, generator=gen, device="cuda").to(dtype).transpose(1, 2)
    n = ops.launch_counts()["flash_attention"]
    got = ops.flash_attention(q, k, v, causal=True, window=window)
    assert ops.launch_counts()["flash_attention"] == n + 1
    torch.testing.assert_close(got, ref.flash_attention_ref(q, k, v, window=window),
                               **_tol(dtype))


@pytest.mark.parametrize("B,H,K,S,dh,window", [
    (2, 4, 2, 130, 32, None), (2, 4, 2, 200, 32, 33), (1, 6, 3, 130, 64, 50),
    (1, 4, 4, 200, 64, None), (2, 8, 2, 130, 128, 64), (1, 4, 1, 200, 128, None),
    (1, 2, 2, 200, 128, 1)])
def test_flash_attention_bf16_tensor_cores(gen, B, H, K, S, dh, window):
    """The mma path: ragged S (tiles past T and the causal diagonal), windows
    down to 1 (rows whose first kv tiles are wholly masked), GQA."""
    mk = lambda *shape: torch.randn(*shape, generator=gen, device="cuda").to(torch.bfloat16)
    q = mk(B, S, H, dh).transpose(1, 2)
    k, v = mk(B, S, K, dh).transpose(1, 2), mk(B, S, K, dh).transpose(1, 2)
    assert k1.plan_call(q, k, v) == "mma"
    got = ops.flash_attention(q, k, v, causal=True, window=window)
    torch.testing.assert_close(got, ref.flash_attention_ref(q, k, v, window=window),
                               **_tol(torch.bfloat16))
    # a layout the 16-byte copies cannot take goes to the fma kernel, same result
    odd = torch.randn(B, S, H, dh + 1, generator=gen, device="cuda").to(torch.bfloat16)
    qo = odd[..., :dh].transpose(1, 2)
    assert k1.plan_call(qo, k, v) == "fma"
    torch.testing.assert_close(ops.flash_attention(qo, k, v, causal=True, window=window),
                               ref.flash_attention_ref(qo, k, v, window=window),
                               **_tol(torch.bfloat16))


@pytest.mark.parametrize("B,K,G,S,dh", [(1, 1, 4, 64, 32), (3, 4, 1, 96, 64),
                                        (4, 8, 3, 300, 128)])
@pytest.mark.parametrize("window", [None, 16])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_attention_kernel(gen, B, K, G, S, dh, window, dtype):
    q = torch.randn(B, K, G, dh, generator=gen, device="cuda").to(dtype)
    kc = torch.randn(B, S, K, dh, generator=gen, device="cuda").to(dtype).transpose(1, 2)
    vc = torch.randn(B, S, K, dh, generator=gen, device="cuda").to(dtype).transpose(1, 2)
    lengths = (torch.arange(B, dtype=torch.int32, device="cuda") * 17 % S + 1)
    got = ops.decode_attention(q, kc, vc, lengths, window=window)
    torch.testing.assert_close(
        got, ref.decode_attention_ref(q, kc, vc, lengths, window=window), **_tol(dtype))


@pytest.mark.parametrize("G", range(1, 9))
@pytest.mark.parametrize("dh", [32, 64, 128])
@pytest.mark.parametrize("window", [None, 40])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_attention_split_kv(gen, G, dh, window, dtype):
    """The split-KV kernel at every group size and head dim: lengths 1, on a
    split boundary, one past it, and S; the window crosses split boundaries."""
    B, K, S = 4, 2, 192
    p = k2.plan(B, K, S, torch.cuda.get_device_properties(0).multi_processor_count)
    assert p.splits > 1 and p.splits * p.chunk >= S
    q = torch.randn(B, K, G, dh, generator=gen, device="cuda").to(dtype)
    kc = torch.randn(B, S, K, dh, generator=gen, device="cuda").to(dtype).transpose(1, 2)
    vc = torch.randn(B, S, K, dh, generator=gen, device="cuda").to(dtype).transpose(1, 2)
    lengths = torch.tensor([1, 2 * p.chunk, 2 * p.chunk + 1, S], dtype=torch.int32,
                           device="cuda")
    n = ops.launch_counts()["decode_attention"]
    got = ops.decode_attention(q, kc, vc, lengths, window=window)
    assert ops.launch_counts()["decode_attention"] == n + 1
    torch.testing.assert_close(
        got, ref.decode_attention_ref(q, kc, vc, lengths, window=window), **_tol(dtype))


def test_decode_attention_in_a_cuda_graph(gen):
    """One captured launch serves every replay while the lengths grow, as
    SI2's decode step does: the split plan depends on S, not on lengths."""
    B, K, G, S, dh = 4, 8, 3, 1024, 128
    q = torch.randn(B, K, G, dh, generator=gen, device="cuda").to(torch.bfloat16)
    kc = torch.randn(B, S, K, dh, generator=gen, device="cuda").to(torch.bfloat16)
    vc = torch.randn(B, S, K, dh, generator=gen, device="cuda").to(torch.bfloat16)
    kt, vt = kc.transpose(1, 2), vc.transpose(1, 2)
    lengths = torch.tensor([513, 1, 63, 64], dtype=torch.int32, device="cuda")
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        ops.decode_attention(q, kt, vt, lengths)     # warm up outside the capture
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = ops.decode_attention(q, kt, vt, lengths)
    for step in range(4):
        lengths.add_(step * 31 + 1)
        q.copy_(torch.randn(B, K, G, dh, generator=gen, device="cuda").to(torch.bfloat16))
        graph.replay()
        torch.cuda.synchronize()
        torch.testing.assert_close(out, ref.decode_attention_ref(q, kt, vt, lengths),
                                   **_tol(torch.bfloat16))


@pytest.mark.parametrize("M,D,N", [(4, 256, 96), (48, 128, 64), (300, 520, 136)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_int8_matmul_kernel(gen, M, D, N, dtype):
    x = torch.randn(M, D, generator=gen, device="cuda").to(dtype)
    wq, sc = ops.quantize_int8(torch.randn(D, N, generator=gen, device="cuda"))
    tol = dict(atol=1e-3, rtol=1e-3) if dtype == torch.float32 else _tol(dtype)
    torch.testing.assert_close(ops.int8_matmul(x, wq, sc),
                               ref.int8_matmul_ref(x, wq, sc), **tol)


@pytest.mark.parametrize("M,D,N,path", [
    (1, 3072, 1024, "stream"), (3, 520, 144, "stream"), (8, 4100, 1040, "stream"),
    (9, 520, 144, "wgmma"), (100, 3072, 1024, "wgmma"), (257, 1000, 384, "wgmma"),
    (16, 64, 32, "wgmma"), (300, 520, 136, "fma"), (5, 64, 40, "fma")])
def test_int8_matmul_bf16_paths(gen, M, D, N, path):
    """Both bf16 regimes with ragged M, N and D, and the shapes they leave to
    the fma kernel."""
    x = torch.randn(M, D, generator=gen, device="cuda").to(torch.bfloat16)
    wq, sc = ops.quantize_int8(torch.randn(D, N, generator=gen, device="cuda") * D ** -0.5)
    assert k3.plan_call(x, wq).path == path
    n = ops.launch_counts()["int8_matmul"]
    got = ops.int8_matmul(x, wq, sc)
    assert ops.launch_counts()["int8_matmul"] == n + 1
    torch.testing.assert_close(got, ref.int8_matmul_ref(x, wq, sc), **_tol(torch.bfloat16))
    # a row-strided view of x (the model's reshape of a wider buffer)
    buf = torch.randn(M, D + 8, generator=gen, device="cuda").to(torch.bfloat16)
    xv = buf[:, :D]
    torch.testing.assert_close(ops.int8_matmul(xv, wq, sc), ref.int8_matmul_ref(xv, wq, sc),
                               **_tol(torch.bfloat16))


def test_int8_matmul_stream_path_in_a_cuda_graph(gen):
    """The decode path is captured once and replayed on new inputs, as SI2 does."""
    M, D, N = 4, 3072, 1024
    wq, sc = ops.quantize_int8(torch.randn(D, N, generator=gen, device="cuda") * D ** -0.5)
    x = torch.randn(M, D, generator=gen, device="cuda").to(torch.bfloat16)
    assert k3.plan_call(x, wq).path == "stream" and k3.plan_call(x, wq).splits > 1
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        ops.int8_matmul(x, wq, sc)            # warm up outside the capture
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = ops.int8_matmul(x, wq, sc)
    for _ in range(3):
        x.copy_(torch.randn(M, D, generator=gen, device="cuda").to(torch.bfloat16))
        graph.replay()
        torch.cuda.synchronize()
        torch.testing.assert_close(out, ref.int8_matmul_ref(x, wq, sc), **_tol(torch.bfloat16))


@pytest.mark.parametrize("E,C,D,F", [(2, 32, 64, 48), (4, 64, 96, 128), (8, 8, 256, 520),
                                     (3, 200, 136, 264)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_moe_gmm_kernel(gen, E, C, D, F, dtype):
    x = torch.randn(E, C, D, generator=gen, device="cuda").to(dtype)
    w = (torch.randn(E, D, F, generator=gen, device="cuda") * D ** -0.5).to(dtype)
    gs = torch.tensor([0, C, C // 3 + 1, 5, 1, 0, C - 1, 2][:E], dtype=torch.int32,
                      device="cuda")
    n = ops.launch_counts()["moe_gmm"]
    got = ops.moe_gmm(x, w, gs)
    assert ops.launch_counts()["moe_gmm"] == n + 1
    tol = dict(atol=5e-2, rtol=5e-2) if dtype == torch.bfloat16 else dict(atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(got, ref.moe_gmm_ref(x, w, gs), **tol)
    torch.testing.assert_close(ops.moe_gmm(x, w), ref.moe_gmm_ref(x, w), **tol)
    # a strided (E, C, D) view of a larger buffer goes in without a copy
    buf = torch.randn(E * C + 1, D, generator=gen, device="cuda").to(dtype)
    xv = buf[: E * C].view(E, C, D)
    torch.testing.assert_close(ops.moe_gmm(xv, w, gs), ref.moe_gmm_ref(xv, w, gs), **tol)


@pytest.mark.parametrize("E,C,D,F,sizes", [
    (4, 64, 96, 128, [0, 64, 22, 5]),                       # the JAX sweep's shape
    (3, 200, 136, 264, [0, 200, 77]),                       # C, D, F off every tile
    (1, 640, 256, 512, [640]),                              # E = 1, all rows live
    (1, 640, 256, 512, [130]),                              # a row tile and 2 rows
    (8, 640, 512, 1024, [0, 640, 129, 128, 1, 639, 256, 300]),
    (128, 40, 128, 256, None),                              # arctic's E and prefill C
])
def test_moe_gmm_wgmma_path(gen, E, C, D, F, sizes):
    """The bf16 prefill path: dead rows are exact zeros, live rows match."""
    if sizes is None:
        sizes = torch.randint(0, C + 1, (E,), generator=gen, device="cuda").tolist()
    x = torch.randn(E, C, D, generator=gen, device="cuda").to(torch.bfloat16)
    w = (torch.randn(E, D, F, generator=gen, device="cuda") * D ** -0.5).to(torch.bfloat16)
    gs = torch.tensor(sizes, dtype=torch.int32, device="cuda")
    assert k4.plan_call(x, w).path == "wgmma"
    n = ops.launch_counts()["moe_gmm"]
    got = ops.moe_gmm(x, w, gs)
    assert ops.launch_counts()["moe_gmm"] == n + 1
    tol = dict(atol=5e-2, rtol=5e-2)
    torch.testing.assert_close(got, ref.moe_gmm_ref(x, w, gs), **tol)
    for e, size in enumerate(sizes):
        assert torch.count_nonzero(got[e, size:]) == 0
    torch.testing.assert_close(ops.moe_gmm(x, w), ref.moe_gmm_ref(x, w), **tol)
    # the model's (E, C, D) view of its dispatch buffer, one trash row past it
    buf = torch.randn(E * C + 1, D, generator=gen, device="cuda").to(torch.bfloat16)
    xv = buf[: E * C].view(E, C, D)
    assert k4.plan_call(xv, w).path == "wgmma"
    torch.testing.assert_close(ops.moe_gmm(xv, w, gs), ref.moe_gmm_ref(xv, w, gs), **tol)


def test_moe_gmm_paths_by_shape(gen):
    """Decode's C = 8 takes mma, float32 fma, a layout TMA cannot address
    (an expert stride below C rows) at C = 64 wmma."""
    w = torch.randn(2, 64, 128, generator=gen, device="cuda").to(torch.bfloat16)
    x8 = torch.randn(2, 8, 64, generator=gen, device="cuda").to(torch.bfloat16)
    assert k4.plan_call(x8, w).path == "mma"
    assert k4.plan_call(x8.float(), w.float()).path == "fma"
    buf = torch.randn(64 + 64, 64, generator=gen, device="cuda").to(torch.bfloat16)
    overlapping = buf.as_strided((2, 64, 64), (64 * 64 // 2, 64, 1))
    assert k4.plan_call(overlapping, w).path == "wmma"
    # decode's C with a w TMA cannot address (experts overlap): wmma as well
    wbuf = torch.randn(64 * 128 * 3 // 2, generator=gen, device="cuda").to(torch.bfloat16)
    w_overlapping = wbuf.as_strided((2, 64, 128), (64 * 128 // 2, 128, 1))
    assert k4.plan_call(x8, w_overlapping).path == "wmma"
    gs8 = torch.tensor([8, 3], dtype=torch.int32, device="cuda")
    torch.testing.assert_close(ops.moe_gmm(x8, w_overlapping, gs8),
                               ref.moe_gmm_ref(x8, w_overlapping, gs8), atol=5e-2, rtol=5e-2)
    gs = torch.tensor([64, 17], dtype=torch.int32, device="cuda")
    torch.testing.assert_close(ops.moe_gmm(overlapping, w, gs),
                               ref.moe_gmm_ref(overlapping, w, gs), atol=5e-2, rtol=5e-2)


def test_moe_gmm_wgmma_path_in_a_cuda_graph(gen):
    """The prefill path is captured once and replayed with new group sizes:
    its tile list is built on the device at every launch."""
    E, C, D, F = 8, 640, 256, 512
    x = torch.randn(E, C, D, generator=gen, device="cuda").to(torch.bfloat16)
    w = (torch.randn(E, D, F, generator=gen, device="cuda") * D ** -0.5).to(torch.bfloat16)
    gs = torch.full((E,), C, dtype=torch.int32, device="cuda")
    assert k4.plan_call(x, w).path == "wgmma"
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        ops.moe_gmm(x, w, gs)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = ops.moe_gmm(x, w, gs)
    for _ in range(3):
        gs.copy_(torch.randint(0, C + 1, (E,), generator=gen, device="cuda"))
        x.copy_(torch.randn(E, C, D, generator=gen, device="cuda").to(torch.bfloat16))
        graph.replay()
        torch.cuda.synchronize()
        torch.testing.assert_close(out, ref.moe_gmm_ref(x, w, gs), atol=5e-2, rtol=5e-2)


def _bf16_operands(gen, E, C, D, F):
    x = torch.randn(E, C, D, generator=gen, device="cuda", dtype=torch.bfloat16)
    w = torch.randn(E, D, F, generator=gen, device="cuda", dtype=torch.bfloat16) * D ** -0.5
    return x, w


def _check_decode(got, x, w, sizes):
    """Live experts against the plain version on their own slices (arctic's
    full float32 copy of w would take 18 GB); dead rows are exact zeros."""
    live = [e for e, n in enumerate(sizes) if n > 0]
    gs = torch.tensor(sizes, dtype=torch.int32, device="cuda")
    want = ref.moe_gmm_ref(x[live], w[live], gs[live])
    torch.testing.assert_close(got[live], want, atol=5e-2, rtol=5e-2)
    for e, n in enumerate(sizes):
        assert torch.count_nonzero(got[e, n:]) == 0


@pytest.mark.parametrize("E,C,D,F,sizes", [
    (8, 8, 4096, 14336, [2, 0, 3, 1, 0, 0, 2, 0]),      # mixtral gate/up at decode
    (8, 8, 14336, 4096, [2, 0, 3, 1, 0, 0, 2, 0]),      # mixtral down
    (128, 8, 7168, 4864, [0] * 120 + [1] * 8),          # arctic: 8 of 128 experts live
    (128, 8, 4864, 7168, [1, 0, 2, 0] * 32),            # arctic down, 64 live: items loop
    (8, 8, 2056, 264, [8, 1, 0, 7, 0, 3, 0, 5]),        # D % 16 == 8, a ragged column tile
    (3, 12, 1032, 136, [12, 9, 0]),                     # two n8 tiles
    (2, 32, 2048, 128, [32, 17]),                       # four n8 tiles
    (2, 8, 64, 48, [3, 8]),                             # one stage, one split
])
def test_moe_gmm_decode_split_d(gen, E, C, D, F, sizes):
    """The bf16 decode path (split-D, mma.sync with x rows as n8 tiles)."""
    x, w = _bf16_operands(gen, E, C, D, F)
    gs = torch.tensor(sizes, dtype=torch.int32, device="cuda")
    p = k4.plan_call(x, w, torch.cuda.get_device_properties(0).multi_processor_count)
    assert p.path == "mma"
    n = ops.launch_counts()["moe_gmm"]
    got = ops.moe_gmm(x, w, gs)
    assert ops.launch_counts()["moe_gmm"] == n + 1
    _check_decode(got, x, w, sizes)


def test_moe_gmm_decode_deterministic(gen):
    """Several D splits summed in a fixed order: two calls, the same bits."""
    E, C, D, F = 8, 8, 14336, 4096
    x, w = _bf16_operands(gen, E, C, D, F)
    assert k4.plan_call(x, w).splits > 1
    gs = torch.tensor([2, 0, 3, 1, 0, 0, 2, 0], dtype=torch.int32, device="cuda")
    a = ops.moe_gmm(x, w, gs)
    b = ops.moe_gmm(x, w, gs)
    assert torch.equal(a, b)
    # without group sizes every expert is live: more items than blocks
    torch.testing.assert_close(ops.moe_gmm(x[:, :, :2056], w[:, :2056]),
                               ref.moe_gmm_ref(x[:, :, :2056], w[:, :2056]),
                               atol=5e-2, rtol=5e-2)


def test_moe_gmm_decode_in_a_cuda_graph(gen):
    """Captured once, replayed with new group sizes (dead experts, full
    experts, all dead): the live list is built on the device and the split
    counters reset themselves between replays."""
    E, C, D, F = 8, 8, 4096, 1024
    x, w = _bf16_operands(gen, E, C, D, F)
    assert k4.plan_call(x, w).splits > 1
    gs = torch.full((E,), C, dtype=torch.int32, device="cuda")
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        ops.moe_gmm(x, w, gs)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = ops.moe_gmm(x, w, gs)
    for sizes in ([2, 0, 3, 1, 0, 0, 2, 0], [8] * 8, [0] * 8, [0, 0, 0, 0, 0, 0, 0, 8]):
        gs.copy_(torch.tensor(sizes, dtype=torch.int32))
        x.copy_(torch.randn(E, C, D, generator=gen, device="cuda").to(torch.bfloat16))
        graph.replay()
        torch.cuda.synchronize()
        _check_decode(out, x, w, sizes)
        first = out.clone()
        graph.replay()
        assert torch.equal(out, first)


@pytest.mark.parametrize("B,H,T,dh", [(1, 2, 32, 16), (2, 3, 48, 32), (2, 4, 70, 64),
                                      (3, 2, 1, 64)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rwkv6_scan_kernel(gen, B, H, T, dh, dtype):
    def rnd(*shape, scale=0.5):
        return torch.randn(*shape, generator=gen, device="cuda") * scale

    # r/k/v/w as (B, H, T, dh) views of (B, T, H, dh) memory, as the model passes them
    r, k, v = (rnd(B, T, H, dh).to(dtype).transpose(1, 2) for _ in range(3))
    w = torch.sigmoid(rnd(B, T, H, dh, scale=1.0)).to(dtype).transpose(1, 2)
    u, s0 = rnd(H, dh, scale=0.3), rnd(B, H, dh, dh, scale=0.1)
    n = ops.launch_counts()["rwkv6_scan"]
    out, sf = ops.rwkv6_scan(r, k, v, w, u, s0)
    assert ops.launch_counts()["rwkv6_scan"] == n + 1
    want_out, want_sf = ref.rwkv6_scan_ref(r, k, v, w, u, s0)
    tol = dict(atol=2e-2, rtol=2e-2) if dtype == torch.bfloat16 else dict(atol=2e-4, rtol=2e-4)
    torch.testing.assert_close(out, want_out, **tol)
    torch.testing.assert_close(sf, want_sf, atol=2e-4, rtol=2e-4)
    # the final state written over the initial one, in place
    state = s0.clone()
    ops.rwkv6_scan(r, k, v, w, u, state, s_out=state)
    torch.testing.assert_close(state, want_sf, atol=2e-4, rtol=2e-4)


@pytest.mark.parametrize("T", [512, 1])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rwkv6_scan_at_the_serve_shapes(gen, T, dtype):
    """rwkv6-3b's prefill (T = 512) and decode (T = 1) at B = 4: 40 heads of
    64 in 32-column slices; the state updated in place, as the decode cache is."""
    B, H, dh = 4, 40, 64
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    assert k5.plan(B, H, dh, sms).jb < dh
    def rnd(*shape, scale=0.5):
        return torch.randn(*shape, generator=gen, device="cuda") * scale

    r, k, v = (rnd(B, T, H, dh).to(dtype).transpose(1, 2) for _ in range(3))
    w = torch.sigmoid(rnd(B, T, H, dh, scale=1.0)).to(dtype).transpose(1, 2)
    u, s0 = rnd(H, dh, scale=0.3), rnd(B, H, dh, dh, scale=0.1)
    want_out, want_sf = ref.rwkv6_scan_ref(r, k, v, w, u, s0)
    state = s0.clone()
    out, sf = ops.rwkv6_scan(r, k, v, w, u, state, s_out=state)
    assert sf.data_ptr() == state.data_ptr()
    tol = dict(atol=2e-2, rtol=2e-2) if dtype == torch.bfloat16 else dict(atol=2e-4, rtol=2e-4)
    torch.testing.assert_close(out, want_out, **tol)
    torch.testing.assert_close(state, want_sf, atol=2e-4, rtol=2e-4)


def test_quantize_int8_same_on_card_and_cpu(gen):
    w = torch.randn(3, 256, 96, generator=gen, device="cuda")
    wq, sc = ops.quantize_int8(w)
    cq, cs = ops.quantize_int8(w.cpu())
    assert torch.equal(wq.cpu(), cq) and torch.equal(sc.cpu(), cs)


def test_kernels_reject_what_they_do_not_take(gen):
    q = torch.randn(1, 2, 8, 16, generator=gen, device="cuda")
    with pytest.raises(ValueError, match="head dim"):
        ops.flash_attention(q, q, q)
    q = torch.randn(1, 8, 2, 32, generator=gen, device="cuda")
    with pytest.raises(NotImplementedError):
        attention(q, q, q, q_offset=3)


@pytest.mark.parametrize("fmt", ["rsm", "rsm_int8"])
def test_si2_graph_tokens_equal_si1(gen, fmt):
    cfg = get_arch("minitron-4b-smoke")
    params = T.init_params(cfg, seed=0, device="cuda")
    if fmt == "rsm_int8":
        params = quantize_params(params)
    prompt = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 12)).astype(np.int32)
    si1 = EagerEngine(cfg, params, 64).generate(prompt, 9)
    si2_engine = CompiledEngine(cfg, params, 64)
    si2_engine.warmup(2, 12)
    si2 = si2_engine.generate(prompt, 9)
    np.testing.assert_array_equal(si2.tokens, si1.tokens)
    g = si2_engine.graphs[2]
    assert g.launches_per_replay["decode_attention"] == cfg.num_layers
    assert g.launches_per_replay["int8_matmul"] == (6 * cfg.num_layers
                                                    if fmt == "rsm_int8" else 0)


@pytest.mark.parametrize("arch", ["mixtral-8x7b-smoke", "arctic-480b-smoke", "rwkv6-3b-smoke"])
def test_si2_graph_tokens_equal_si1_moe_and_ssm(gen, arch):
    cfg = get_arch(arch)
    params = quantize_params(T.init_params(cfg, seed=0, device="cuda"))
    prompt = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 12)).astype(np.int32)
    si1 = EagerEngine(cfg, params, 64).generate(prompt, 9)
    si2_engine = CompiledEngine(cfg, params, 64)
    si2_engine.warmup(2, 12)
    si2 = si2_engine.generate(prompt, 9)
    np.testing.assert_array_equal(si2.tokens, si1.tokens)
    per_step = si2_engine.graphs[2].launches_per_replay
    if cfg.family == "ssm":
        assert per_step["rwkv6_scan"] == cfg.num_layers and per_step["moe_gmm"] == 0
    else:
        assert per_step["moe_gmm"] == 3 * cfg.num_layers
        assert per_step["decode_attention"] == cfg.num_layers


def _cb_tokens(engine, wl, num_slots, max_seq):
    from repro_torch.serving.scheduler import ContinuousBatchScheduler

    m = ContinuousBatchScheduler(engine, num_slots=num_slots, max_seq=max_seq).run(wl)
    return {r.rid: np.asarray(r.tokens).tolist() for r in m.responses}


@pytest.mark.parametrize("arch", ["minitron-4b-smoke", "rwkv6-3b-smoke"])
def test_si2_calibrate_and_continuous_batch_equal_si1(gen, arch):
    """SI2 decodes the slot cache it hands out (its graph's buffers): the
    calibration and a continuous batch run, and the batch's tokens are SI1's."""
    from repro_torch.serving.request import synth_workload
    from repro_torch.serving.stepcache import StepTimeCache, calibrate

    cfg = get_arch(arch)
    params = T.init_params(cfg, seed=0, device="cuda")
    si2 = CompiledEngine(cfg, params, 64)
    cache = calibrate(si2, StepTimeCache(), batch_sizes=[1, 2], prompt_len=8, max_new=3,
                      vocab=cfg.vocab_size, num_slots=4, max_seq=64)
    assert ("decode", 4) in cache.to_payload() and si2.slot_graphs[0].replays >= 2
    wl = lambda: synth_workload(7, 8, 5, cfg.vocab_size, rate_per_s=300, seed=4)  # noqa: E731
    want = _cb_tokens(EagerEngine(cfg, params, 64), wl(), 4, 64)
    replays = sum(g.replays for g in si2.slot_graphs)
    got = _cb_tokens(si2, wl(), 4, 64)
    assert len(got) == 7 and got == want
    assert sum(g.replays for g in si2.slot_graphs) > replays


def test_si2_free_slot_past_max_seq_in_a_graph(gen):
    """A free slot steps past max_seq inside the captured graph: its write
    is dropped (no device assert) and the busy slot's tokens are SI1's."""
    from repro_torch.serving.request import Request

    cfg = get_arch("minitron-4b-smoke")
    params = T.init_params(cfg, seed=0, device="cuda")
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32) for n in (8, 16)]
    wl = lambda: [Request(rid=0, prompt=prompts[0], max_new_tokens=20),  # noqa: E731
                  Request(rid=1, prompt=prompts[1], max_new_tokens=2)]
    want = _cb_tokens(EagerEngine(cfg, params, 32), wl(), 2, 32)
    si2 = CompiledEngine(cfg, params, 32)
    got = _cb_tokens(si2, wl(), 2, 32)
    torch.cuda.synchronize()
    assert got == want and len(got[0]) == 20
    assert int(si2.slot_graphs[0].cache["lengths"][1]) > 32


def test_si2_decode_cache_is_the_graphs_and_sized_by_the_engine(gen):
    cfg = get_arch("minitron-4b-smoke")
    si2 = CompiledEngine(cfg, T.init_params(cfg, seed=0, device="cuda"), 64)
    si2.warmup(3, 8)
    cache = si2.decode_cache(3, 64)
    g = si2.graph_of(cache)
    assert g is not si2.graphs[3] and all(cache[k] is g.cache[k] for k in g.cache)
    assert cache["k"].data_ptr() != si2.graphs[3].cache["k"].data_ptr()
    assert all(not bool(leaf.any()) for leaf in cache.values())
    del cache               # its graph is handed out again, not captured anew
    again = si2.decode_cache(3, 64)
    assert si2.graph_of(again) is g and len(si2.slot_graphs) == 1
    with pytest.raises(ValueError, match="max_seq"):
        si2.decode_cache(3, 128)
    with pytest.raises(ValueError, match="decodes only the cache"):
        si2.decode_batch(T.init_cache(cfg, 3, 64, device="cuda"),
                         torch.zeros(3, dtype=torch.int32, device="cuda"))


def test_si2_two_continuous_pools_on_one_engine_keep_their_own_slots(gen):
    """Two continuous-batching cores interleaved on one SI2 engine (two
    replicas of one endpoint): each decodes a slot cache of its own, so
    every request's tokens equal its tokens from one core alone."""
    from repro_torch.serving.core import SchedulerCore
    from repro_torch.serving.request import synth_workload
    from repro_torch.serving.scheduler import ContinuousBatchPolicy

    cfg = get_arch("minitron-4b-smoke")
    si2 = CompiledEngine(cfg, T.init_params(cfg, seed=0, device="cuda"), 64)

    def workload(k):
        return synth_workload(6, 8, 6, cfg.vocab_size, rate_per_s=400, seed=k, rid0=100 * k)

    alone = {}
    for k in (1, 2):
        alone.update(_cb_tokens(si2, workload(k), 4, 64))
    cores = [SchedulerCore(si2, ContinuousBatchPolicy(num_slots=4, max_seq=64))
             for _ in range(2)]
    for core in cores:
        core.begin()
    for core, k in zip(cores, (1, 2)):
        for req in workload(k):
            core.offer(req)
    for t in np.arange(0.0005, 0.1, 0.0005):
        for core in cores:
            core.drain_until(float(t))
    got = {}
    for core in cores:
        core.drain_until()
        got.update({r.rid: np.asarray(r.tokens).tolist() for r in core.finish().responses})
    assert len(got) == 12 and got == alone
    kv = [core.policy.kv for core in cores]
    assert kv[0]["k"].data_ptr() != kv[1]["k"].data_ptr()
    assert all(si2.graph_of(c).replays > 0 for c in kv)


def test_spec_session_si2_on_the_card_gives_eager_tokens(gen, tmp_path):
    """One ServingSession on the card: minitron-4b-smoke served from
    rsm_int8 on SI2, a burst of 4 requests in one dispatch.  Its tokens are
    those an eager (SI1) engine gives on the same loaded weights (the spec
    API rejects rsm_int8 on SI1), and K3 launches inside ``run()``."""
    from repro_torch.serving.api import (AutoscaleSpec, EndpointSpec, ServingSession,
                                         ServingSpec)
    from repro_torch.serving.request import synth_workload

    cfg = get_arch("minitron-4b-smoke")
    spec = ServingSpec(endpoints=(EndpointSpec(
        name="m", arch=cfg.name, format="rsm_int8", si="si2_runtime", max_seq=64,
        max_batch=4, step_cache=False, autoscale=AutoscaleSpec(enabled=False,
                                                               max_replicas=1)),))
    session = ServingSession(registry_root=str(tmp_path))
    assert session.device.type == "cuda"
    session.deploy(spec, params={"m": T.init_params(cfg, seed=0, device="cuda")})
    engine = session.engine("m")
    assert isinstance(engine, CompiledEngine) and engine.device.type == "cuda"
    engine.warmup(4, 8)
    wl = synth_workload(4, 8, 6, cfg.vocab_size, rate_per_s=1e6, seed=2)
    prompts = np.stack([r.prompt for r in wl])
    n = ops.launch_counts()["int8_matmul"]
    session.submit("m", wl)
    report = session.run()
    assert ops.launch_counts()["int8_matmul"] > n
    got = {r.rid: np.asarray(r.tokens).tolist() for r in report.endpoints["m"].metrics.responses}
    want = EagerEngine(cfg, engine.params, 64).generate(prompts, 6).tokens
    assert got == {r.rid: want[i].tolist() for i, r in enumerate(wl)}
    assert engine.graphs[4].replays >= 5


# -- head dim 80 (zamba2) and whisper's encoder and cross-attention shapes ----------


@pytest.mark.parametrize("B,H,K,S,window", [(2, 4, 4, 130, None), (1, 8, 8, 200, 64),
                                            (2, 6, 2, 96, 17)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_head_dim_80(gen, B, H, K, S, window, dtype):
    """K1 at zamba2's head dim: five 16-wide k-steps on the tensor cores (bf16)
    and twenty output columns a thread on the CUDA cores (f32)."""
    mk = lambda *shape: torch.randn(*shape, generator=gen, device="cuda").to(dtype)  # noqa: E731
    q = mk(B, S, H, 80).transpose(1, 2)
    k, v = mk(B, S, K, 80).transpose(1, 2), mk(B, S, K, 80).transpose(1, 2)
    assert k1.plan_call(q, k, v) == ("mma" if dtype == torch.bfloat16 else "fma")
    got = ops.flash_attention(q, k, v, causal=True, window=window)
    want = ref.flash_attention_ref(q, k, v, window=window)
    torch.testing.assert_close(got, want, **_tol(dtype))
    # the last 16 columns (the fifth k-step) carry their share
    torch.testing.assert_close(got[..., 64:], want[..., 64:], **_tol(dtype))


@pytest.mark.parametrize("G", [1, 3])
@pytest.mark.parametrize("S,window", [(32, None), (1024, 4096), (1024, 100)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_attention_head_dim_80(gen, G, S, window, dtype):
    """K2 at head dim 80, one split and many: value columns 64-79 (those past
    the 32-column multiple) are computed, nonzero and right; the merge runs
    in whole warps at G * 80 threads."""
    B, K, dh = 4, 32 if S == 1024 else 2, 80
    q = torch.randn(B, K, G, dh, generator=gen, device="cuda").to(dtype)
    kc = torch.randn(B, S, K, dh, generator=gen, device="cuda").to(dtype).transpose(1, 2)
    vc = torch.randn(B, S, K, dh, generator=gen, device="cuda").to(dtype).transpose(1, 2)
    lengths = torch.tensor([S, S * 3 // 4 + 1, S // 2 + 1, 5], dtype=torch.int32,
                           device="cuda")
    splits = k2.plan(B, K, S, torch.cuda.get_device_properties(0).multi_processor_count).splits
    assert (splits > 1) == (S == 1024)
    got = ops.decode_attention(q, kc, vc, lengths, window=window)
    want = ref.decode_attention_ref(q, kc, vc, lengths, window=window)
    torch.testing.assert_close(got, want, **_tol(dtype))
    tail = got[..., 64:].float()
    assert bool((tail.abs().amax(dim=-1) > 0).all())
    torch.testing.assert_close(got[..., 64:], want[..., 64:], **_tol(dtype))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_cross_attention_shape(gen, dtype):
    """whisper's cross attention: 64 decoder queries over 1500 encoder
    entries, non-causal (Sq != T; the last kv tile is ragged)."""
    B, H, Sq, T_len, dh = 2, 12, 64, 1500, 64
    q = torch.randn(B, Sq, H, dh, generator=gen, device="cuda").to(dtype).transpose(1, 2)
    k = torch.randn(B, T_len, H, dh, generator=gen, device="cuda").to(dtype).transpose(1, 2)
    v = torch.randn(B, T_len, H, dh, generator=gen, device="cuda").to(dtype).transpose(1, 2)
    got = ops.flash_attention(q, k, v, causal=False)
    torch.testing.assert_close(got, ref.flash_attention_ref(q, k, v, causal=False),
                               **_tol(dtype))
    # through the model's entry point, in its (B, S, heads, dh) layout
    o = attention(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), causal=False)
    torch.testing.assert_close(o.transpose(1, 2), got, rtol=0, atol=0)


@pytest.mark.parametrize("fmt", ["rsm", "rsm_int8"])
@pytest.mark.parametrize("arch", ["zamba2-2.7b-smoke", "whisper-small-smoke"])
def test_si2_graph_tokens_equal_si1_hybrid_and_audio(gen, arch, fmt):
    """The captured decode step of zamba2 (Mamba2 layers + the shared block's
    K2) and whisper (K2 over the self and the cross caches) gives SI1's
    tokens."""
    cfg = get_arch(arch)
    params = T.init_params(cfg, seed=0, device="cuda")
    if fmt == "rsm_int8":
        params = quantize_params(params)
    prompt = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 12)).astype(np.int32)
    si1 = EagerEngine(cfg, params, 64).generate(prompt, 9)
    si2_engine = CompiledEngine(cfg, params, 64)
    si2_engine.warmup(2, 12)
    si2 = si2_engine.generate(prompt, 9)
    np.testing.assert_array_equal(si2.tokens, si1.tokens)
    per_step = si2_engine.graphs[2].launches_per_replay
    if cfg.family == "hybrid":
        assert per_step["decode_attention"] == cfg.num_layers // cfg.attn_every
    else:
        assert per_step["decode_attention"] == 2 * cfg.num_layers
    assert (per_step["int8_matmul"] > 0) == (fmt == "rsm_int8")


def test_si2_whisper_free_slot_past_max_seq_in_a_graph(gen):
    """A free whisper slot steps past max_seq inside the captured graph: its
    position embedding is read at the clamped position (NaN, as the JAX
    package gives it), its write is dropped, no device assert, and the busy
    slot's tokens are SI1's."""
    from repro_torch.serving.request import Request

    cfg = get_arch("whisper-small-smoke")
    params = T.init_params(cfg, seed=0, device="cuda")
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32) for n in (8, 16)]
    wl = lambda: [Request(rid=0, prompt=prompts[0], max_new_tokens=20),  # noqa: E731
                  Request(rid=1, prompt=prompts[1], max_new_tokens=2)]
    want = _cb_tokens(EagerEngine(cfg, params, 32), wl(), 2, 32)
    si2 = CompiledEngine(cfg, params, 32)
    got = _cb_tokens(si2, wl(), 2, 32)
    torch.cuda.synchronize()
    assert got == want and len(got[0]) == 20
    cache = si2.slot_graphs[0].cache
    assert int(cache["lengths"][1]) > 32
    assert not bool(torch.isnan(cache["k"]).any() or torch.isnan(cache["v"]).any())


# -- SI2's captured B = 1 prefill --------------------------------------------------------

PREFILL_GRAPH_CASES = [("minitron-4b-smoke", "native"), ("minitron-4b-smoke", "rsm_int8"),
                       ("mixtral-8x7b-smoke", "native"), ("zamba2-2.7b-smoke", "native"),
                       ("rwkv6-3b-smoke", "native"), ("whisper-small-smoke", "native")]


def _bf16_params(arch, fmt):
    import dataclasses

    cfg = dataclasses.replace(get_arch(arch), dtype="bfloat16")
    params = T.init_params(cfg, seed=0, device="cuda")
    return cfg, quantize_params(params) if fmt == "rsm_int8" else params


def _prefill_kernels(cfg, fmt) -> dict:
    """The hand-written kernels one prefill of ``cfg`` launches."""
    L = cfg.num_layers
    if cfg.family == "ssm":
        want = {"rwkv6_scan": L}
    elif cfg.family == "hybrid":
        want = {"flash_attention": L // cfg.attn_every}
    elif cfg.family == "audio":
        want = {"flash_attention": cfg.encoder_layers + 2 * L}
    elif cfg.family == "moe":
        want = {"flash_attention": L, "moe_gmm": 3 * L}
    else:
        want = {"flash_attention": L}
    if fmt == "rsm_int8":
        want["int8_matmul"] = 6 * L
    return want


@pytest.mark.parametrize("arch,fmt", PREFILL_GRAPH_CASES)
def test_si2_prefill_graph_replays_equal_eager_prefill(gen, arch, fmt):
    """In bf16, as the cells serve: SI2's ``prefill_one`` at interleaved
    lengths (the graphs share one memory pool) gives the eager prefill's
    argmax, its logits within the decode-against-forward 2e-2 and its B = 1
    cache, ``lengths`` included.  The first call of a length captures, a
    later one replays; the graph launches the hand-written kernels."""
    cfg, params = _bf16_params(arch, fmt)
    si2 = CompiledEngine(cfg, params, 640)
    rng = np.random.default_rng(1)
    prompts = {S: rng.integers(1, cfg.vocab_size, (1, S)).astype(np.int32)
               for S in (128, 256, 512)}
    order = (512, 128, 512, 256, 128, 256)
    replayed = []
    for S in order:
        captures, replays = si2.prefill_captures, si2.prefill_replays
        logits, cache = si2.prefill_one(prompts[S])
        with torch.no_grad():
            want_l, want = T.prefill(params, cfg, si2._batch(si2._tokens(prompts[S])), 640)
        torch.cuda.synchronize()
        assert torch.equal(torch.argmax(logits, -1), torch.argmax(want_l, -1)), S
        torch.testing.assert_close(logits, want_l, atol=2e-2, rtol=2e-2)
        assert cache is si2.graphs[1].cache and int(cache["lengths"][0]) == S
        for key, leaf in want.items():
            torch.testing.assert_close(cache[key], leaf, atol=2e-2, rtol=2e-2, msg=key)
        replayed.append(si2.last_prefill_replayed())
        if replayed[-1]:
            assert (si2.prefill_captures, si2.prefill_replays) == (captures, replays + 1)
        else:
            assert (si2.prefill_captures, si2.prefill_replays) == (captures + 1, replays)
    assert replayed == [False, False, True, False, True, True]
    assert sorted(si2.prefill_graphs) == [128, 256, 512]
    for g in si2.prefill_graphs.values():
        assert g.replays == 1
        got = {k: n for k, n in g.launches_per_replay.items() if n}
        assert {k: got.get(k, 0) for k in _prefill_kernels(cfg, fmt)} == _prefill_kernels(cfg, fmt)


@pytest.mark.parametrize("arch,fmt", PREFILL_GRAPH_CASES)
def test_si2_decode_after_a_replayed_prefill_equals_eager(gen, arch, fmt):
    """Decode steps after a replayed prefill give the tokens an eager engine
    gives after its own prefill."""
    cfg, params = _bf16_params(arch, fmt)
    prompt = np.random.default_rng(2).integers(1, cfg.vocab_size, (1, 128)).astype(np.int32)

    def tokens(engine):
        logits, cache = engine.prefill_one(prompt)
        out = [torch.argmax(logits, -1).to(torch.int32)]
        for _ in range(8):
            logits, cache = engine.decode_batch(cache, out[-1])
            out.append(torch.argmax(logits, -1).to(torch.int32))
        return torch.cat(out).tolist()

    si2 = CompiledEngine(cfg, params, 256)
    tokens(si2)                         # captures the length's graph
    got = tokens(si2)
    assert si2.last_prefill_replayed() and si2.prefill_replays == 1
    assert got == tokens(EagerEngine(cfg, params, 256))


def test_si2_prefill_spans_record_replays(gen):
    """A continuous batch on SI2: the first admission of a prompt bucket
    captures (``graph`` 0 on its span), every later one replays (1)."""
    from repro_torch.serving.request import synth_workload
    from repro_torch.serving.scheduler import ContinuousBatchScheduler

    cfg = get_arch("minitron-4b-smoke")
    si2 = CompiledEngine(cfg, T.init_params(cfg, seed=0, device="cuda"), 64)
    sched = ContinuousBatchScheduler(si2, num_slots=4, max_seq=64)
    sched.run(synth_workload(6, 8, 5, cfg.vocab_size, rate_per_s=300, seed=4))
    spans = [s for s in sched.core.wall_log.spans() if s.name == "repro_torch.prefill"]
    buckets = [s.bucket for s in spans]
    assert len(spans) == 6
    assert [s.graph for s in spans] == [int(b in buckets[:i]) for i, b in enumerate(buckets)]
    assert si2.prefill_captures == len(set(buckets)) == len(si2.prefill_graphs)
    assert si2.prefill_replays == 6 - len(set(buckets))


# -- training: K1's lse, K1's backward, a train step ---------------------------------


def _attn_inputs(gen, B, H, K, Sq, T, dh, dtype):
    mk = lambda *shape: torch.randn(*shape, generator=gen, device="cuda").to(dtype)  # noqa: E731
    return (mk(B, Sq, H, dh).transpose(1, 2), mk(B, T, K, dh).transpose(1, 2),
            mk(B, T, K, dh).transpose(1, 2))


@pytest.mark.parametrize("dh", [32, 64, 80, 128])
@pytest.mark.parametrize("path", ["mma", "fma"])
@pytest.mark.parametrize("causal,window,Sq,T", [(True, None, 130, 130), (True, 40, 200, 200),
                                                (False, None, 64, 200)])
def test_flash_attention_lse(gen, dh, path, causal, window, Sq, T):
    """K1 writes the natural-log row lse on both paths (mma keeps its running
    max in log2 units); without lse its output is the same bits."""
    dtype = torch.bfloat16 if path == "mma" else torch.float32
    q, k, v = _attn_inputs(gen, 2, 6, 2, Sq, T, dh, dtype)
    assert k1.plan_call(q, k, v) == path
    n = ops.launch_counts()["flash_attention"]
    o, lse = ops.flash_attention(q, k, v, causal=causal, window=window, return_lse=True)
    assert ops.launch_counts()["flash_attention"] == n + 1
    want_o, want_lse = ref.flash_attention_ref(q, k, v, causal=causal, window=window,
                                               return_lse=True)
    torch.testing.assert_close(o, want_o, **_tol(dtype))
    torch.testing.assert_close(lse, want_lse, **_tol(dtype))
    assert torch.equal(ops.flash_attention(q, k, v, causal=causal, window=window), o)


@pytest.mark.parametrize("dh", [32, 64, 80, 128])
@pytest.mark.parametrize("mask", ["causal", "window", "cross"])
@pytest.mark.parametrize("G", [1, 3, 4])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_bwd_kernel(gen, dh, mask, G, dtype):
    """K1's backward against flash_attention_bwd_ref: causal, a window, and
    the non-causal cross attention with Sq != T; GQA; dh 80's columns 64-79."""
    Sq, T = {"causal": (130, 130), "window": (200, 200), "cross": (64, 200)}[mask]
    causal, window = mask != "cross", (40 if mask == "window" else None)
    B, K = 2, 2
    q, k, v = _attn_inputs(gen, B, K * G, K, Sq, T, dh, dtype)
    o, lse = ref.flash_attention_ref(q, k, v, causal=causal, window=window, return_lse=True)
    do = torch.randn(B, Sq, K * G, dh, generator=gen, device="cuda").to(dtype).transpose(1, 2)
    assert k1b.plan_call(q, k, v, o, do) == ("mma" if dtype == torch.bfloat16 else "fma")
    n = ops.launch_counts()["flash_attention_bwd"]
    got = ops.flash_attention_bwd(q, k, v, o, lse, do, causal=causal, window=window)
    assert ops.launch_counts()["flash_attention_bwd"] == n + 1
    want = ref.flash_attention_bwd_ref(q, k, v, o, lse, do, causal=causal, window=window)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        assert a.shape == b.shape and a.dtype == b.dtype, name
        torch.testing.assert_close(a, b, **_tol(dtype))
        if dh == 80:
            assert a[..., 64:].abs().sum() > 0, name
    again = ops.flash_attention_bwd(q, k, v, o, lse, do, causal=causal, window=window)
    assert all(torch.equal(a, b) for a, b in zip(got, again))   # no atomics


def test_flash_attention_bwd_bf16_unaligned_takes_fma(gen):
    """bf16 rows the 16-byte copies cannot take (dh + 1 apart) plan "fma" and
    still match the plain version."""
    B, H, K, S, dh = 2, 4, 2, 96, 64
    odd = lambda n: torch.randn(B, S, n, dh + 1, generator=gen, device="cuda").to(  # noqa: E731
        torch.bfloat16)[..., :dh].transpose(1, 2)
    q, k, v, do = odd(H), odd(K), odd(K), odd(H)
    o, lse = ref.flash_attention_ref(q, k, v, causal=True, return_lse=True)
    assert k1b.plan_call(q, k, v, o, do) == "fma"
    got = ops.flash_attention_bwd(q, k, v, o, lse, do)
    want = ref.flash_attention_bwd_ref(q, k, v, o, lse, do)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, **_tol(torch.bfloat16))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_bwd_split_dq(gen, dtype):
    """Sq 64 against T 1500 (whisper's cross attention, one head pair): the
    mma path splits the dq pass over the kv range and sums the partials in a
    fixed order; both paths match the plain version and repeat their bits."""
    B, H, K, Sq, T, dh = 1, 2, 2, 64, 1500, 64
    q, k, v = _attn_inputs(gen, B, H, K, Sq, T, dh, dtype)
    do = torch.randn(B, Sq, H, dh, generator=gen, device="cuda").to(dtype).transpose(1, 2)
    o, lse = ops.flash_attention(q, k, v, causal=False, return_lse=True)
    path = k1b.plan_call(q, k, v, o, do)
    assert path == ("mma" if dtype == torch.bfloat16 else "fma")
    if path == "mma":
        assert k1b.dq_plan(B, H, Sq, T, torch.cuda.get_device_properties(0)
                           .multi_processor_count).splits >= 2
    got = ops.flash_attention_bwd(q, k, v, o, lse, do, causal=False)
    want = ref.flash_attention_bwd_ref(q, k, v, o, lse, do, causal=False)
    for a, b in zip(got, want):
        atol = _tol(dtype)["atol"] * min(1.0, float(b.float().abs().max()))
        torch.testing.assert_close(a, b, atol=atol, rtol=_tol(dtype)["rtol"])
    again = ops.flash_attention_bwd(q, k, v, o, lse, do, causal=False)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.parametrize("Sq,T,causal", [(130, 130, True), (64, 1500, False)])
def test_flash_attention_bwd_in_a_cuda_graph(gen, Sq, T, causal):
    """The mma path forks its dq pass onto a second stream and joins it: a
    captured backward (split dq included) replays to the eager call's bits,
    on new inputs copied into the captured ones."""
    B, H, K, dh = 1, 4, 2, 64
    q, k, v = _attn_inputs(gen, B, H, K, Sq, T, dh, torch.bfloat16)
    do = torch.randn(B, Sq, H, dh, generator=gen, device="cuda").to(torch.bfloat16).transpose(1, 2)
    o, lse = ops.flash_attention(q, k, v, causal=causal, return_lse=True)
    assert k1b.plan_call(q, k, v, o, do) == "mma"
    run = lambda: ops.flash_attention_bwd(q, k, v, o, lse, do, causal=causal)  # noqa: E731
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        run()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = run()
    do.copy_(torch.randn(B, Sq, H, dh, generator=gen, device="cuda").to(torch.bfloat16)
             .transpose(1, 2))
    graph.replay()
    torch.cuda.synchronize()
    want = run()
    assert all(torch.equal(a, b) for a, b in zip(out, want))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_bwd_masked_rows_give_zeros(gen, dtype):
    """q rows that see no key (non-causal, window 1, rows past T: lse -1e30
    on both forward paths, as the JAX package gives it) get zero dq, not NaN;
    every gradient matches the plain version."""
    q, k, v = _attn_inputs(gen, 1, 4, 2, 100, 70, 64, dtype)
    do = torch.randn(1, 100, 4, 64, generator=gen, device="cuda").to(dtype).transpose(1, 2)
    o, lse = ops.flash_attention(q, k, v, causal=False, window=1, return_lse=True)
    assert torch.all(lse[..., 70:] == ref.NEG_INF) and torch.isfinite(lse[..., :70]).all()
    got = ops.flash_attention_bwd(q, k, v, o, lse, do, causal=False, window=1)
    assert not got[0][:, :, 70:].abs().sum()
    want = ref.flash_attention_bwd_ref(q, k, v, o, lse, do, causal=False, window=1)
    for a, b in zip(got, want):
        assert torch.isfinite(a).all()
        torch.testing.assert_close(a, b, **_tol(dtype))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_attention_autograd_runs_the_kernels(gen, dtype):
    """attention() under autograd: K1 with lse forward, K1's backward; the
    gradients are the kernels' and match autograd of the plain version."""
    q, k, v = (t.transpose(1, 2).detach().requires_grad_()
               for t in _attn_inputs(gen, 2, 6, 2, 96, 96, 64, dtype))
    do = torch.randn(q.shape, generator=gen, device="cuda").to(dtype)
    n = ops.launch_counts()
    out = attention(q, k, v, causal=True, window=33)
    out.backward(do)
    after = ops.launch_counts()
    assert after["flash_attention"] == n["flash_attention"] + 1
    assert after["flash_attention_bwd"] == n["flash_attention_bwd"] + 1
    qr, kr, vr = (t.detach().float().transpose(1, 2).requires_grad_() for t in (q, k, v))
    ref.flash_attention_ref(qr, kr, vr, causal=True, window=33).backward(
        do.float().transpose(1, 2))
    for t, r in zip((q, k, v), (qr, kr, vr)):
        torch.testing.assert_close(t.grad.float(), r.grad.transpose(1, 2), **_tol(dtype))


@pytest.mark.parametrize("arch", ["minitron-4b-smoke", "zamba2-2.7b-smoke",
                                  "whisper-small-smoke"])
def test_train_step_card_vs_cpu(gen, arch):
    """One f32 train step on the card (K1, K1's backward) and on the CPU
    (plain versions) from the same weights: loss within 1e-4, gradients
    within 1e-3."""
    from repro_torch.training import optim, trainer

    cfg = get_arch(arch)
    p_cpu = T.init_params(cfg, seed=0, device="cpu")
    p_gpu = T.params_from_numpy(_numpy_tree(p_cpu), cfg)
    rng = np.random.default_rng(1)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (2, 24), dtype=np.int32),
             "labels": rng.integers(0, cfg.vocab_size, (2, 24), dtype=np.int32)}
    if cfg.family == "audio":
        batch["frames"] = rng.standard_normal((2, cfg.encoder_seq, cfg.d_model)).astype(
            np.float32)
    n = ops.launch_counts()
    l_gpu, _, g_gpu = trainer.loss_and_grads(p_gpu, cfg, trainer.batch_to(batch, "cuda"))
    after = ops.launch_counts()
    assert after["flash_attention"] > n["flash_attention"]
    assert after["flash_attention_bwd"] > n["flash_attention_bwd"]
    l_cpu, _, g_cpu = trainer.loss_and_grads(p_cpu, cfg, trainer.batch_to(batch, "cpu"))
    assert abs(float(l_gpu) - float(l_cpu)) < 1e-4
    for a, b in zip(optim.tree_leaves(g_gpu), optim.tree_leaves(g_cpu)):
        torch.testing.assert_close(a.cpu(), b, atol=1e-3, rtol=0)
    opt_cfg = optim.AdamWConfig(warmup_steps=1, total_steps=4)
    step = trainer.make_train_step(cfg, opt_cfg)
    _, opt, stats = step(p_gpu, optim.init_opt_state(p_gpu), batch)
    assert opt["step"] == 1 and torch.isfinite(stats["loss"])


def _train_batch(cfg, seed, B=2, S=24):
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, cfg.vocab_size, (B, S), dtype=np.int32),
            "labels": rng.integers(0, cfg.vocab_size, (B, S), dtype=np.int32)}


@pytest.mark.parametrize("arch", ["mixtral-8x7b-smoke", "arctic-480b-smoke", "rwkv6-3b-smoke"])
def test_train_step_card_vs_cpu_moe_and_rwkv6(gen, arch):
    """One f32 train step of moe (K4 and its backward) and rwkv6 (K5 and its
    backward) on the card against the CPU's plain versions: loss within
    1e-4, gradients within 1e-3; every K4 / K5 call of the step launches its
    forward and backward kernel."""
    from repro_torch.training import optim, trainer

    cfg = get_arch(arch)
    p_cpu = T.init_params(cfg, seed=0, device="cpu")
    p_gpu = T.params_from_numpy(_numpy_tree(p_cpu), cfg)
    batch = _train_batch(cfg, 1)
    n = ops.launch_counts()
    l_gpu, _, g_gpu = trainer.loss_and_grads(p_gpu, cfg, trainer.batch_to(batch, "cuda"))
    launched = {k: c - n[k] for k, c in ops.launch_counts().items()}
    fwd, bwd = ("moe_gmm", "moe_gmm_bwd") if cfg.is_moe else ("rwkv6_scan", "rwkv6_scan_bwd")
    per_layer = 3 if cfg.is_moe else 1
    assert launched[fwd] == launched[bwd] == per_layer * cfg.num_layers, launched
    l_cpu, _, g_cpu = trainer.loss_and_grads(p_cpu, cfg, trainer.batch_to(batch, "cpu"))
    assert abs(float(l_gpu) - float(l_cpu)) < 1e-4
    for a, b in zip(optim.tree_leaves(g_gpu), optim.tree_leaves(g_cpu)):
        torch.testing.assert_close(a.cpu(), b, atol=1e-3, rtol=0)
    step = trainer.make_train_step(cfg, optim.AdamWConfig(warmup_steps=1, total_steps=4))
    _, opt, stats = step(p_gpu, optim.init_opt_state(p_gpu), batch)
    assert opt["step"] == 1 and torch.isfinite(stats["loss"])


@pytest.mark.parametrize("arch,kwargs", [
    ("minitron-4b-smoke", dict(remat=True)), ("mixtral-8x7b-smoke", dict(remat=True)),
    ("minitron-4b-smoke", dict(microbatches=2)), ("rwkv6-3b-smoke", dict(microbatches=2))])
def test_train_step_remat_and_microbatches_card_vs_cpu(gen, arch, kwargs):
    """make_train_step(remat=True) (FlashAttention's and MoeGmm's forward
    re-run under torch.utils.checkpoint) and microbatches=2 on the card
    against the same step on the CPU: loss 1e-4, the first moment (the
    clipped gradient scaled by 1 - b1) 1e-3."""
    from repro_torch.training import optim, trainer

    cfg = get_arch(arch)
    p_cpu = T.init_params(cfg, seed=0, device="cpu")
    p_gpu = T.params_from_numpy(_numpy_tree(p_cpu), cfg)
    batch = _train_batch(cfg, 2, B=4, S=16)
    opt_cfg = optim.AdamWConfig(warmup_steps=1, total_steps=4)
    out = {}
    for device, p in (("cuda", p_gpu), ("cpu", p_cpu)):
        step = trainer.make_train_step(cfg, opt_cfg, device=device, **kwargs)
        out[device] = step(p, optim.init_opt_state(p), batch)
    (_, opt_g, st_g), (_, opt_c, st_c) = out["cuda"], out["cpu"]
    assert abs(float(st_g["loss"]) - float(st_c["loss"])) < 1e-4
    for a, b in zip(optim.tree_leaves(opt_g["m"]), optim.tree_leaves(opt_c["m"])):
        b1c = 1 - opt_cfg.b1
        torch.testing.assert_close(a.cpu() / b1c, b / b1c, atol=1e-3, rtol=0)


@pytest.mark.parametrize("E,C,D,F,sizes", [
    (4, 64, 96, 128, [0, 64, 22, 5]),             # dx on wgmma: a dead and a full expert
    (3, 200, 136, 264, [0, 200, 77]),             # C, D, F off every tile
    (8, 320, 256, 512, [320, 300, 0, 1, 129, 128, 64, 250]),   # mixtral's training C
    (2, 32, 64, 48, [32, 7]),                     # C <= 32: dx on wgmma, one short tile
    (3, 12, 1032, 136, [12, 0, 5]),
    (8, 320, 256, 512, [0, 1, 15, 63, 64, 65, 319, 320]),   # every k-tile edge of dw
    (8, 320, 200, 264, [320, 0, 65, 64, 1, 0, 319, 63]),    # D, F off dw's 128 x 256 tile
    (3, 24, 136, 72, [24, 0, 13]),                # C <= 32: one short k-tile of dw
    # dx's stream-K: 40 live tiles of 64 k-steps, fewer than the SMs, each
    # cut across about three blocks
    (8, 320, 512, 4096, [266, 239, 249, 246, 286, 264, 239, 259]),
    # 133 live tiles, one more than an H100's SMs: one full round, then the
    # last tile's 64 k-steps cut across four blocks
    (8, 320, 1792, 4096, [320, 257, 300, 256, 129, 200, 140, 250]),
    (8, 320, 512, 4000, [266, 0, 249, 1, 320, 264, 129, 128]),   # F no multiple of 64
    (8, 320, 512, 4096, [0] * 8),                 # every expert dead
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_moe_gmm_bwd_kernel(gen, E, C, D, F, sizes, dtype):
    """dx and dw against the plain version (2e-4 f32; 2e-2 bf16, atol scaled
    to the largest value); rows past group_sizes[e] exact zeros in dx; an
    expert with no live row gets a zero dw; two calls give the same bits;
    each gradient alone when only it is asked for.  bf16 dw's contraction
    ends at each expert's live rows: live counts at and around its 64-row
    k-tile edges, all of C and none.  bf16 dx's stream-K schedule: tiles
    fewer than the SMs, one more than the SMs, a ragged last k-step, no live
    tile."""
    x = torch.randn(E, C, D, generator=gen, device="cuda").to(dtype)
    w = (torch.randn(E, D, F, generator=gen, device="cuda") * D ** -0.5).to(dtype)
    dy = torch.randn(E, C, F, generator=gen, device="cuda").to(dtype)
    gs = torch.tensor(sizes, dtype=torch.int32, device="cuda")
    n = ops.launch_counts()["moe_gmm_bwd"]
    dx, dw = ops.moe_gmm_bwd(x, w, gs, dy)
    assert ops.launch_counts()["moe_gmm_bwd"] == n + 1
    want = ref.moe_gmm_bwd_ref(x, w, gs, dy)
    for got, exp in zip((dx, dw), want):
        tol = _tol(dtype)
        tol["atol"] *= min(1.0, float(exp.float().abs().max()))
        torch.testing.assert_close(got, exp, **tol)
    for e, size in enumerate(sizes):
        assert torch.count_nonzero(dx[e, size:]) == 0
        if size == 0:
            assert torch.count_nonzero(dw[e]) == 0
    if not any(sizes):
        assert torch.count_nonzero(dx) == 0 and torch.count_nonzero(dw) == 0
    again = ops.moe_gmm_bwd(x, w, gs, dy)
    assert torch.equal(dx, again[0]) and torch.equal(dw, again[1])
    only_dx = ops.moe_gmm_bwd(x, w, gs, dy, need_dw=False)
    only_dw = ops.moe_gmm_bwd(x, w, gs, dy, need_dx=False)
    assert only_dx[1] is None and torch.equal(only_dx[0], dx)
    assert only_dw[0] is None and torch.equal(only_dw[1], dw)


def test_moe_gmm_bwd_paths(gen):
    """bf16 takes wgmma for dx and dw in the model's layouts; a dy with
    misaligned rows, or one that is no tensor map (rows overlapping), and an
    x that is no tensor map, are refused, never sent down another path; in
    a CUDA graph, replays with new group sizes give the plain version's."""
    E, C, D, F = 4, 64, 128, 256
    x = torch.randn(E, C, D, generator=gen, device="cuda").to(torch.bfloat16)
    w = (torch.randn(E, D, F, generator=gen, device="cuda") * D ** -0.5).to(torch.bfloat16)
    dy = torch.randn(E, C, F, generator=gen, device="cuda").to(torch.bfloat16)
    gs = torch.tensor([64, 3, 0, 40], dtype=torch.int32, device="cuda")
    assert k4b.plan_call(x, w, dy) == k4b.Plan("wgmma", "wgmma")
    with pytest.raises(ValueError, match="dw reads x and dy as tensor maps"):
        ops.moe_gmm_bwd(x[:, :1].expand(E, C, D), w, gs, dy, need_dx=False)
    odd = torch.randn(E * C, F + 4, generator=gen, device="cuda").to(torch.bfloat16)
    odd[:, :F] = dy.reshape(E * C, F)
    dy_odd = odd[:, :F].view(E, C, F)
    # a row stride of F + 4 elements is not 16-byte aligned: the wrapper raises
    with pytest.raises(ValueError, match="multiples of 8"):
        ops.moe_gmm_bwd(x, w, gs, dy_odd)
    with pytest.raises(ValueError, match="tensor maps"):
        ops.moe_gmm_bwd(x, w, gs, dy[:, :1].expand(E, C, F))
    want = ref.moe_gmm_bwd_ref(x, w, gs, dy)
    got = ops.moe_gmm_bwd(x, w, gs, dy)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, **_tol(torch.bfloat16))
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        ops.moe_gmm_bwd(x, w, gs, dy)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        dx, dw = ops.moe_gmm_bwd(x, w, gs, dy)
    for sizes in ([0, 0, 0, 0], [64] * 4, [1, 63, 33, 32]):
        gs.copy_(torch.tensor(sizes, dtype=torch.int32))
        graph.replay()
        torch.cuda.synchronize()
        for a, b in zip((dx, dw), ref.moe_gmm_bwd_ref(x, w, gs, dy)):
            torch.testing.assert_close(a, b, **_tol(torch.bfloat16))


@pytest.mark.parametrize("D,F,sizes", [
    (512, 4096, [266, 239, 249, 246, 286, 264, 239, 259]),   # tiles cut across blocks
    (1792, 4096, [320, 257, 300, 256, 129, 200, 140, 250]),  # a full round, then one tile
])
def test_moe_gmm_bwd_dx_graph_replay_is_bit_equal(gen, D, F, sizes):
    """bf16 dx replayed from a CUDA graph gives the eager call's bits (its
    stream-K pieces are summed in block order, its flags cleared in the
    call), also after new group sizes are copied in: the graph holds no
    schedule read on the host."""
    E, C = 8, 320
    x = torch.randn(E, C, D, generator=gen, device="cuda").to(torch.bfloat16)
    w = (torch.randn(E, D, F, generator=gen, device="cuda") * D ** -0.5).to(torch.bfloat16)
    dy = torch.randn(E, C, F, generator=gen, device="cuda").to(torch.bfloat16)
    gs = torch.tensor(sizes, dtype=torch.int32, device="cuda")
    eager = ops.moe_gmm_bwd(x, w, gs, dy, need_dw=False)[0]
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        ops.moe_gmm_bwd(x, w, gs, dy, need_dw=False)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        dx, _ = ops.moe_gmm_bwd(x, w, gs, dy, need_dw=False)
    for _ in range(2):
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(dx, eager)
    gs.copy_(torch.tensor(sizes[::-1], dtype=torch.int32))
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(dx, ops.moe_gmm_bwd(x, w, gs, dy, need_dw=False)[0])


@pytest.mark.parametrize("B,H,T,dh", [(1, 2, 1, 16), (2, 3, 37, 32), (2, 4, 70, 64),
                                      (1, 2, 64, 64)] + [
    (2, 3, T, dh) for T in (1, 8, 9, 17, 200) for dh in (16, 32, 64)])
@pytest.mark.parametrize("ds_final", [True, False])
def test_rwkv6_scan_bwd_kernel(gen, B, H, T, dh, ds_final):
    """The reverse scan against the plain version at 2e-4 (atol scaled to
    the largest value), r/k/v/w as (B, H, T, dh) views of (B, T, H, dh)
    memory as the model passes them, T ragged against the checkpoints and
    against the two 8-step halves a chunk is walked in (1, 8, 9, 17, 200);
    two calls give the same bits; the forward's output is unchanged by
    writing the checkpoints."""
    def rnd(*shape, scale=0.5):
        return torch.randn(*shape, generator=gen, device="cuda") * scale

    r, k, v = (rnd(B, T, H, dh).transpose(1, 2) for _ in range(3))
    w = torch.sigmoid(rnd(B, T, H, dh, scale=1.0)).transpose(1, 2)
    u, s0 = rnd(H, dh, scale=0.3), rnd(B, H, dh, dh, scale=0.1)
    dout = rnd(B, T, H, dh, scale=1.0).transpose(1, 2)
    dsf = rnd(B, H, dh, dh, scale=0.5) if ds_final else None
    ck = torch.empty(k5.checkpoint_shape(B, H, T, dh), device="cuda")
    out, sf = ops.rwkv6_scan(r, k, v, w, u, s0, checkpoints=ck)
    out0, sf0 = ops.rwkv6_scan(r, k, v, w, u, s0)
    assert torch.equal(out, out0) and torch.equal(sf, sf0)
    n = ops.launch_counts()["rwkv6_scan_bwd"]
    got = ops.rwkv6_scan_bwd(r, k, v, w, u, s0, dout, dsf, checkpoints=ck)
    assert ops.launch_counts()["rwkv6_scan_bwd"] == n + 1
    want = ref.rwkv6_scan_bwd_ref(r, k, v, w, u, s0, dout, dsf)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, atol=2e-4 * min(1.0, float(b.abs().max())),
                                   rtol=2e-4)
    again = ops.rwkv6_scan_bwd(r, k, v, w, u, s0, dout, dsf, checkpoints=ck)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


def test_rwkv6_scan_bwd_refuses_what_it_does_not_take(gen):
    r = torch.randn(1, 2, 8, 16, generator=gen, device="cuda")
    u, s0 = r[0, :, 0], torch.zeros(1, 2, 16, 16, device="cuda")
    with pytest.raises(ValueError, match="checkpoints"):
        ops.rwkv6_scan_bwd(r, r, r, r, u, s0, r)
    ck = torch.empty(k5.checkpoint_shape(1, 2, 8, 16), device="cuda")
    with pytest.raises(ValueError, match="float32"):
        rb = r.to(torch.bfloat16)
        ops.rwkv6_scan_bwd(rb, rb, rb, rb, u, s0, rb, checkpoints=ck)


def _numpy_tree(tree):
    if isinstance(tree, dict):
        return {k: _numpy_tree(v) for k, v in tree.items()}
    return tree.numpy()


# -- the wrappers' fake branches (the dry-run) against the kernels -------------


def _fake_cases(gen):
    """(wrapper, its real CUDA operands, keyword arguments) at small shapes,
    with the layouts the models pass."""
    bf = torch.bfloat16
    mk = lambda *shape, dtype=bf: torch.randn(*shape, generator=gen, device="cuda").to(dtype)  # noqa: E731
    q, k, v = (mk(2, 64, h, 64).transpose(1, 2) for h in (4, 2, 2))
    o, lse = ops.flash_attention(q, k, v, return_lse=True)
    do = mk(2, 64, 4, 64).transpose(1, 2)
    qd = mk(2, 2, 2, 64)
    kc, vc = (mk(2, 80, 2, 64).transpose(1, 2) for _ in range(2))
    lengths = torch.tensor([5, 80], dtype=torch.int32, device="cuda")
    wq, scales = ops.quantize_int8(mk(256, 128, dtype=torch.float32))
    x4, w4 = mk(4, 48, 64), mk(4, 64, 128)
    gs = torch.tensor([48, 7, 0, 30], dtype=torch.int32, device="cuda")
    dy4 = mk(4, 48, 128)
    f32 = torch.float32
    r, kk, vv = (mk(2, 20, 2, 32, dtype=f32).transpose(1, 2) for _ in range(3))
    w = torch.sigmoid(mk(2, 20, 2, 32, dtype=f32)).transpose(1, 2)
    u, s0 = mk(2, 32, dtype=f32), mk(2, 2, 32, 32, dtype=f32)
    ck = torch.empty(k5.checkpoint_shape(2, 2, 20, 32), device="cuda")
    dout = mk(2, 20, 2, 32, dtype=f32).transpose(1, 2)
    return [
        ("flash_attention", (q, k, v), dict(causal=True, window=None, return_lse=True)),
        ("flash_attention_bwd", (q, k, v, o, lse, do), dict(causal=True, window=None)),
        ("decode_attention", (qd, kc, vc, lengths), dict(window=None)),
        ("int8_matmul", (mk(3, 256), wq, scales), {}),
        ("moe_gmm", (x4, w4, gs), {}),
        ("moe_gmm_bwd", (x4, w4, gs, dy4), dict(need_dx=True, need_dw=True)),
        ("rwkv6_scan", (r, kk, vv, w, u, s0), dict(checkpoints=ck)),
        ("rwkv6_scan_bwd", (r, kk, vv, w, u, s0, dout, None), dict(checkpoints=ck)),
    ]


def _layout(out):
    outs = out if isinstance(out, tuple) else (out,)
    return [None if t is None else (tuple(t.shape), t.dtype, t.stride()) for t in outs]


def test_fake_branches_return_the_kernels_outputs(gen):
    """Each of the eight wrappers on fake copies of its operands returns
    outputs of the shapes, dtypes and strides the kernel returns on the
    card, and launches nothing; on the real operands it launches once and
    never enters its fake branch."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.kernels import fake

    cases = _fake_cases(gen)
    assert sorted(name for name, _, _ in cases) == sorted(ops.launch_counts())
    for name, args, kw in cases:
        n = ops.launch_counts()
        real = getattr(ops, name)(*args, **kw)
        after = ops.launch_counts()
        assert after[name] == n[name] + 1 and sum(after.values()) == sum(n.values()) + 1
        mode = FakeTensorMode()
        fakes = [None if a is None else mode.from_tensor(a) for a in args]
        fkw = {k: mode.from_tensor(v) if torch.is_tensor(v) else v for k, v in kw.items()}
        with mode:
            got = getattr(ops, name)(*fakes, **fkw)
        assert ops.launch_counts() == after, name
        assert _layout(got) == _layout(real), name
        assert all(t is None or ops.is_fake(t) for t in (got if isinstance(got, tuple)
                                                         else (got,)))
    # real tensors never reach a fake branch
    for attr in ("flash_attention", "flash_attention_bwd", "decode_attention",
                 "int8_matmul", "moe_gmm", "moe_gmm_bwd", "rwkv6_scan", "rwkv6_scan_bwd"):
        original = getattr(fake, attr)
        setattr(fake, attr, lambda *a, **k: pytest.fail("a real tensor took the fake branch"))
        try:
            name_args = [c for c in cases if c[0] == attr][0]
            getattr(ops, attr)(*name_args[1], **name_args[2])
        finally:
            setattr(fake, attr, original)


def test_real_dtensors_launch_the_kernels(gen):
    """F8 on the card: each of the eight wrappers on DTensors over real CUDA
    shards (the 1x1 host mesh) launches its kernel once and returns, as
    DTensors, the plain call's outputs."""
    from torch.distributed.tensor import DTensor, Replicate

    from repro_torch.launch import mesh as mesh_lib

    mesh = mesh_lib.make_host_mesh()
    assert mesh.device_type == "cuda"
    try:
        for name, args, kw in _fake_cases(gen):
            want = getattr(ops, name)(*args, **kw)
            dist = [None if a is None else DTensor.from_local(a, mesh, [Replicate()] * 2)
                    for a in args]
            assert not ops.is_fake(dist[0])
            n = ops.launch_counts()
            got = getattr(ops, name)(*dist, **kw)
            after = ops.launch_counts()
            assert after[name] == n[name] + 1 and sum(after.values()) == sum(n.values()) + 1
            got = got if isinstance(got, tuple) else (got,)
            want = want if isinstance(want, tuple) else (want,)
            assert len(got) == len(want), name
            for a, b in zip(got, want):
                if b is None:
                    assert a is None, name
                    continue
                assert isinstance(a, DTensor), name
                torch.testing.assert_close(a.full_tensor(), b, rtol=0, atol=0, msg=name)
    finally:
        mesh_lib.release()


def test_dryrun_on_the_card_launches_nothing(gen):
    """The dry-run on the card's 1x1 mesh (fake CUDA tensors) traces prefill,
    decode and a train step of two smoke archs without one launch."""
    from repro_torch.configs import ShapeConfig
    from repro_torch.launch import dryrun
    from repro_torch.launch import mesh as mesh_lib

    mesh = mesh_lib.make_host_mesh()
    assert mesh.device_type == "cuda"
    try:
        for arch in ("minitron-4b-smoke", "mixtral-8x7b-smoke", "rwkv6-3b-smoke"):
            for kind in ("prefill", "decode", "train"):
                before = ops.launch_counts()
                trace, traced, _ = dryrun.trace_step(get_arch(arch),
                                                     ShapeConfig(kind, 32, 2, kind), mesh)
                assert traced == kind and ops.launch_counts() == before
                assert trace.kernels and trace.flops > 0
    finally:
        mesh_lib.release()


def test_si2_decode_spans_carry_the_replay_device_time(gen):
    """Each executed decode of a continuous batch on SI2 records its graph
    replay's device time (CUDA events, read after the closing sync): above
    zero and within the host-timed call; an EagerEngine times none."""
    from repro_torch.serving.request import synth_workload
    from repro_torch.serving.scheduler import ContinuousBatchScheduler

    cfg = get_arch("minitron-4b-smoke")
    params = T.init_params(cfg, seed=0, device="cuda")
    si2 = CompiledEngine(cfg, params, 64)
    assert si2.last_decode_device_ns() == -1
    for engine in (si2, EagerEngine(cfg, params, 64)):
        sched = ContinuousBatchScheduler(engine, num_slots=4, max_seq=64)
        sched.run(synth_workload(6, 8, 5, cfg.vocab_size, rate_per_s=300, seed=4))
        decodes = [s for s in sched.core.wall_log.spans() if s.name == "repro_torch.decode"]
        assert decodes
        for s in decodes:
            if engine is si2:
                assert 0 < s.device_ns <= s.end_ns - s.start_ns
            else:
                assert s.device_ns == -1
