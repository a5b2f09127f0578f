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
from repro_torch.kernels import int8_matmul as k3
from repro_torch.kernels import moe_gmm as k4
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
