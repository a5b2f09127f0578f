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


@pytest.mark.parametrize("M,D,N", [(4, 256, 96), (48, 128, 64), (300, 520, 136)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_int8_matmul_kernel(gen, M, D, N, dtype):
    x = torch.randn(M, D, generator=gen, device="cuda").to(dtype)
    wq, sc = ops.quantize_int8(torch.randn(D, N, generator=gen, device="cuda"))
    tol = dict(atol=1e-3, rtol=1e-3) if dtype == torch.float32 else _tol(dtype)
    torch.testing.assert_close(ops.int8_matmul(x, wq, sc),
                               ref.int8_matmul_ref(x, wq, sc), **tol)


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
