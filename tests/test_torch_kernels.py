"""The kernels' plain PyTorch versions against the JAX package's oracles.

Same sweeps and tolerances as tests/test_kernels.py; inputs are made with
numpy from a seed and handed to both packages.  On the CPU the port's
wrappers run these plain versions; the CUDA kernels are held against them on
the card by chip_smoke.py and tests/test_torch_cuda.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.int8_matmul import quantize_int8 as j_quantize
from repro_torch.kernels import ops, ref

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _tol(dtype):
    return dict(atol=2e-2, rtol=2e-2) if dtype == "bfloat16" else dict(
        atol=2e-4, rtol=2e-4)


def _pair(seed, shape, dtype):
    """The same values in both packages (bf16 rounds identically in both)."""
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    jd, td = DTYPES[dtype]
    return jnp.asarray(x).astype(jd), torch.from_numpy(x).to(td)


def _close(t, j, **tol):
    np.testing.assert_allclose(t.float().numpy(), np.asarray(j, np.float32), **tol)


@pytest.mark.parametrize("B,H,K,S,dh", [
    (1, 2, 1, 32, 16),
    (2, 4, 2, 64, 32),
    (1, 8, 8, 128, 64),   # MHA
    (2, 6, 2, 96, 32),    # non-pow2 seq
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("window", [None, 17])
def test_flash_attention_ref_sweep(B, H, K, S, dh, dtype, window):
    jq, q = _pair(0, (B, H, S, dh), dtype)
    jk, k = _pair(1, (B, K, S, dh), dtype)
    jv, v = _pair(2, (B, K, S, dh), dtype)
    o = ops.flash_attention(q, k, v, causal=True, window=window,
                            block_q=32, block_kv=32)
    assert o.dtype == q.dtype and o.shape == q.shape
    _close(o, jref.flash_attention_ref(jq, jk, jv, causal=True, window=window),
           **_tol(dtype))


def test_flash_attention_ref_non_causal():
    jq, q = _pair(3, (2, 4, 24, 32), "float32")
    jk, k = _pair(4, (2, 2, 40, 32), "float32")
    jv, v = _pair(5, (2, 2, 40, 32), "float32")
    _close(ref.flash_attention_ref(q, k, v, causal=False),
           jref.flash_attention_ref(jq, jk, jv, causal=False), **_tol("float32"))


@pytest.mark.parametrize("B,K,G,S,dh", [
    (1, 1, 4, 64, 32),
    (2, 2, 4, 128, 32),
    (3, 4, 1, 96, 64),
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_attention_ref_sweep(B, K, G, S, dh, dtype):
    jq, q = _pair(3, (B, K, G, dh), dtype)
    jkc, kc = _pair(4, (B, K, S, dh), dtype)
    jvc, vc = _pair(5, (B, K, S, dh), dtype)
    lengths = np.arange(B, dtype=np.int32) * 17 % S + 1
    o = ops.decode_attention(q, kc, vc, torch.from_numpy(lengths), block_s=32)
    _close(o, jref.decode_attention_ref(jq, jkc, jvc, jnp.asarray(lengths)),
           **_tol(dtype))


def test_decode_attention_ref_window():
    B, K, G, S, dh = 2, 2, 2, 128, 32
    jq, q = _pair(6, (B, K, G, dh), "float32")
    jkc, kc = _pair(7, (B, K, S, dh), "float32")
    jvc, vc = _pair(8, (B, K, S, dh), "float32")
    lengths = np.array([100, 128], np.int32)
    o = ops.decode_attention(q, kc, vc, torch.from_numpy(lengths), window=16)
    _close(o, jref.decode_attention_ref(jq, jkc, jvc, jnp.asarray(lengths),
                                        window=16), atol=2e-4, rtol=2e-4)


@pytest.mark.parametrize("M,D,N", [(16, 64, 32), (48, 128, 64)])
def test_int8_matmul_ref_sweep(M, D, N):
    jx, x = _pair(11, (M, D), "float32")
    jw, w = _pair(12, (D, N), "float32")
    wq, sc = ops.quantize_int8(w)
    o = ops.int8_matmul(x, wq, sc, block_m=16, block_n=16, block_d=32)
    jwq, jsc = j_quantize(jw)
    _close(o, jref.int8_matmul_ref(jx, jwq, jsc), atol=1e-3, rtol=1e-3)
    full = (x @ w).numpy()
    rel = np.abs(o.numpy() - full).mean() / np.abs(full).mean()
    assert rel < 0.02, rel


@pytest.mark.parametrize("shape,dtype", [
    ((64, 32), "float32"), ((3, 128, 48), "float32"), ((2, 96, 40), "bfloat16"),
])
def test_quantize_int8_bit_identical(shape, dtype):
    jw, w = _pair(13, shape, dtype)
    # exact ties (x.5 after the divide) must round half to even in both
    if dtype == "float32":
        w[..., 0, :] = 127.0
        w[..., 1, :] = 0.5
        jw = jnp.asarray(w.numpy())
    wq, sc = ops.quantize_int8(w)
    jwq, jsc = j_quantize(jw)
    assert wq.dtype == torch.int8 and sc.dtype == torch.float32
    np.testing.assert_array_equal(wq.numpy(), np.asarray(jwq))
    np.testing.assert_array_equal(sc.numpy(), np.asarray(jsc))


def test_wrappers_reject_other_devices():
    x = torch.empty((4, 8), device="meta")
    with pytest.raises(ValueError, match="device"):
        ops.int8_matmul(x, torch.empty((8, 16), dtype=torch.int8, device="meta"),
                        torch.empty((16,), device="meta"))
    q = torch.empty((1, 2, 8, 32), device="meta")
    with pytest.raises(ValueError, match="device"):
        ops.flash_attention(q, q, q)
    with pytest.raises(ValueError, match="device"):
        ops.decode_attention(q, q, q, torch.empty((1,), dtype=torch.int32, device="meta"))


def test_launch_counters_untouched_on_cpu():
    ops.reset_launch_counts()
    _, x = _pair(14, (4, 32), "float32")
    wq, sc = ops.quantize_int8(x.T.contiguous())
    ops.int8_matmul(x, wq, sc)
    assert ops.launch_counts() == {"flash_attention": 0, "decode_attention": 0,
                                   "int8_matmul": 0}
