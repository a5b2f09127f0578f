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

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.int8_matmul import quantize_int8 as j_quantize
from repro.models.ssm import rwkv6_wkv_step as j_wkv_step
from repro_torch.kernels import decode_attention as dk
from repro_torch.kernels import moe_gmm as k4
from repro_torch.kernels import rwkv6_scan as k5
from repro_torch.kernels import ops, ref
from repro_torch.models.ssm import rwkv6_wkv_step

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


def _split_kv(q, kc, vc, lengths, window, splits, chunk):
    """The split-KV kernel's arithmetic (csrc/decode_attention.cu) in plain
    PyTorch: every split's (m, l, acc) over its chunk of the cache, then the
    merge, which skips a split that attended nothing (l = 0)."""
    B, K, G, dh = q.shape
    S = kc.shape[2]
    qs = q.float() * dh ** -0.5
    pos = torch.arange(S)
    attended = pos[None, :] < lengths[:, None]
    if window is not None:
        attended &= pos[None, :] >= lengths[:, None] - window
    ms, ls, accs = [], [], []
    for s in range(splits):
        span = slice(s * chunk, min((s + 1) * chunk, S))
        a = attended[:, None, None, span]
        sc = torch.einsum("bkgd,bktd->bkgt", qs, kc[:, :, span].float())
        m = torch.where(a, sc, -torch.inf).amax(-1)
        p = torch.where(a, torch.exp(sc - torch.nan_to_num(m, neginf=0.0)[..., None]), 0.0)
        ms.append(m)
        ls.append(p.sum(-1))
        accs.append(torch.einsum("bkgt,bktd->bkgd", p, vc[:, :, span].float()))
    m, l, acc = torch.stack(ms), torch.stack(ls), torch.stack(accs)
    live = l > 0
    mx = torch.where(live, m, -torch.inf).amax(0)
    f = torch.where(live, torch.exp(m - mx), 0.0)
    return (acc * f[..., None]).sum(0) / torch.clamp((l * f).sum(0), min=1e-20)[..., None]


@pytest.mark.parametrize("window", [None, 40])
@pytest.mark.parametrize("sms", [132, 2])
def test_decode_attention_split_merge_model(window, sms):
    """Splitting the cache and merging the partial softmax states computes
    the same attention as the plain version and as the JAX package's kernel
    (interpret mode), in float32: lengths 1, a multiple of the split, S, and
    one in between; the window crosses split boundaries."""
    B, K, G, S, dh = 4, 2, 3, 128, 32
    p = dk.plan(B, K, S, sms)
    assert p.splits > 1
    jq, q = _pair(21, (B, K, G, dh), "float32")
    jkc, kc = _pair(22, (B, K, S, dh), "float32")
    jvc, vc = _pair(23, (B, K, S, dh), "float32")
    lengths = np.array([1, 2 * p.chunk, S, 77], np.int32)
    got = _split_kv(q, kc, vc, torch.from_numpy(lengths), window, p.splits, p.chunk)
    tol = dict(atol=1e-5, rtol=1e-5)
    _close(got, ref.decode_attention_ref(q, kc, vc, torch.from_numpy(lengths),
                                         window=window).numpy(), **tol)
    _close(got, jops.decode_attention(jq, jkc, jvc, jnp.asarray(lengths), window=window,
                                      block_s=32), **tol)


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


@pytest.mark.parametrize("E,C,D,F", [(2, 32, 64, 48), (4, 64, 96, 128)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_gmm_ref_sweep(E, C, D, F, dtype):
    """tests/test_kernels.py's sweep: against the JAX oracle and the TPU kernel
    (interpret mode), ragged group sizes including 0 and C."""
    jx, x = _pair(9, (E, C, D), dtype)
    jw, w = _pair(10, (E, D, F), dtype)
    gs = (np.arange(E, dtype=np.int32) * 13) % (C + 1)
    gs[-1] = C
    tol = dict(atol=5e-2, rtol=5e-2) if dtype == "bfloat16" else dict(atol=1e-4, rtol=1e-4)
    o = ops.moe_gmm(x, w, torch.from_numpy(gs), block_c=16, block_f=32, block_d=32)
    assert o.dtype == x.dtype and o.shape == (E, C, F)
    _close(o, jref.moe_gmm_ref(jx, jw, jnp.asarray(gs)), **tol)
    _close(o, jops.moe_gmm(jx, jw, jnp.asarray(gs), block_c=16, block_f=32, block_d=32),
           **tol)
    dead = np.arange(C)[None, :] >= gs[:, None]
    assert not o.float().numpy()[dead].any()


def test_moe_gmm_ref_without_group_sizes():
    jx, x = _pair(11, (3, 16, 32), "float32")
    jw, w = _pair(12, (3, 32, 24), "float32")
    _close(ops.moe_gmm(x, w), jref.moe_gmm_ref(jx, jw), atol=1e-4, rtol=1e-4)


def _split_d(x, w, gs, p):
    """The mma path's arithmetic (csrc/moe_gmm.cu, gmm_decode_kernel) in plain
    PyTorch: every live expert's (D split, 128-column tile) partial in
    float32, 16-deep mma steps with the half step past a ragged D masked, the
    partials summed in split order; rows at or past group_sizes[e] and dead
    experts zeros."""
    E, C, D = x.shape
    F = w.shape[2]
    out = torch.zeros((E, C, F))
    for e in range(E):
        live = int(gs[e])
        if live <= 0:
            continue
        for n0 in range(0, F, k4.MMA_BN):
            cols = slice(n0, min(n0 + k4.MMA_BN, F))
            parts = []
            for s in range(p.splits):
                d0, d1 = s * p.k_per_split, min(D, (s + 1) * p.k_per_split)
                acc = torch.zeros((live, cols.stop - n0))
                for k16 in range(d0, d1, 16):
                    ks = slice(k16, min(k16 + 16, d1))
                    acc += x[e, :live, ks].float() @ w[e, ks, cols].float()
                parts.append(acc)
            total = torch.zeros_like(parts[0])
            for part in parts:
                total = total + part
            out[e, :live, cols] = total
    return out


def test_moe_gmm_split_d_model():
    """Splitting D across blocks and summing the partials in the kernel's
    fixed order computes what the JAX package's kernel (interpret mode) does,
    in float32: a dead expert, a full one, a ragged D (D % 16 == 8, so the
    last split ends on a half mma step) and a ragged column tile."""
    E, C, D, F = 4, 8, 1032, 264
    p = k4.plan(E, C, D, F, torch.bfloat16)
    assert p.path == "mma" and p.splits > 1 and D % p.k_per_split and D % 16 == 8
    jx, x = _pair(31, (E, C, D), "float32")
    jw, w = _pair(32, (E, D, F), "float32")
    gs = np.array([3, 0, 8, 1], np.int32)
    got = _split_d(x, w, torch.from_numpy(gs), p)
    tol = dict(atol=1e-4, rtol=1e-4)
    _close(got, ref.moe_gmm_ref(x, w, torch.from_numpy(gs)).numpy(), **tol)
    # whole blocks for the TPU kernel: its interpret mode reads past a ragged edge
    _close(got, jops.moe_gmm(jx, jw, jnp.asarray(gs), block_c=C, block_f=F, block_d=D), **tol)


def _wkv_inputs(B, H, T, dh, dtype, seed=13):
    """The sweep's inputs: r/k/v scaled 0.5, w in (0, 1), u 0.3, s0 0.1."""
    rng = np.random.default_rng(seed)
    r, k, v = (rng.standard_normal((B, H, T, dh)).astype(np.float32) * 0.5 for _ in range(3))
    w = 1.0 / (1.0 + np.exp(-rng.standard_normal((B, H, T, dh)).astype(np.float32)))
    u = rng.standard_normal((H, dh)).astype(np.float32) * 0.3
    s0 = rng.standard_normal((B, H, dh, dh)).astype(np.float32) * 0.1
    jd, td = DTYPES[dtype]
    jax_in = [jnp.asarray(a).astype(jd) for a in (r, k, v, w)] + [jnp.asarray(u), jnp.asarray(s0)]
    torch_in = [torch.from_numpy(a).to(td) for a in (r, k, v, w)] + [
        torch.from_numpy(u), torch.from_numpy(s0)]
    return jax_in, torch_in


@pytest.mark.parametrize("B,H,T,dh", [(1, 2, 32, 16), (2, 3, 48, 32)])
@pytest.mark.parametrize("chunk", [8, 16])
def test_rwkv6_scan_ref_sweep(B, H, T, dh, chunk):
    """tests/test_kernels.py's sweep: against the JAX oracle and the TPU kernel
    (interpret mode), output and final state at 2e-4."""
    jin, tin = _wkv_inputs(B, H, T, dh, "float32")
    o, sf = ops.rwkv6_scan(*tin, chunk=chunk)
    assert o.shape == (B, H, T, dh) and sf.dtype == torch.float32
    jo, jsf = jref.rwkv6_scan_ref(*jin)
    _close(o, jo, atol=2e-4, rtol=2e-4)
    _close(sf, jsf, atol=2e-4, rtol=2e-4)
    ko, ksf = jops.rwkv6_scan(*jin, chunk=chunk)
    _close(o, ko, atol=2e-4, rtol=2e-4)
    _close(sf, ksf, atol=2e-4, rtol=2e-4)


def _wkv_sliced(r, k, v, w, u, s, p):
    """The K5 kernel's decomposition (csrc/rwkv6_scan.cu) in plain PyTorch:
    blocks of p.jb value columns, p.row_groups groups of key rows per
    column, four partial sums per group, the groups' shares summed in group
    order, time in chunks of 16; each block writes its columns of the state
    back into ``s`` (in place) when it is done."""
    B, H, T, dh = r.shape
    out = torch.empty((B, H, T, dh))
    for j0 in range(0, dh, p.jb):
        cols = slice(j0, j0 + p.jb)
        S = s[:, :, :, cols].clone()   # read before the block writes
        for t0 in range(0, T, 16):
            for t in range(t0, min(t0 + 16, T)):
                rt, kt, wt = r[:, :, t], k[:, :, t], w[:, :, t]
                vt = v[:, :, t, cols]
                shares = []
                rows = dh // p.row_groups
                for g in range(p.row_groups):
                    i = torch.arange(rows * g, rows * g + rows).view(rows // 4, 4)   # [m][c]
                    kv = kt[..., i, None] * vt[:, :, None, None, :]
                    term = rt[..., i, None] * (u[None, :, i, None] * kv + S[:, :, i])
                    a = term.sum(dim=2)                        # the four partials, by c
                    shares.append((a[:, :, 0] + a[:, :, 1]) + (a[:, :, 2] + a[:, :, 3]))
                    S[:, :, i] = wt[..., i, None] * S[:, :, i] + kv
                acc = shares[0]
                for share in shares[1:]:
                    acc = acc + share
                out[:, :, t, cols] = acc
        s[:, :, :, cols] = S
    return out


@pytest.mark.parametrize("B,H,T,dh", [(1, 2, 48, 16), (2, 3, 32, 32), (1, 2, 16, 64),
                                     (1, 2, 17, 64)])
def test_rwkv6_scan_column_slice_model(B, H, T, dh):
    """Value-column slices x key-row groups x 16-step chunks compute what the
    JAX package's oracle and kernel (interpret mode, where T is whole chunks:
    it reads past a ragged one) do, in float32, with the final state written
    over the initial one."""
    p = k5.plan(B, H, dh, 132)
    assert p.jb < dh and p.row_groups == dh // 16
    jin, tin = _wkv_inputs(B, H, T, dh, "float32", seed=29)
    state = tin[5].clone()
    got = _wkv_sliced(*tin[:5], state, p)
    tol = dict(atol=1e-4, rtol=1e-4)
    wants = [jref.rwkv6_scan_ref(*jin)]
    if T % 16 == 0:
        wants.append(jops.rwkv6_scan(*jin, chunk=16))
    for jo, jsf in wants:
        _close(got, jo, **tol)
        _close(state, jsf, **tol)


def test_rwkv6_scan_ref_bf16_and_state_in_place():
    jin, tin = _wkv_inputs(2, 3, 20, 32, "bfloat16", seed=5)
    jo, jsf = jref.rwkv6_scan_ref(*jin)
    s0 = tin[5].clone()
    o, sf = ops.rwkv6_scan(*tin[:5], s0, s_out=s0)
    assert o.dtype == torch.bfloat16 and sf is s0
    _close(o, jo, **_tol("bfloat16"))
    _close(s0, jsf, atol=2e-4, rtol=2e-4)


def test_rwkv6_scan_matches_model_step():
    """The scan agrees with the model's own recurrence in both packages."""
    jin, tin = _wkv_inputs(1, 2, 16, 8, "float32", seed=19)
    s, js = torch.zeros((1, 2, 8, 8)), jnp.zeros((1, 2, 8, 8))
    outs = []
    for t in range(16):
        s, o = rwkv6_wkv_step(s, *(a[:, :, t] for a in tin[:2]), tin[2][:, :, t],
                              tin[3][:, :, t], tin[4])
        js, jo = j_wkv_step(js, *(a[:, :, t] for a in jin[:4]), jin[4])
        _close(o, jo, atol=1e-5, rtol=1e-5)
        outs.append(o)
    got, _ = ops.rwkv6_scan(*tin[:5], torch.zeros((1, 2, 8, 8)))
    _close(got, torch.stack(outs, dim=2).numpy(), atol=2e-4, rtol=2e-4)


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
    with pytest.raises(ValueError, match="device"):
        ops.moe_gmm(q, q)
    with pytest.raises(ValueError, match="device"):
        ops.rwkv6_scan(q, q, q, q, q[0, :, 0], q)
    with pytest.raises(ValueError, match="device"):
        ops.moe_gmm_bwd(q, q, None, q)
    with pytest.raises(ValueError, match="device"):
        ops.rwkv6_scan_bwd(q, q, q, q, q[0, :, 0], q, q)


def test_launch_counters_untouched_on_cpu():
    ops.reset_launch_counts()
    _, x = _pair(14, (4, 32), "float32")
    wq, sc = ops.quantize_int8(x.T.contiguous())
    ops.int8_matmul(x, wq, sc)
    _, x3 = _pair(15, (2, 8, 16), "float32")
    ops.moe_gmm(x3, x3.transpose(1, 2).contiguous())
    _, r = _pair(16, (1, 2, 4, 8), "float32")
    ops.rwkv6_scan(r, r, r, r.sigmoid(), r[0, :, 0], torch.zeros((1, 2, 8, 8)))
    o, lse = ops.flash_attention(r, r, r, return_lse=True)
    ops.flash_attention_bwd(r, r, r, o, lse, o)
    ops.moe_gmm_bwd(x3, x3.transpose(1, 2).contiguous(), None, x3[:, :, :8])
    ops.rwkv6_scan_bwd(r, r, r, r.sigmoid(), r[0, :, 0], torch.zeros((1, 2, 8, 8)), r)
    assert ops.launch_counts() == {"flash_attention": 0, "flash_attention_bwd": 0,
                                   "decode_attention": 0, "int8_matmul": 0, "moe_gmm": 0,
                                   "moe_gmm_bwd": 0, "rwkv6_scan": 0, "rwkv6_scan_bwd": 0}
