"""The backward of K4 (grouped expert GEMM) and K5 (WKV scan) on the CPU.

The plain backward versions (``kernels/ref.py``: ``moe_gmm_bwd_ref``,
``rwkv6_scan_bwd_ref``) and plain PyTorch models of the CUDA kernels'
decompositions (K4's dw over a ragged, masked last k-tile; K4's dx on its
stream-K schedule, its pieces summed by each tile's first block in block
order; K5's chunk checkpoints, per-chunk recompute and per-slice partials
summed in order) are
held against ``jax.vjp`` of the JAX package's oracles
(``repro.kernels.ref.moe_gmm_ref``, ``rwkv6_scan_ref``), on the same numpy
inputs, in float32 at 2e-4.  The kernels themselves are held against the
plain versions on the card (tests/test_torch_cuda.py, chip_smoke.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro_torch.kernels import moe_gmm_bwd as k4b
from repro_torch.kernels import ops, ref
from repro_torch.kernels import rwkv6_scan as k5
from repro_torch.kernels import rwkv6_scan_bwd as k5b
from repro_torch.models import ssm

TOL = dict(atol=2e-4, rtol=2e-4)


def _close(t, j, **tol):
    np.testing.assert_allclose(t.detach().float().numpy(), np.asarray(j, np.float32),
                               **(tol or TOL))


def _moe_inputs(E, C, D, F, sizes, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((E, C, D)).astype(np.float32)
    w = (rng.standard_normal((E, D, F)) * D ** -0.5).astype(np.float32)
    dy = rng.standard_normal((E, C, F)).astype(np.float32)
    return x, w, np.asarray(sizes, np.int32), dy


def _moe_vjp(x, w, gs, dy):
    _, vjp = jax.vjp(lambda a, b: jref.moe_gmm_ref(a, b, jnp.asarray(gs)), jnp.asarray(x),
                     jnp.asarray(w))
    return vjp(jnp.asarray(dy))


@pytest.mark.parametrize("E,C,D,F,sizes", [
    (4, 40, 24, 16, [0, 40, 33, 7]),       # an empty expert, a full one, ragged rows
    (3, 8, 32, 48, [8, 0, 0]),             # decode's C, two empty experts
    (2, 64, 16, 40, [64, 1]),
    (8, 20, 8, 8, [0] * 8),                # nobody routed: all zeros
])
def test_moe_gmm_bwd_ref_matches_jax_vjp(E, C, D, F, sizes):
    x, w, gs, dy = _moe_inputs(E, C, D, F, sizes, seed=E * 100 + C)
    jdx, jdw = _moe_vjp(x, w, gs, dy)
    dx, dw = ops.moe_gmm_bwd(*(torch.from_numpy(a) for a in (x, w, gs, dy)))
    _close(dx, jdx)
    _close(dw, jdw)
    for e, n in enumerate(sizes):
        assert not dx[e, n:].abs().sum()


def test_moe_gmm_bwd_computes_what_is_asked():
    x, w, gs, dy = (torch.from_numpy(a) for a in _moe_inputs(2, 8, 8, 16, [3, 8], seed=3))
    dx, dw = ops.moe_gmm_bwd(x, w, gs, dy, need_dw=False)
    assert dw is None and dx.shape == x.shape
    dx, dw = ops.moe_gmm_bwd(x, w, gs, dy, need_dx=False)
    assert dx is None and dw.shape == w.shape
    dx, dw = ops.moe_gmm_bwd(x, w, None, dy)          # every row live
    want = ref.moe_gmm_bwd_ref(x, w, torch.full((2,), 8), dy)
    torch.testing.assert_close(dx, want[0])
    torch.testing.assert_close(dw, want[1])


def _dw_tiled(x, dy, gs, bk):
    """csrc/moe_gmm_bwd.cu's dw (gmmbwd_dw_wgmma over MN-major operands) in
    plain PyTorch: per expert, k-tiles (TMA stages) of ``bk`` rows of C in
    order, the loop ending at the expert's last live row; TMA zero-fills the
    rows past C in both operands, and the consumers zero the x rows at or
    past group_sizes[e] of the last k-tile (dy's rows there come in as they
    are); an expert with no live row writes zeros."""
    E, C, D = x.shape
    out = torch.zeros((E, D, dy.shape[2]))
    for e in range(E):
        live = int(gs[e])
        for c0 in range(0, live, bk):
            rows = torch.arange(c0, c0 + bk)
            in_c = (rows < C)[:, None]
            xs = torch.where((rows < live)[:, None], x[e, rows.clamp(max=C - 1)], 0.0)
            ds = torch.where(in_c, dy[e, rows.clamp(max=C - 1)], 0.0)
            out[e] += xs.T @ ds
    return out


@pytest.mark.parametrize("sizes", [[0, 140, 64, 65], [128, 127, 1, 129]])
def test_moe_gmm_bwd_dw_ragged_k_tile_model(sizes):
    """dw's k-tiles over the live rows, the last one's dead x rows zeroed in
    shared memory: whole tiles (64, 128), a tile cut one row short (127), one
    row past a tile (65, 129), one row (1), C itself past the last tile (140)
    and an empty expert (0)."""
    x, w, gs, dy = _moe_inputs(4, 140, 24, 16, sizes, seed=7)
    got = _dw_tiled(torch.from_numpy(x), torch.from_numpy(dy), gs, k4b.DW_BK)
    _close(got, _moe_vjp(x, w, gs, dy)[1])


def _dx_stream_k(dy, w, gs, grid, bm=k4b.DX_BM, bn=k4b.DX_BN, bk=k4b.DX_BK):
    """csrc/gmm_wgmma.cuh's dx (dy w^T) on its stream-K schedule in plain
    PyTorch, with tiles of bm x bn and k-steps of bk: the live tiles (expert,
    column slab, row tile fastest) from group_sizes as each block finds
    them, each block's units from ``dx_units``, every unit's f32 product over
    its k-steps; a part's sums go to its block's slot, a head adds the slots
    of the blocks it lists, in order; rows at or past group_sizes[e] zero."""
    E, C, F = dy.shape
    D = w.shape[1]
    n_slabs, ktiles = -(-D // bn), -(-F // bk)
    mt = [-(-min(max(int(g), 0), C) // bm) for g in gs]
    first = np.concatenate([[0], np.cumsum(mt)])

    def tile_at(t):
        e = int(np.searchsorted(first * n_slabs, t, side="right")) - 1
        local = t - first[e] * n_slabs
        return e, (local % mt[e]) * bm, (local // mt[e]) * bn

    def product(u):
        e, m0, n0 = tile_at(u.tile)
        ks = slice(u.k0 * bk, min(u.k1 * bk, F))
        return e, m0, n0, dy[e, m0:m0 + bm, ks] @ w[e, n0:n0 + bn, ks].T

    units = k4b.dx_units(int(first[-1]) * n_slabs, ktiles, grid)
    slots = {b: product(u)[3] for b, us in enumerate(units) for u in us if u.kind == "part"}
    out = torch.zeros(E, C, D)
    for us in units:
        for u in us:
            if u.kind == "part":
                continue
            e, m0, n0, acc = product(u)
            for b in u.parts:
                acc = acc + slots[b]
            rows = torch.arange(m0, m0 + acc.shape[0])[:, None]
            out[e, m0:m0 + bm, n0:n0 + bn] = torch.where(rows < int(gs[e]), acc, 0.0)
    return out


@pytest.mark.parametrize("sizes,grid", [
    ([33, 30, 31, 31, 36, 33, 30, 32], 32),   # mixtral's uniform sizes at C 40: 2 rounds,
                                              # then 12 tiles in 2 pieces
    ([0, 40, 17, 1, 40, 0, 25, 39], 13),      # empty experts, one row, a full one: 4
                                              # rounds, then 4 tiles in 3 pieces
    ([0] * 8, 13),                            # every expert dead: zeros
    ([0, 0, 1, 0, 0, 0, 0, 0], 13),           # one live row: 4 tiles in 3 pieces
    ([0, 40, 17, 1, 40, 0, 25, 39], 132),     # 56 tiles, fewer than blocks: 2 pieces
])
def test_moe_gmm_bwd_dx_stream_k_model(sizes, grid):
    """dx's partition and fixed-order fixup, at tiles of 16 x 16 and k-steps
    of 4 (56 a tile), against jax.vjp of the expert einsum: every live
    (tile, k-step) once, the pieces of a tile cut across blocks summed in
    block order."""
    tiles = sum(-(-n // 16) for n in sizes) * 4
    units = k4b.dx_units(tiles, 56, grid)
    assert any(u.kind == "head" for us in units for u in us) == any(sizes)
    x, w, gs, dy = _moe_inputs(8, 40, 64, 224, sizes, seed=sum(sizes) + grid)
    got = _dx_stream_k(torch.from_numpy(dy), torch.from_numpy(w), gs, grid, 16, 16, 4)
    _close(got, _moe_vjp(x, w, gs, dy)[0])
    for e, n in enumerate(sizes):
        assert not got[e, n:].abs().sum()


def test_moe_gmm_bwd_dx_stream_k_model_at_the_kernels_tile():
    """The same at the kernel's 128 x 256 tiles and 64-deep k-steps: 3 x 3
    live tiles of 32 k-steps on 4 blocks (two full rounds of 4, then the
    last tile in two pieces of 16), rows past C and a ragged last k-step."""
    x, w, gs, dy = _moe_inputs(2, 130, 640, 2040, [130, 100], seed=11)
    assert k4b.dx_schedule(9, 32, 4) == k4b.Schedule(2, 1, 2)
    got = _dx_stream_k(torch.from_numpy(dy), torch.from_numpy(w), gs, 4)
    _close(got, _moe_vjp(x, w, gs, dy)[0])


def _wkv_inputs(B, H, T, dh, seed):
    """The sweep's inputs (tests/test_torch_kernels.py), nonzero s0, and a
    seeded dout and ds_final."""
    rng = np.random.default_rng(seed)
    r, k, v = (rng.standard_normal((B, H, T, dh)).astype(np.float32) * 0.5 for _ in range(3))
    w = 1.0 / (1.0 + np.exp(-rng.standard_normal((B, H, T, dh)).astype(np.float32)))
    u = rng.standard_normal((H, dh)).astype(np.float32) * 0.3
    s0 = rng.standard_normal((B, H, dh, dh)).astype(np.float32) * 0.1
    dout = rng.standard_normal((B, H, T, dh)).astype(np.float32)
    dsf = rng.standard_normal((B, H, dh, dh)).astype(np.float32) * 0.5
    return [r, k, v, w, u, s0], dout, dsf


def _wkv_vjp(ins, dout, dsf):
    _, vjp = jax.vjp(jref.rwkv6_scan_ref, *map(jnp.asarray, ins))
    return vjp((jnp.asarray(dout), jnp.asarray(dsf)))


WKV_SHAPES = [(1, 2, 1, 16), (2, 3, 21, 16), (1, 2, 32, 32), (2, 2, 37, 64)]


@pytest.mark.parametrize("B,H,T,dh", WKV_SHAPES, ids=["T1", "T21", "T32", "T37_dh64"])
@pytest.mark.parametrize("ds_final", [True, False], ids=["ds_final", "no_ds_final"])
def test_rwkv6_scan_bwd_ref_matches_jax_vjp(B, H, T, dh, ds_final):
    """dr, dk, dv, dw, du and ds0 at T = 1, at T a multiple of the checkpoint
    interval and not, from a nonzero s0, with and without a final-state
    gradient."""
    ins, dout, dsf = _wkv_inputs(B, H, T, dh, seed=T * 10 + dh)
    if not ds_final:
        dsf = np.zeros_like(dsf)
    want = _wkv_vjp(ins, dout, dsf)
    got = ops.rwkv6_scan_bwd(*(torch.from_numpy(a) for a in ins), torch.from_numpy(dout),
                             torch.from_numpy(dsf) if ds_final else None)
    assert [tuple(g.shape) for g in got] == [a.shape for a in ins]
    for g, jw in zip(got, want):
        _close(g, jw)


def test_rwkv6_scan_checkpoints_are_the_states_entering_each_chunk():
    """The forward's checkpoints (CPU: the plain version) are the reference's
    state after 0, 16, 32 ... steps; the output is unchanged by asking."""
    ins, _, _ = _wkv_inputs(1, 2, 37, 16, seed=3)
    t = [torch.from_numpy(a) for a in ins]
    ck = torch.full(k5.checkpoint_shape(1, 2, 37, 16), float("nan"))
    out, sf = ops.rwkv6_scan(*t, checkpoints=ck)
    out0, sf0 = ops.rwkv6_scan(*t)
    assert torch.equal(out, out0) and torch.equal(sf, sf0)
    assert ck.shape[2] == 3
    for c in range(3):
        pre = [jnp.asarray(a[:, :, :16 * c]) for a in ins[:4]] + [jnp.asarray(a) for a in ins[4:]]
        want = jnp.asarray(ins[5]) if c == 0 else jref.rwkv6_scan_ref(*pre)[1]
        _close(ck[:, :, c], want)
    with pytest.raises(ValueError, match="checkpoints"):
        ops.rwkv6_scan(*t, checkpoints=torch.zeros((1, 2, 2, 16, 16)))


def _quarters(a):
    """The sums over the last axis (a slice's columns) of each of a row's four
    threads, over its 4 columns in order."""
    return [a[..., 4 * j] + a[..., 4 * j + 1] + a[..., 4 * j + 2] + a[..., 4 * j + 3]
            for j in range(a.shape[-1] // 4)]


def _lanes_sum(q):
    """Four lanes' values summed as the kernel does: (0 + 1) + (2 + 3)."""
    return (q[0] + q[1]) + (q[2] + q[3])


def _wkv_bwd_sliced(r, k, v, w, u, dout, dsf, ckpt, p):
    """csrc/rwkv6_scan_bwd.cu in plain PyTorch: one block per (value-column
    slice of p.jb, head, batch), four threads a row, 4 columns each; chunks
    of CHECKPOINT_EVERY steps last first, each walked in two halves (steps
    8.. then 0..7), each half's states recomputed from the chunk's
    checkpoint; per step this slice's partial dr, dk, dw and its share of du,
    each thread's 4 columns combined first, then the row's four lanes; dv
    after each half from the rows' contributions, even rows and odd rows
    each in order, then added; dr, dk, dw from the cluster's partials summed
    in slice order, du in (b, slice) order."""
    B, H, T, dh = r.shape
    CK, HALF = k5.CHECKPOINT_EVERY, k5b.HALF_CHUNK
    parts = torch.zeros((3, p.slices, B, H, T, dh))
    du_part = torch.zeros((p.slices, B, H, dh))
    dv = torch.zeros((B, H, T, dh))
    ds0 = torch.zeros((B, H, dh, dh))
    for s in range(p.slices):
        cols = slice(s * p.jb, (s + 1) * p.jb)
        dS = dsf[:, :, :, cols].clone()
        for ch in reversed(range(p.chunks)):
            t0, n = ch * CK, min(CK, T - ch * CK)
            for base in ([HALF, 0] if n > HALF else [0]):
                cnt = n - HALF if base else min(n, HALF)
                S = ckpt[:, :, ch, :, cols].clone()
                states = []
                for tt in range(base + cnt):          # recompute; keep the half's states
                    if tt >= base:
                        states.append(S)
                    t = t0 + tt
                    S = w[:, :, t, :, None] * S + k[:, :, t, :, None] * v[:, :, t, None, cols]
                contribs = []
                for tt in reversed(range(cnt)):       # and step back through them
                    t = t0 + base + tt
                    rt, kt, wt = r[:, :, t], k[:, :, t], w[:, :, t]
                    vj, dj = v[:, :, t, cols], dout[:, :, t, cols]
                    st = states[tt]
                    # each thread's 4 columns of the partials, then the row's lanes
                    vdo = [c[..., None] for c in _quarters(vj * dj)]
                    sdo = _quarters(dj[:, :, None, :] * st)
                    dsv = _quarters(dS * vj[:, :, None, :])
                    parts[0, s, :, :, t] = _lanes_sum([u * kt * a + b for a, b in zip(vdo, sdo)])
                    parts[1, s, :, :, t] = _lanes_sum([rt * u * a + b for a, b in zip(vdo, dsv)])
                    parts[2, s, :, :, t] = _lanes_sum(_quarters(dS * st))
                    du_part[s] += _lanes_sum([rt * kt * a for a in vdo])
                    contribs.append((t, kt[..., None] * dS
                                     + (rt * u * kt)[..., None] * dj[:, :, None, :]))
                    dS = wt[..., None] * dS + rt[..., None] * dj[:, :, None, :]
                for t, contrib in contribs:           # dv of the half
                    even = torch.zeros_like(contrib[:, :, 0])
                    odd = torch.zeros_like(even)
                    for i in range(0, dh, 2):
                        even = even + contrib[:, :, i]
                        odd = odd + contrib[:, :, i + 1]
                    dv[:, :, t, cols] = even + odd
        ds0[:, :, :, cols] = dS
    reduced = []
    for q in range(3):
        acc = torch.zeros((B, H, T, dh))
        for s in range(p.slices):
            acc = acc + parts[q, s]
        reduced.append(acc)
    du = torch.zeros((H, dh))
    for b in range(B):
        for s in range(p.slices):
            du = du + du_part[s, b]
    return reduced[0], reduced[1], dv, reduced[2], du, ds0


@pytest.mark.parametrize("B,H,T,dh", [(1, 2, 37, 32), (2, 1, 16, 64), (1, 2, 1, 16)])
def test_rwkv6_scan_bwd_chunked_slice_model(B, H, T, dh):
    """Chunk checkpoints, the recompute per half-chunk, four threads a row,
    per-slice partials summed in order compute what jax.vjp of the reference
    scan does: T ragged against the chunks (37: a last chunk of 5, within
    one half), whole chunks (16: both halves), one step (1), 1 to 4 slices."""
    p = k5b.plan(B, H, T, dh)
    assert p.slices == dh // 16 and p.chunks == -(-T // 16)
    ins, dout, dsf = _wkv_inputs(B, H, T, dh, seed=B + T + dh)
    t = [torch.from_numpy(a) for a in ins]
    ck = torch.empty(k5.checkpoint_shape(B, H, T, dh))
    ops.rwkv6_scan(*t, checkpoints=ck)
    got = _wkv_bwd_sliced(*t[:5], torch.from_numpy(dout), torch.from_numpy(dsf), ck, p)
    for g, jw in zip(got, _wkv_vjp(ins, dout, dsf)):
        _close(g, jw)


def test_rwkv6_scan_autograd_function():
    """Rwkv6Scan under autograd gives jax.vjp's gradients, also with the
    final state written into a caller's tensor (state_out), and refuses bf16."""
    ins, dout, dsf = _wkv_inputs(1, 2, 19, 16, seed=11)
    want = _wkv_vjp(ins, dout, dsf)
    for state_out in (None, torch.zeros((1, 2, 16, 16))):
        t = [torch.from_numpy(a).requires_grad_() for a in ins]
        out, sf = ssm.Rwkv6Scan.apply(*t)
        if state_out is not None:
            sf = state_out.copy_(sf)
        ((out * torch.from_numpy(dout)).sum() + (sf * torch.from_numpy(dsf)).sum()).backward()
        for a, jw in zip(t, want):
            _close(a.grad, jw)
    bf = [torch.from_numpy(a).to(torch.bfloat16).requires_grad_() for a in ins[:4]]
    with pytest.raises(ValueError, match="float32"):
        ssm.Rwkv6Scan.apply(*bf, *(torch.from_numpy(a) for a in ins[4:]))


def test_rwkv6_time_mix_state_out_keeps_the_gradient():
    """The model's time mix under autograd with and without ``state_out``:
    the same gradients of the output and the final state."""
    torch.manual_seed(0)
    D, hd = 32, 16
    specs = ssm.rwkv6_layer_specs(D, 64, hd)["tm"]
    tm = {n: (torch.randn(shape) * 0.2).requires_grad_() for n, (shape, *_rest) in specs.items()}
    x = torch.randn(1, 5, D)
    grads = []
    for state_out in (None, torch.zeros((1, D // hd, hd, hd))):
        y, (s, _) = ssm.rwkv6_time_mix(tm, x, hd, state_out=state_out)
        if state_out is not None:
            assert s is state_out
        g = torch.autograd.grad(y.sum() + (s * s).sum(), list(tm.values()))
        grads.append(g)
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b)
