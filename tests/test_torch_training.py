"""The port's training path against the JAX package's, on the CPU in float32.

The same numpy parameters (the JAX package's ``init_params`` tree, converted
with ``params_from_numpy``), batches and gradients go through both packages.
Tolerances: the loss and gradients of every smoke arch at 2e-4 (the models'
forward tolerance); AdamW's params, m and v at 1e-6 on the same gradients;
data batches bit-equal; checkpoints cross both ways with equal arrays.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS
from repro.configs import get_arch as j_get_arch
from repro.configs import smoke_variant as j_smoke_variant
from repro.models import init_params as j_init_params
from repro.training import checkpoint as jckpt
from repro.training import data as jdata
from repro.training import optim as joptim
from repro.training import trainer as jtrainer
from repro_torch.configs import get_arch
from repro_torch.kernels import ops
from repro_torch.launch import train as launch_train
from repro_torch.models import transformer as T
from repro_torch.serving.formats import quantize_params
from repro_torch.training import checkpoint as tckpt
from repro_torch.training import data as tdata
from repro_torch.training import optim as toptim
from repro_torch.training import trainer as ttrainer

ARCH_NAMES = sorted(ARCHS)


def _np_tree(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float32), tree)


def _batch(cfg, seed, B=2, S=16):
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (B, S), dtype=np.int32),
             "labels": rng.integers(0, cfg.vocab_size, (B, S), dtype=np.int32)}
    if cfg.family == "audio":
        batch["frames"] = rng.standard_normal((B, cfg.encoder_seq, cfg.d_model)).astype(
            np.float32)
    return batch


def _pair(name):
    """(JAX cfg, JAX params, port cfg, port params from the same numbers)."""
    jcfg = j_smoke_variant(j_get_arch(name))
    jp = j_init_params(jcfg, jax.random.PRNGKey(0))
    cfg = get_arch(jcfg.name)
    return jcfg, jp, cfg, T.params_from_numpy(_np_tree(jp), cfg, device="cpu")


def _close_tree(got, want, atol, rtol=0.0):
    got_leaves = toptim.tree_leaves(got)
    want_leaves = jax.tree.leaves(want)
    assert len(got_leaves) == len(want_leaves)
    for g, w in zip(got_leaves, want_leaves):
        np.testing.assert_allclose(g.detach().float().numpy(), np.asarray(w, np.float32),
                                   atol=atol, rtol=rtol)


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_loss_and_grads_match_the_reference(arch):
    """lm_loss and its gradient for every smoke arch: the attention backward
    (FlashAttention), rwkv6's plain scan, the moe dispatch's scatter, Mamba2's
    chunked form and whisper's encoder all differentiate on the CPU."""
    jcfg, jp, cfg, p = _pair(arch)
    batch = _batch(cfg, 1)
    (jl, jaux), jg = jax.jit(jax.value_and_grad(
        lambda q, b: jtrainer.lm_loss(q, jcfg, b), has_aux=True))(
            jp, jax.tree.map(jnp.asarray, batch))
    loss, aux, grads = ttrainer.loss_and_grads(p, cfg, ttrainer.batch_to(batch, "cpu"))
    assert abs(float(loss) - float(jl)) < 2e-4
    assert abs(float(aux["aux_loss"]) - float(jaux["aux_loss"])) < 2e-4
    _close_tree(grads, jg, atol=2e-4)
    assert not any(t.requires_grad for t in toptim.tree_leaves(p))


def test_adamw_matches_the_reference_on_the_same_grads():
    """schedule_lr, global_norm and three adamw_update steps, fed the same numpy
    gradients: params, m and v within 1e-6 (the update alone, so no gradient
    rounding can flip an early Adam step)."""
    rng = np.random.default_rng(2)
    shapes = {"w": (16, 8), "b": (8,), "layers": {"wi": (2, 8, 4), "ln": (2, 8)}}
    mk = lambda s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    params = jax.tree.map(mk, shapes, is_leaf=lambda x: isinstance(x, tuple))
    cfg = toptim.AdamWConfig(lr=1e-2, warmup_steps=2, total_steps=5, grad_clip=0.5)
    jcfg = joptim.AdamWConfig(**dataclasses.asdict(cfg))
    jp, jopt = jax.tree.map(jnp.asarray, params), joptim.init_opt_state(params)
    tp = jax.tree.map(torch.from_numpy, params)
    topt = toptim.init_opt_state(tp)
    for step in range(3):
        grads = jax.tree.map(lambda a: mk(a.shape) * (step + 1), params)
        np.testing.assert_allclose(float(toptim.global_norm(jax.tree.map(torch.from_numpy,
                                                                         grads))),
                                   float(joptim.global_norm(grads)), rtol=1e-6)
        jp, jopt, jstats = joptim.adamw_update(jcfg, jp, grads, jopt)
        tp, topt, tstats = toptim.adamw_update(cfg, tp, jax.tree.map(torch.from_numpy, grads),
                                               topt)
        assert topt["step"] == int(jopt["step"]) == step + 1
        np.testing.assert_allclose(float(tstats["lr"]), float(jstats["lr"]), rtol=1e-6)
        _close_tree(tp, jp, atol=1e-6)
        _close_tree(topt["m"], jopt["m"], atol=1e-6)
        _close_tree(topt["v"], jopt["v"], atol=1e-6)
    for s in (0, 1, 2, 3, 4, 5, 9):
        np.testing.assert_allclose(float(toptim.schedule_lr(cfg, s)),
                                   float(joptim.schedule_lr(jcfg, jnp.int32(s))), rtol=1e-6)


@pytest.mark.parametrize("arch,kwargs", [
    ("minitron-4b", dict(microbatches=2)),
    ("minitron-4b", dict(remat=True)),
    ("qwen2-vl-2b", dict(microbatches=2, remat=True)),   # M-RoPE positions (3, B, S)
    ("zamba2-2.7b", dict(remat=True)),                   # the shared block checkpointed
], ids=["minitron_mb2", "minitron_remat", "qwen2vl_mb2_remat", "zamba2_remat"])
def test_train_step_accumulation_and_remat(arch, kwargs):
    """One train_step with microbatches / remat gives the plain step's and the
    reference's loss and gradients (read as m = (1 - b1) g scale after the
    first update)."""
    jcfg, jp, cfg, p = _pair(arch)
    batch = _batch(cfg, 3, B=4, S=12)
    if cfg.mrope:
        pos = np.stack([np.broadcast_to(np.arange(12, dtype=np.int32), (4, 12))] * 3)
        batch["positions"] = pos + np.arange(3, dtype=np.int32)[:, None, None]
    opt = toptim.AdamWConfig(warmup_steps=1, total_steps=10)
    jstep = jtrainer.make_train_step(jcfg, joptim.AdamWConfig(warmup_steps=1, total_steps=10),
                                     **kwargs)
    _, jopt, jstats = jax.jit(jstep)(jp, joptim.init_opt_state(jp),
                                     jax.tree.map(jnp.asarray, batch))
    runs = {}
    for name, kw in (("plain", {}), ("changed", kwargs)):
        tp = T.params_from_numpy(_np_tree(jp), cfg, device="cpu")
        step = ttrainer.make_train_step(cfg, opt, device="cpu", **kw)
        runs[name] = step(tp, toptim.init_opt_state(tp), batch)
    _, topt, stats = runs["changed"]
    assert abs(float(stats["loss"]) - float(jstats["loss"])) < 2e-4
    assert abs(float(stats["grad_norm"]) - float(jstats["grad_norm"])) < 2e-4
    _close_tree(topt["m"], jopt["m"], atol=2e-5)
    assert abs(float(stats["loss"]) - float(runs["plain"][2]["loss"])) < 1e-5
    _close_tree(topt["m"], jax.tree.map(lambda t: t.numpy(), runs["plain"][1]["m"]),
                atol=1e-6)


def test_train_loss_decreases():
    """30 steps on minitron-4b-smoke lower the loss by 0.2 (the reference's
    test_arch_smoke margin), through train_loop."""
    cfg = get_arch("minitron-4b-smoke")
    dcfg = tdata.DataConfig(vocab_size=cfg.vocab_size, seq_len=32, batch_size=4)
    res = ttrainer.train_loop(cfg, toptim.AdamWConfig(lr=1e-3, warmup_steps=5,
                                                      total_steps=50),
                              tdata.SyntheticLM(dcfg).batches(), 30, log_every=1,
                              device="cpu")
    losses = [h["loss"] for h in res["history"]]
    assert len(losses) == 30 and all(np.isfinite(losses))
    assert losses[-1] < losses[0] - 0.2, (losses[0], losses[-1])
    assert res["opt_state"]["step"] == 30


def test_data_is_bit_equal_to_the_reference():
    cfg = tdata.DataConfig(vocab_size=1000, seq_len=24, batch_size=3, seed=7)
    jcfg = jdata.DataConfig(**dataclasses.asdict(cfg))
    mine, theirs = tdata.SyntheticLM(cfg).batches(), jdata.SyntheticLM(jcfg).batches()
    for _ in range(5):
        a, b = next(mine), next(theirs)
        for k in ("tokens", "labels"):
            assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k])
    for a, b in zip(tdata.eval_batches(cfg, 3), jdata.eval_batches(jcfg, 3)):
        assert all(np.array_equal(a[k], b[k]) for k in ("tokens", "labels"))


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_checkpoint_crosses_packages(writer, tmp_path):
    """A checkpoint written by either package loads in the other: params, m, v
    and step equal."""
    jcfg, jp, cfg, p = _pair("qwen3-8b")
    rng = np.random.default_rng(4)
    m = jax.tree.map(lambda a: rng.standard_normal(a.shape).astype(np.float32), _np_tree(jp))
    v = jax.tree.map(lambda a: np.abs(a), m)
    jopt = {"m": m, "v": v, "step": jnp.int32(7)}
    topt = toptim.opt_state_from_numpy(jopt, device="cpu")
    path = str(tmp_path / "step_7")
    if writer == "jax":
        jckpt.save_checkpoint(path, jp, jopt, 7, {"arch": jcfg.name})
        lp, lopt, meta = tckpt.load_checkpoint(path, p, topt, device="cpu")
        got_p, got_opt, want_p, want_opt = lp, lopt, jp, jopt
    else:
        tckpt.save_checkpoint(path, p, topt, 7, {"arch": cfg.name})
        lp, lopt, meta = jckpt.load_checkpoint(path, jp, jopt)
        got_p, got_opt = p, topt
        want_p, want_opt = lp, lopt
    assert meta == {"step": 7, "arch": cfg.name}
    assert int(got_opt["step"]) == int(want_opt["step"]) == 7
    _close_tree(got_p, want_p, atol=0)
    _close_tree(got_opt["m"], want_opt["m"], atol=0)
    _close_tree(got_opt["v"], want_opt["v"], atol=0)
    assert tckpt.latest_checkpoint(str(tmp_path)) == path
    assert toptim.opt_state_to_numpy(topt)["step"] == np.int32(7)


def test_rwkv6_scan_state_write_differentiates():
    """The plain scan's in-place state write (s_out) keeps the gradient."""
    rng = np.random.default_rng(5)
    r, k, v = (torch.from_numpy(rng.standard_normal((1, 2, 5, 16)).astype(np.float32))
               for _ in range(3))
    w = torch.from_numpy(rng.uniform(0.5, 0.99, (1, 2, 5, 16)).astype(np.float32))
    u = torch.from_numpy(rng.standard_normal((2, 16)).astype(np.float32))
    s0 = torch.from_numpy(rng.standard_normal((1, 2, 16, 16)).astype(np.float32))
    grads = []
    for s_out in (None, torch.zeros((1, 2, 16, 16))):
        ins = [t.clone().requires_grad_() for t in (r, k, v, w, u, s0)]
        out, s = ops.rwkv6_scan(*ins, s_out=s_out)
        if s_out is not None:
            assert s is s_out
        (out.sum() + (s * s).sum()).backward()
        grads.append([t.grad for t in ins])
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b)


def test_training_refuses_what_it_cannot_differentiate():
    """An rsm_int8 tree raises on every device."""
    opt = toptim.AdamWConfig()
    cfg = get_arch("minitron-4b-smoke")
    q = quantize_params(T.init_params(cfg, 0, device="cpu"))
    with pytest.raises(ValueError, match="not trainable"):
        ttrainer.make_train_step(cfg, opt, device="cpu")(q, {"m": {}, "v": {}, "step": 0},
                                                         _batch(cfg, 6))
    with pytest.raises(ValueError, match="not trainable"):
        toptim.init_opt_state(q)


def test_launch_train_on_the_cpu(tmp_path, capsys):
    launch_train.main(["--arch", "minitron-4b", "--smoke", "--device", "cpu", "--steps",
                       "3", "--log-every", "1", "--ckpt-dir", str(tmp_path)])
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("arch=minitron-4b-smoke") and out[0].endswith("device=cpu")
    assert [ln.split()[:2] for ln in out[1:4]] == [["step", "0"], ["step", "1"], ["step", "2"]]
    assert out[4].startswith("done: 1536 tokens")
    assert os.path.isfile(tmp_path / "step_3" / "meta.json")
