"""The port's dry-run (launch/dryrun.py, distributed/stats.py, the kernels'
fake branches) against the JAX package's, on the CPU.

The port traces a step on fake tensors, sharded as DTensors over a mesh of
fake ranks; the JAX package compiles its step for 256 or 512 host devices.
Held to the reference:
  * the arguments a device holds (``argument_size_in_bytes``), equal, for
    minitron-4b decode_32k single, mixtral-8x7b prefill_32k multi and
    rwkv6-3b long_500k single (the reference's records come from one
    subprocess with 512 host devices); the peaks, flops and collectives of
    both are printed side by side with no tolerance set;
  * at smoke width on a 1x1 mesh, the port's prefill and decode flops equal
    two per multiply-add of the dot_generals in the reference step's jaxpr,
    within 1 %.  Two pairs are left out, each for a difference in the code
    counted: whisper-small (the reference's decoder computes its cross
    attention's k and v projections of the decoder token and drops them,
    dead code a jaxpr keeps: 0.952 / 0.905) and zamba2-2.7b's prefill (the
    port's Mamba2 is the chunked SSD form, whose products do 5.6 % more
    work than the reference's step-by-step scan).
"""

import json
import math
import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import pytest
import torch
from jax.extend import core as jcore
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.distributed.tensor import DTensor, Replicate, Shard

from repro.configs import get_arch as j_get_arch
from repro.configs import smoke_variant as j_smoke_variant
from repro.models import transformer as JT
from repro_torch.configs import ShapeConfig, get_arch
from repro_torch.distributed import ctx, rules, stats
from repro_torch.kernels import ops, ref
from repro_torch.launch import dryrun
from repro_torch.launch import mesh as mesh_lib

REPO = pathlib.Path(__file__).resolve().parents[1]
REFERENCE_COMBOS = (("minitron-4b", "decode_32k", False),
                    ("mixtral-8x7b", "prefill_32k", True),
                    ("rwkv6-3b", "long_500k", False))


@pytest.fixture(autouse=True, scope="module")
def _release_process_group():
    yield
    mesh_lib.release()


def test_meshes_of_each_world_size():
    single = mesh_lib.make_production_mesh(multi_pod=False)
    assert single.shape == (16, 16) and single.mesh_dim_names == ("data", "model")
    multi = mesh_lib.make_production_mesh(multi_pod=True)
    assert multi.shape == (2, 16, 16) and multi.mesh_dim_names == ("pod", "data", "model")
    assert torch.distributed.get_world_size() == 512
    host = mesh_lib.make_host_mesh()
    assert host.shape == (1, 1) and torch.distributed.get_world_size() == 1


def test_stats_of_a_sharded_matmul():
    """x (64, 4096) over data times w (4096, 14336) over data and model, on
    256 fake ranks: one all-gather of x's rows (the reference's convention:
    the operand, result / g = 64 x 4096 x 2 / 16 bytes), and a device's
    flops are the global 7.516e9 / 256."""
    mesh = mesh_lib.make_production_mesh()
    mode = FakeTensorMode()
    with mode:
        w = DTensor.from_local(torch.empty(256, 896, dtype=torch.bfloat16), mesh,
                               [Shard(0), Shard(1)], run_check=False)
        x = DTensor.from_local(torch.empty(4, 4096, dtype=torch.bfloat16), mesh,
                               [Shard(0), Replicate()], run_check=False)
    trace = stats.StepTrace()
    trace.hold_arguments((w, x))
    with mode, rules.unseen_meta(trace), trace:
        y = x @ w
        trace.hold_outputs(y)
    coll = stats.collective_stats(trace)
    assert coll["count"] == 1 and coll["all-gather"] == 64 * 4096 * 2 / 16
    assert coll["total_bytes"] == coll["all-gather"]
    assert stats.cost_stats(trace)["flops"] == 2 * 64 * 4096 * 14336 / 256 == 7.516192768e9 / 256
    mem = stats.memory_stats(trace)
    assert mem["argument_size_in_bytes"] == (256 * 896 + 4 * 4096) * 2
    assert mem["output_size_in_bytes"] == y.to_local().numel() * 2
    assert mem["peak_bytes_per_device"] == (mem["argument_size_in_bytes"]
                                            + mem["output_size_in_bytes"]
                                            + mem["temp_size_in_bytes"])


def test_constrain_redistributes_under_a_mesh():
    mesh = mesh_lib.make_production_mesh()
    with FakeTensorMode():
        x = DTensor.from_local(torch.empty(256, 8, 64), mesh, [Replicate(), Replicate()],
                               run_check=False)
        with ctx.sharding_hints(mesh, roles=("residual",)):
            y = ctx.constrain(x, ("dp", None, None))
            assert tuple(y.placements) == (Shard(0), Replicate())
            assert y.to_local().shape == (16, 8, 64)
            assert ctx.constrain(y, ("dp", None, None)) is y
            assert ctx.constrain(x, (None, "dp", None), role="moe") is x
        assert ctx.constrain(x, ("dp", None, None)) is x


def _reference_records(tmp):
    code = (
        "import json, os, sys\n"
        "os.environ['XLA_FLAGS'] = '--xla_force_host_platform_device_count=512'\n"
        "from repro.launch import dryrun\n"
        f"combos = {REFERENCE_COMBOS!r}\n"
        f"print(json.dumps([dryrun.run_one(a, s, m, {str(tmp)!r}) for a, s, m in combos]))\n")
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"), JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=env, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_records_beside_the_reference(tmp_path, monkeypatch, capsys):
    refs = _reference_records(tmp_path / "ref")
    seen = []
    track = stats.StepTrace._track

    def watching(self, t):
        seen.append(tuple(t.shape))
        return track(self, t)

    monkeypatch.setattr(stats.StepTrace, "_track", watching)
    # no kernel's plain version may run on a fake tensor
    for name in ("flash_attention_ref", "decode_attention_ref", "moe_gmm_ref",
                 "rwkv6_scan_ref"):
        monkeypatch.setattr(ref, name, lambda *a, **k: pytest.fail("plain version ran"))
    for (arch, shape, multi), want in zip(REFERENCE_COMBOS, refs):
        seen.clear()
        before = ops.launch_counts()
        got = dryrun.run_one(arch, shape, multi, str(tmp_path / "port"))
        assert ops.launch_counts() == before
        assert got["status"] == want["status"] == "ok"
        assert got["kind"] == want["kind"] and got["chips"] == want["chips"]
        assert got["memory"]["argument_size_in_bytes"] == \
            want["memory"]["argument_size_in_bytes"], (arch, shape)
        kinds = {k for k in ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                             "collective-permute") if got["collectives"][k]}
        want_kinds = {k for k in kinds | {"all-to-all", "collective-permute"}
                      if want["collectives"][k]}
        # both gather weights and sum partial products; GSPMD's collective
        # permutes and the moe all-to-all have no DTensor counterpart here
        assert {"all-gather", "all-reduce"} <= kinds & want_kinds
        assert got["fits_80gb"] == (got["memory"]["peak_bytes_per_device"] < 80e9)
        with capsys.disabled():
            print(f"\n{arch} {shape} {'multi' if multi else 'single'}: peak/device "
                  f"port {got['memory']['peak_bytes_per_device']:.4e} reference "
                  f"{want['memory']['peak_bytes_per_device']:.4e}; flops port "
                  f"{got['cost']['flops']:.4e} reference {want['cost']['flops']:.4e}; "
                  f"collectives port {sorted(kinds)} reference {sorted(want_kinds)}")
        if shape == "prefill_32k":
            # no (S, S) score tensor of the 32768-token prompt anywhere
            assert not any(s[-2:] == (32768, 32768) for s in seen)
            assert got["kernels"]["flash_attention"]["calls"] == 32


def _dot_flops(jaxpr, mult=1.0) -> float:
    """Two per multiply-add of every dot_general, scans counted per trip."""
    total = 0.0
    for eqn in jaxpr.eqns:
        if eqn.primitive.name == "dot_general":
            (lc, _), _ = eqn.params["dimension_numbers"]
            lhs = eqn.invars[0].aval.shape
            total += 2.0 * mult * math.prod(eqn.outvars[0].aval.shape) * math.prod(
                lhs[d] for d in lc)
        m = mult * (eqn.params.get("length", 1) if eqn.primitive.name == "scan" else 1)
        for v in eqn.params.values():
            for sub in (v if isinstance(v, (tuple, list)) else (v,)):
                if isinstance(sub, jcore.ClosedJaxpr):
                    total += _dot_flops(sub.jaxpr, m)
                elif isinstance(sub, jcore.Jaxpr):
                    total += _dot_flops(sub, m)
    return total


FLOP_CASES = [(a, k) for a in ("minitron-4b", "mixtral-8x7b", "qwen3-8b", "qwen2-vl-2b",
                               "yi-9b", "qwen1.5-110b", "arctic-480b", "rwkv6-3b")
              for k in ("prefill", "decode")] + [("zamba2-2.7b", "decode")]


@pytest.mark.parametrize("arch,kind", FLOP_CASES)
def test_smoke_flops_equal_the_reference_dot_generals(arch, kind):
    B, S = 2, 64
    jcfg = j_smoke_variant(j_get_arch(arch))
    p = jax.eval_shape(lambda k: JT.init_params(jcfg, k), jax.random.PRNGKey(0))
    sds = jax.ShapeDtypeStruct
    if kind == "prefill":
        batch = {"tokens": sds((B, S), jnp.int32)}
        if jcfg.family == "vlm":
            batch = {"embeds": sds((B, S, jcfg.d_model), jnp.float32),
                     "positions": sds((3, B, S), jnp.int32)}
        jaxpr = jax.make_jaxpr(lambda p, b: JT.prefill(p, jcfg, b, max_seq=S))(p, batch)
    else:
        cache = jax.eval_shape(lambda: JT.init_cache(jcfg, B, S))
        jaxpr = jax.make_jaxpr(lambda p, c, t: JT.decode_step(p, jcfg, c, t))(
            p, cache, sds((B,), jnp.int32))
    want = _dot_flops(jaxpr.jaxpr)
    mesh = mesh_lib.make_host_mesh()
    trace, traced, _ = dryrun.trace_step(get_arch(jcfg.name), ShapeConfig(kind, S, B, kind),
                                         mesh)
    assert traced == kind
    got = stats.cost_stats(trace)["flops"]
    assert got == pytest.approx(want, rel=0.01), (got, want)


def test_cli_writes_records_and_fails_loudly(tmp_path, monkeypatch, capsys):
    with pytest.raises(SystemExit) as done:
        dryrun.main(["--arch", "qwen2-vl-2b", "--shape", "decode_32k", "--mesh", "single",
                     "--out", str(tmp_path)])
    assert done.value.code == 0
    rec = json.loads((tmp_path / "qwen2-vl-2b_decode_32k_single.json").read_text())
    assert rec["status"] == "ok" and rec["chips"] == 256 and "fits_80gb" in rec
    assert rec["kernels"]["decode_attention"]["calls"] == 28
    assert "OK   qwen2-vl-2b x decode_32k x single" in capsys.readouterr().out
    # an inapplicable pair is skipped; a combo that raises prints FAIL, exit 1
    with pytest.raises(SystemExit) as done:
        dryrun.main(["--arch", "whisper-small", "--shape", "long_500k", "--mesh", "single",
                     "--out", str(tmp_path)])
    assert done.value.code == 0 and "SKIP whisper-small" in capsys.readouterr().out
    monkeypatch.setattr(dryrun, "trace_step", lambda *a, **k: 1 / 0)
    with pytest.raises(SystemExit) as done:
        dryrun.main(["--arch", "yi-9b", "--shape", "decode_32k", "--mesh", "single",
                     "--out", str(tmp_path)])
    assert done.value.code == 1 and "FAIL yi-9b x decode_32k x single" in \
        capsys.readouterr().out
