"""The port's twins of ``examples/*.py`` and ``scripts/dump_ops.py`` against
the originals, on the CPU, and the F8 repair (a DTensor over real shards).

  * twins that run a model (quickstart, serve_batched, green_comparison,
    train_small) get the original's weights (``params_from_numpy`` of the
    JAX package's ``init_params(cfg, PRNGKey(0))``, patched in at the twin's
    ``init_params``): their greedy tokens equal the original's in f32; for
    train_small the losses agree at 2e-4, fall, and the restored checkpoint
    serves the original's tokens;
  * session twins (the step times of every calibration replaced, in both
    packages, by one synthetic table, ``test_torch_spec_api._warm``'s): every
    ``ServingReport``'s JSON, the printed tables, the decision grid's rows,
    the dashboard HTML and the Perfetto JSON are ``==`` the original's;
  * ``torch_dump_ops``: flops a device equal to the dry-run's own trace of
    the same step;
  * F8: each of the eight kernel wrappers on real DTensors of the 1x1 host
    mesh equals the plain call.

The originals run at their smallest arguments; green_comparison has none
that shrink it, so both packages' workloads are cut alike to 2 requests a
cell there.
"""

import dataclasses
import importlib.util
import json
import pathlib
import re
import sys
import types

import jax
import numpy as np
import pytest
import torch
from torch.distributed.tensor import DTensor, Replicate

from test_torch_spec_api import _warm

import repro.configs as j_configs
import repro.serving.api as j_api
import repro.serving.server as j_server
import repro.serving.stepcache as j_step
from repro.models import init_params as j_init_params
import repro_torch.configs as t_configs
import repro_torch.serving.api as t_api
import repro_torch.serving.stepcache as t_step
from repro_torch.kernels import ops
from repro_torch.launch import dryrun
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models import transformer as T

REPO = pathlib.Path(__file__).resolve().parents[1]
EXAMPLES = REPO / "examples"
sys.path.insert(0, str(EXAMPLES))
sys.path.insert(0, str(REPO))


def _load(path: pathlib.Path):
    name = path.stem
    if name in sys.modules:
        return sys.modules[name]
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def original(name: str):
    return _load(EXAMPLES / f"{name}.py")


def twin(name: str):
    return _load(EXAMPLES / f"torch_{name}.py")


def _carry_weights(monkeypatch, tw, j_cfg=lambda cfg: j_configs.get_arch(cfg.name)):
    """The twin's ``init_params`` gives the JAX package's PRNGKey(0) weights
    of ``j_cfg(cfg)``, the JAX package's config of the twin's ``cfg``."""
    def init_params(cfg, seed=0, device=None):
        jp = j_init_params(j_cfg(cfg), jax.random.PRNGKey(0))
        return T.params_from_numpy(jax.tree.map(np.asarray, jp), cfg, device="cpu")
    monkeypatch.setattr(tw, "init_params", init_params)


def _argv(monkeypatch, name, args):
    monkeypatch.setattr(sys, "argv", [name, *args])


# -- twins that run a model ------------------------------------------------------------


def test_quickstart_tokens_equal_the_original(monkeypatch):
    args = ["--requests", "2"]
    got = []
    orig = original("quickstart")
    real = orig.build_green_report
    monkeypatch.setattr(orig, "build_green_report",
                        lambda dep, m: got.append(m) or real(dep, m))
    _argv(monkeypatch, "quickstart", args)
    orig.main()
    want = [{r.rid: np.asarray(r.tokens).tolist() for r in m.responses} for m in got]
    tw = twin("quickstart")
    _carry_weights(monkeypatch, tw)
    out = tw.main(args + ["--device", "cpu"])
    assert [out[si]["tokens"] for si in ("si1", "si2", "si3", "si4")] == want
    assert len(want[0]) == 2 and all(len(t) == 4 for t in want[0].values())
    assert out["si4"]["url"] == "https://cloud.local/endpoints/m"


def test_serve_batched_tokens_equal_the_original(monkeypatch):
    args = ["--requests", "4", "--max-new", "3"]
    got = []
    real = j_server.ServingServer.handle_wire
    monkeypatch.setattr(j_server.ServingServer, "handle_wire",
                        lambda self, *a: got.append(real(self, *a)) or got[-1])
    _argv(monkeypatch, "serve_batched", args)
    original("serve_batched").main()
    _, metrics, stats = got[0]
    tw = twin("serve_batched")
    _carry_weights(monkeypatch, tw)
    out = tw.main(args + ["--device", "cpu"])
    assert out["tokens"] == {r.rid: np.asarray(r.tokens).tolist() for r in metrics.responses}
    assert out["wire"]["request_bytes"] == stats.request_bytes
    assert out["wire"]["response_bytes"] == stats.response_bytes
    assert out["wire"]["codec"] == "grpc_binary" and len(out["tokens"]) == 4


def test_green_comparison_tokens_equal_the_original(monkeypatch):
    orig, tw = original("green_comparison"), twin("green_comparison")
    for mod in (orig, tw):
        wl = mod.synth_workload
        monkeypatch.setattr(mod, "synth_workload", lambda n, *a, wl=wl, **k: wl(2, *a, **k))
    got = {}
    real = orig.build_green_report
    monkeypatch.setattr(orig, "build_green_report", lambda dep, m: got.setdefault(
        dep.describe(), {r.rid: np.asarray(r.tokens).tolist() for r in m.responses})
        and real(dep, m))
    _argv(monkeypatch, "green_comparison", [])
    orig.main()
    _carry_weights(monkeypatch, tw)
    out = tw.main(["--device", "cpu"])
    assert out["tokens"] == got
    assert len(got) == len(out["rows"]) >= 12
    assert out["greenest"] in got


def test_train_small_losses_and_served_tokens_equal_the_original(monkeypatch, tmp_path, capsys):
    args = ["--steps", "40", "--d-model", "128", "--layers", "1", "--seq", "64", "--batch", "4"]
    orig = original("train_small")
    hist = []
    real = orig.train_loop
    monkeypatch.setattr(orig, "train_loop", lambda *a, **k: hist.append(real(*a, **k))
                        or hist[-1])
    _argv(monkeypatch, "train_small", args + ["--ckpt", str(tmp_path / "ref")])
    orig.main()
    text = capsys.readouterr().out
    want_tokens = json.loads(re.search(r"trained model: (\[.*\])", text).group(1))
    want_eval = float(re.search(r"eval loss ([0-9.]+)", text).group(1))
    tw = twin("train_small")
    # the original's ~100M variant, as train_small.py builds it
    _carry_weights(monkeypatch, tw, lambda cfg: dataclasses.replace(
        j_configs.smoke_variant(j_configs.get_arch("qwen3-8b")), name=cfg.name,
        num_layers=cfg.num_layers, d_model=cfg.d_model, num_heads=cfg.num_heads,
        num_kv_heads=cfg.num_kv_heads, head_dim=cfg.head_dim, d_ff=cfg.d_ff,
        vocab_size=cfg.vocab_size))
    out = tw.main(args + ["--ckpt", str(tmp_path / "port"), "--device", "cpu"])
    ref_loss = [h["loss"] for h in hist[0]["history"]]
    np.testing.assert_allclose([h["loss"] for h in out["history"]], ref_loss, rtol=2e-4)
    assert out["last_loss"] < out["first_loss"]
    assert abs(out["eval_loss"] - want_eval) < 2e-3
    assert out["tokens"] == want_tokens
    assert out["restored_step"] == 40


# -- session twins ----------------------------------------------------------------------


def _synthetic_calibration(monkeypatch, mod, step):
    pk = types.SimpleNamespace(step=step)

    def calibrate(self, name, *, batch_sizes, prompt_len, max_new, num_slots=None):
        self.warm(name, _warm(pk, max_new=max_new, prompt_len=prompt_len,
                              batches=batch_sizes))
        return self._warm_cache(name)

    monkeypatch.setattr(mod.ServingSession, "calibrate", calibrate)


def _recorded_reports(monkeypatch, mod) -> list:
    reports = []
    real = mod.ServingSession.run

    def run(self):
        reports.append(real(self))
        return reports[-1]

    monkeypatch.setattr(mod.ServingSession, "run", run)
    return reports


def _session_pair(monkeypatch, capsys, name, args=(), argv_main=False, out_args=None):
    """Run the original and the twin of ``name`` under the synthetic step
    times: (original's stdout, twin's stdout, their reports, the twin's
    result)."""
    _synthetic_calibration(monkeypatch, j_api, j_step)
    _synthetic_calibration(monkeypatch, t_api, t_step)
    want_reports = _recorded_reports(monkeypatch, j_api)
    got_reports = _recorded_reports(monkeypatch, t_api)
    orig_args = list(args) + (out_args("ref") if out_args else [])
    if argv_main:
        original(name).main(orig_args)
    else:
        _argv(monkeypatch, name, orig_args)
        original(name).main()
    want = capsys.readouterr().out
    out = twin(name).main(list(args) + (out_args("port") if out_args else [])
                          + ["--device", "cpu"])
    got = capsys.readouterr().out
    assert [r.to_json() for r in got_reports] == [r.to_json() for r in want_reports]
    assert got_reports
    return want, got, out


@pytest.mark.parametrize("name,args", [
    ("serve_fleet", ("--n", "60")),
    ("serve_disagg", ()),
    ("serve_chaos", ()),
    ("carbon_shift", ()),
])
def test_session_twin_reports_and_tables_equal_the_original(monkeypatch, capsys, name, args):
    want, got, out = _session_pair(monkeypatch, capsys, name, args)
    assert got == want
    assert out


def test_sweep_decisions_rows_equal_the_original(monkeypatch, capsys, tmp_path):
    paths = {k: tmp_path / f"{k}.json" for k in ("ref", "port")}
    want, got, out = _session_pair(monkeypatch, capsys, "sweep_decisions",
                                   out_args=lambda k: ["--out", str(paths[k])])
    wall = re.compile(r";cal_s=.*")       # the host's seconds, not the simulation's
    assert wall.sub("", got) == wall.sub("", want)
    docs = {k: json.loads(p.read_text()) for k, p in paths.items()}
    rows = {k: [{f: v for f, v in r.items() if f != "sim_host_s"} for r in d["decision_grid"]]
            for k, d in docs.items()}
    assert rows["port"] == rows["ref"] and len(rows["port"]) == 4
    assert docs["port"]["generated_by"] == "examples/torch_sweep_decisions.py"
    assert [r["bulk_format"] for r in out["rows"]] == ["rsm", "rsm", "rsm_int8", "rsm_int8"]


@pytest.mark.parametrize("tactic", ["failover_degrade", "healthy"])
def test_serve_monitored_dashboard_equals_the_original(monkeypatch, capsys, tmp_path, tactic):
    paths = {k: tmp_path / f"{k}.html" for k in ("ref", "port")}
    want, got, out = _session_pair(monkeypatch, capsys, "serve_monitored",
                                   ("--tactic", tactic), argv_main=True,
                                   out_args=lambda k: ["--out", str(paths[k])])
    assert got.replace(str(paths["port"]), "OUT") == want.replace(str(paths["ref"]), "OUT")
    assert paths["port"].read_bytes() == paths["ref"].read_bytes()
    assert out["status"] == 0 and out["observer_pure"]
    assert bool(out["incidents"]) == (tactic == "failover_degrade")


def test_serve_traced_trace_equals_the_original(monkeypatch, capsys, tmp_path):
    paths = {k: tmp_path / f"{k}.json" for k in ("ref", "port")}
    want, got, out = _session_pair(monkeypatch, capsys, "serve_traced", argv_main=True,
                                   out_args=lambda k: ["--out", str(paths[k])])
    assert got.replace(str(paths["port"]), "OUT") == want.replace(str(paths["ref"]), "OUT")
    assert paths["port"].read_bytes() == paths["ref"].read_bytes()
    assert out["status"] == 0 and "crash" in out["chaos_markers"]


# -- the twin of scripts/dump_ops.py ---------------------------------------------------------


def test_dump_ops_flops_equal_the_dryrun_trace(capsys):
    dump_ops = _load(REPO / "scripts" / "torch_dump_ops.py")
    out = dump_ops.main(["--arch", "minitron-4b", "--shape", "decode_32k", "--layers", "2",
                         "--mesh", "single", "--device", "cpu"])
    text = capsys.readouterr().out
    cfg = dataclasses.replace(t_configs.get_arch("minitron-4b"), num_layers=2,
                              unroll_layers=True)
    mesh = mesh_lib.make_production_mesh(multi_pod=False)
    try:
        trace, kind, _ = dryrun.trace_step(cfg, t_configs.get_shape("decode_32k"), mesh)
    finally:
        mesh_lib.release()
    assert kind == out["kind"] == "decode"
    assert out["flops"] == trace.flops > 0
    assert out["bytes_accessed"] == trace.bytes_accessed
    assert text.splitlines()[0] == (f"flops/dev {trace.flops:.4e}  "
                                    f"bytes/dev {trace.bytes_accessed:.4e}")
    ops_ = {row["op"]: row for row in out["top"]}
    assert "decode_attention" in ops_ and ops_["decode_attention"]["count"] == 2
    assert out["result_bytes"] >= sum(row["bytes"] for row in out["top"]) > 0


# -- F8: the kernel wrappers on DTensors over real shards ------------------------------------


def _cases(g):
    r = lambda *s: torch.randn(*s, generator=g)  # noqa: E731
    B, H, K, S, dh = 2, 4, 2, 16, 32
    q, k, v = r(B, H, S, dh), r(B, K, S, dh), r(B, K, S, dh)
    w_q = torch.randint(-127, 128, (64, 32), generator=g, dtype=torch.int8)
    E, C, D, F = 3, 8, 16, 24
    T_, dk = 8, 16
    rw = [r(B, H, T_, dk) * 0.5 for _ in range(3)] + [torch.sigmoid(r(B, H, T_, dk))]
    cases = [
        ("flash_attention", (q, k, v), {"causal": True}),
        ("decode_attention", (r(B, K, H // K, dh), r(B, K, S, dh), r(B, K, S, dh),
                              torch.tensor([16, 9], dtype=torch.int32)), {}),
        ("int8_matmul", (r(4, 64), w_q, torch.rand(32, generator=g)), {}),
        ("moe_gmm", (r(E, C, D), r(E, D, F), torch.tensor([8, 3, 0], dtype=torch.int32)), {}),
        ("moe_gmm_bwd", (r(E, C, D), r(E, D, F), torch.tensor([8, 3, 0], dtype=torch.int32),
                         r(E, C, F)), {}),
        ("rwkv6_scan", (*rw, r(H, dk) * 0.3, r(B, H, dk, dk)), {}),
        ("rwkv6_scan_bwd", (*rw, r(H, dk) * 0.3, r(B, H, dk, dk), r(B, H, T_, dk)), {}),
    ]
    o, lse = ops.flash_attention(q, k, v, causal=True, return_lse=True)
    cases.append(("flash_attention_bwd", (q, k, v, o, lse, r(B, H, S, dh)), {"causal": True}))
    return cases


def _leaves(x) -> tuple:
    return x if isinstance(x, tuple) else (x,)


def test_real_dtensors_take_the_kernels_path_f8():
    g = torch.Generator().manual_seed(0)
    cases = _cases(g)
    assert sorted(name for name, _, _ in cases) == sorted(ops.launch_counts())
    mesh = mesh_lib.make_host_mesh()
    try:
        for name, args, kw in cases:
            assert not ops.is_fake(args[0])
            dist = [DTensor.from_local(a, mesh, [Replicate(), Replicate()]) for a in args]
            assert not ops.is_fake(dist[0])
            want = _leaves(getattr(ops, name)(*args, **kw))
            got = _leaves(getattr(ops, name)(*dist, **kw))
            assert len(got) == len(want), name
            for a, b in zip(got, want):
                assert isinstance(a, DTensor), name
                torch.testing.assert_close(a.full_tensor(), b, rtol=0, atol=0, msg=name)
    finally:
        mesh_lib.release()


def test_real_dtensors_refuse_the_layouts_only_the_trace_takes_f8():
    """On real shards the two layouts whose local results would not be the
    rank's share raise: q heads grouped over kv heads across ranks, and an
    in-place operand that would have to move."""
    from torch.distributed.tensor import Shard

    g = torch.Generator().manual_seed(1)
    mesh = mesh_lib.make_production_mesh(multi_pod=False)     # 16 x 16 fake ranks
    try:
        heads = [Replicate(), Shard(1)]
        q = DTensor.from_local(torch.randn(1, 2, 8, 32, generator=g), mesh, heads,
                               shape=(1, 32, 8, 32), stride=(8192, 256, 32, 1))
        kv = [DTensor.from_local(torch.randn(1, 8, 8, 32, generator=g), mesh,
                                 [Replicate(), Replicate()]) for _ in range(2)]
        with pytest.raises(NotImplementedError, match="grouped"):
            ops.flash_attention(q, *kv)
        r, k, v, w = (DTensor.from_local(torch.rand(1, 1, 4, 16, generator=g), mesh, heads,
                                         shape=(1, 16, 4, 16), stride=(1024, 64, 16, 1))
                      for _ in range(4))
        u = torch.rand(16, 16, generator=g)
        s0 = torch.zeros(1, 16, 16, 16)
        with pytest.raises(NotImplementedError, match="in-place operand 6"):
            ops.rwkv6_scan(r, k, v, w, u, s0, s_out=s0)
    finally:
        mesh_lib.release()
