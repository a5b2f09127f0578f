"""The port's spec API executing minitron-4b-smoke in f32 on the CPU, against
the JAX package's.

The reference's parameters are carried across with ``params_from_numpy``;
each package then saves and loads them through its own TD2 formats, so the
greedy tokens compared below went through the disk in both:

  * a ``ServingSession`` with an ``rsm`` endpoint (SI1) and an ``rsm_int8``
    endpoint (SI2: the reference's validate rejects rsm_int8 on SI1), step
    cache off so every dispatch executes;
  * ``ServingServer.handle`` (SI3, no step cache) and
    ``CloudService.predict`` (SI4, one burst, one executed dispatch);
  * ``python -m repro_torch.launch.serve --device cpu``: its decision line
    and spec JSON are the reference CLI's.
"""

import json
import os
import pathlib
import subprocess
import sys

import jax
import numpy as np
import pytest

import repro.configs as j_configs
import repro.core.add as j_add
import repro.launch.serve as j_launch
import repro.serving.api as j_api
import repro.serving.cloud as j_cloud
import repro.serving.request as j_request
import repro.serving.server as j_server
from repro.models import init_params as j_init_params
import repro_torch.configs as t_configs
import repro_torch.core.add as t_add
import repro_torch.serving.api as t_api
import repro_torch.serving.cloud as t_cloud
import repro_torch.serving.request as t_request
import repro_torch.serving.server as t_server
from repro_torch.core.engines import CompiledEngine, EagerEngine
from repro_torch.models import transformer as T

ARCH = "minitron-4b-smoke"
REPO = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def params():
    jp = j_init_params(j_configs.get_arch(ARCH), jax.random.PRNGKey(0))
    return {"ref": jp, "port": T.params_from_numpy(jax.tree.map(np.asarray, jp),
                                                    t_configs.get_arch(ARCH), device="cpu")}


def _tokens(metrics) -> dict:
    return {r.rid: np.asarray(r.tokens).tolist() for r in metrics.responses}


def _burst(request, n=4, seed=3, rid0=0):
    return request.synth_workload(n, 8, 5, 1000, rate_per_s=1e6, seed=seed, rid0=rid0)


def _session_tokens(api, request, params, tmp, **kw):
    spec = api.ServingSpec(endpoints=tuple(
        api.EndpointSpec(name=name, arch=ARCH, model="m", format=fmt, si=si, max_seq=32,
                         max_batch=4, batch_timeout_ms=5.0, step_cache=False,
                         autoscale=api.AutoscaleSpec(enabled=False, max_replicas=1))
        for name, fmt, si in (("chat", "rsm", "si1_no_runtime"),
                              ("bulk", "rsm_int8", "si2_runtime"))))
    s = api.ServingSession(registry_root=str(tmp), **kw).deploy(spec, params={"m": params})
    rep = s.serve({"chat": _burst(request), "bulk": _burst(request, seed=4, rid0=100)})
    return s, rep, {n: _tokens(r.metrics) for n, r in rep.endpoints.items()}


def test_session_gives_the_reference_tokens(params, tmp_path):
    _, _, want = _session_tokens(j_api, j_request, params["ref"], tmp_path / "ref")
    s, rep, got = _session_tokens(t_api, t_request, params["port"], tmp_path / "port",
                                  device="cpu")
    assert got == want
    assert [len(v) for v in got.values()] == [4, 4]
    assert isinstance(s.engine("chat"), EagerEngine)
    assert isinstance(s.engine("bulk"), CompiledEngine)
    # every dispatch executed: nothing replayed, nothing synthetic
    assert rep.fleet.n_requests == 8 and rep.fleet.j_active > 0


def _deployment(add, si, **kw):
    return add.Deployment(arch=ARCH, si=si, max_batch=4, max_seq=32, batch_timeout_ms=5.0,
                          **kw)


def test_server_handle_gives_the_reference_tokens(params):
    got = {}
    for name, add, server, request, kw in (
            ("ref", j_add, j_server, j_request, {}),
            ("port", t_add, t_server, t_request, {"device": "cpu"})):
        srv = server.ServingServer(
            _deployment(add, add.ServingInfrastructure.SI3_DL_SERVER), **kw)
        srv.register(server.ModelPackage(name="m", arch=ARCH, params=params[name],
                                         max_seq=32))
        m = srv.handle("m", request.synth_workload(6, 8, 4, 1000, rate_per_s=200.0, seed=5))
        got[name] = (_tokens(m), m.fleet["replicas_created"])
    assert got["port"] == got["ref"]
    assert len(got["port"][0]) == 6


def test_cloud_predict_gives_the_reference_tokens(params, tmp_path):
    got = {}
    for name, add, cloud, request, kw in (
            ("ref", j_add, j_cloud, j_request, {}),
            ("port", t_add, t_cloud, t_request, {"device": "cpu"})):
        svc = cloud.CloudService(str(tmp_path / name), **kw)
        svc.upload_model("m", 1, params[name], add.ModelFormat.RSM_INT8)
        svc.deploy("m", 1, _deployment(add, add.ServingInfrastructure.SI4_CLOUD_SERVICE,
                                       model_format=add.ModelFormat.RSM_INT8),
                   template_params=params[name])
        assert svc.registry.versions("m") == [1]
        got[name] = _tokens(svc.predict("m", _burst(request)))
    assert got["port"] == got["ref"] and len(got["port"]) == 4


def _spec_block(text: str) -> tuple:
    """(the decision line, the spec JSON) the launcher prints first."""
    lines = text.splitlines()
    start = lines.index("{")
    spec = "\n".join(lines[start:lines.index("}", start) + 1])
    json.loads(spec)
    return lines[0], spec


ARGV = ["--arch", "minitron-4b", "--smoke", "--requests", "3"]


def test_launcher_prints_the_reference_spec(monkeypatch, capsys):
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    out = subprocess.run([sys.executable, "-m", "repro_torch.launch.serve", *ARGV,
                          "--device", "cpu"], capture_output=True, text=True, env=env,
                         cwd=REPO, timeout=300)
    assert out.returncode == 0, out.stderr
    monkeypatch.setattr(sys, "argv", ["serve", *ARGV])
    j_launch.main()
    ref = capsys.readouterr().out
    assert _spec_block(out.stdout) == _spec_block(ref)
    for marker in ("wire bytes:", "decisions:", "# quality report:", "interoperability"):
        assert marker in out.stdout
    assert "'n_requests': 3" in out.stdout
