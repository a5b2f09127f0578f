"""The port's simlint (``repro_torch.analysis``) against the JAX package's.

  * every source blob of ``tests/test_simlint.py`` gives the same findings
    (rule, line, column) under the port's paths as under the reference's;
  * the port (``src/repro_torch``, ``chip_smoke.py``, ``scripts/torch_*.py``)
    lints clean with an empty baseline, and ``--strict`` exits 0 on it;
  * a copy of the port with ``wall * power`` in ``serving/fleet.py`` or
    ``time.time()`` in ``serving/core.py`` fails ``--strict``, naming the
    file, line and rule;
  * R2 also flags torch's module-global draws; a draw with ``generator=``
    is not flagged.
"""

import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from repro.analysis import lint_source as ref_lint_source
from repro_torch.analysis import lint_paths, lint_source
from repro_torch.analysis.engine import classify

REPO = Path(__file__).resolve().parent.parent

SIM = ("src/repro/serving/synthetic.py", "src/repro_torch/serving/synthetic.py")
DRIVER = ("benchmarks/synthetic.py", "scripts/torch_synthetic.py")
METER = ("src/repro/energy/meter.py", "src/repro_torch/energy/meter.py")
CORE = ("src/repro/serving/core.py", "src/repro_torch/serving/core.py")

# (source, (reference path, port path)): the blobs of tests/test_simlint.py
BLOBS = {
    "billed_time_inline": ("def bill(wall_s, power_w):\n    return wall_s * power_w\n", SIM),
    "billed_time_meter": ("def bill(wall_s, power_w):\n    return wall_s * power_w\n", METER),
    "billed_time_rates": ("def ok(rate_per_s, n, energy_w_s):\n"
                          "    a = rate_per_s * n\n"
                          "    b = energy_w_s * n\n"
                          "    return a + b\n", SIM),
    "billed_time_driver": ("e = elapsed_s * gpu_power_w\n", DRIVER),
    "wall_clock_time": ("import time\nnow = time.time()\n", SIM),
    "wall_clock_perf_counter": ("from time import perf_counter\nt0 = perf_counter()\n", SIM),
    "wall_clock_datetime": ("import datetime\nd = datetime.datetime.now()\n", SIM),
    "wall_clock_driver": ("import time\nnow = time.time()\n", DRIVER),
    "pragma_same_line": ("import time\nt0 = time.perf_counter()  # simlint: allow(wall-clock)\n",
                         SIM),
    "pragma_preceding_line": ("import time\n"
                              "# simlint: allow(wall-clock)\n"
                              "t0 = time.perf_counter()\n", SIM),
    "pragma_wrong_rule": ("import time\nt0 = time.perf_counter()  # simlint: allow(id-key)\n",
                          SIM),
    "unseeded_numpy_keyed_random": ("import numpy as np\n"
                                    "import jax\n"
                                    "a = np.random.rand(3)\n"
                                    "b = jax.random.normal(jax.random.PRNGKey(0), (3,))\n",
                                    SIM),
    "zero_arg_rng_ctor": ("import numpy as np\n"
                          "bad = np.random.default_rng()\n"
                          "good = np.random.default_rng(1234)\n", SIM),
    "set_iteration": ("for x in {3, 1, 2}:\n"
                      "    pass\n"
                      "for y in sorted({3, 1, 2}):\n"
                      "    pass\n", SIM),
    "id_key": ("cache = {}\ncache[id(obj)] = 1\n", SIM),
    "clock_write_outside_core": ("def f(core):\n    core.clock = 10.0\n", SIM),
    "clock_write_inside_core": ("class C:\n    def advance(self, t):\n        self.clock = t\n",
                                CORE),
    "billing_event_unstamped": ("def f(m, d):\n    m.record_active(d)\n", SIM),
    "billing_event_stamped": ("def g(m, d, t):\n    m.record_active(d, t_s=t)\n", SIM),
    "out_of_scope": ("import time\nnow = time.time()\n",
                     ("src/repro/models/transformer.py",
                      "src/repro_torch/models/transformer.py")),
}


def _found(findings):
    return [(f.rule, f.line, f.col) for f in findings]


@pytest.mark.parametrize("name", sorted(BLOBS))
def test_port_findings_equal_the_reference(name):
    src, (ref_path, port_path) = BLOBS[name]
    want = _found(ref_lint_source(src, ref_path))
    assert _found(lint_source(src, port_path)) == want
    if name in ("billed_time_inline", "wall_clock_time", "id_key", "set_iteration",
                "clock_write_outside_core", "billing_event_unstamped",
                "unseeded_numpy_keyed_random", "zero_arg_rng_ctor", "billed_time_driver",
                "pragma_wrong_rule", "wall_clock_perf_counter", "wall_clock_datetime"):
        assert want, name       # the blob is one that fires


def test_scopes_of_the_port():
    assert classify("src/repro_torch/serving/fleet.py") == "sim"
    assert classify("src/repro_torch/energy/meter.py") == "sim"
    assert classify("chip_smoke.py") == "driver"
    assert classify("scripts/torch_bwd_ab.py") == "driver"
    # the reference's own files, and the port's model and kernel layers, are
    # out of the port's scope
    assert classify("src/repro/serving/fleet.py") is None
    assert classify("scripts/dump_ops.py") is None
    assert classify("src/repro_torch/models/transformer.py") is None
    assert classify("src/repro_torch/kernels/ops.py") is None


TORCH_DRAWS = ("import torch\n"
               "import torch as th\n"
               "from torch import randint\n"
               "g = torch.Generator()\n"
               "a = torch.randn(3)\n"
               "b = torch.rand(2, generator=g)\n"
               "c = th.multinomial(p, 1)\n"
               "d = randint(0, 5, (3,))\n"
               "e = torch.normal(0.0, 1.0, size=(3,))\n"
               "f = torch.bernoulli(p, generator=g)\n"
               "h = torch.randperm(5)\n"
               "i = torch.randint(0, 5, (3,), generator=g)\n"
               "j = torch.zeros(3)\n")


@pytest.mark.parametrize("path", [SIM[1], DRIVER[1]])
def test_torch_global_draws_are_flagged(path):
    found = _found(lint_source(TORCH_DRAWS, path))
    assert [(r, line) for r, line, _ in found] == [
        ("unseeded-random", n) for n in (5, 7, 8, 9, 11)]
    # the reference's R2 knows numpy's global generator, not torch's
    assert _found(ref_lint_source(TORCH_DRAWS, SIM[0])) == []


def test_port_lints_clean_with_empty_baseline():
    paths = [str(REPO / "src" / "repro_torch"), str(REPO / "chip_smoke.py"),
             *sorted(str(p) for p in (REPO / "scripts").glob("torch_*.py"))]
    findings, scanned = lint_paths(paths)
    assert scanned > 40
    assert findings == [], "\n".join(f.render() for f in findings)


def _run_cli(*args, cwd=None):
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    return subprocess.run([sys.executable, "-m", "repro_torch.analysis", *args],
                          capture_output=True, text=True, env=env, cwd=cwd or str(REPO),
                          timeout=120)


def test_cli_strict_clean_port_exits_0():
    res = _run_cli("--strict")
    assert res.returncode == 0, res.stdout + res.stderr
    assert "0 finding(s)" in res.stdout


def test_cli_missing_path_exits_2():
    assert _run_cli("--strict", "no/such/dir").returncode == 2


@pytest.fixture()
def mutated_tree(tmp_path):
    """A copy of src/repro_torch with room to reintroduce violations."""
    dst = tmp_path / "repro_torch"
    shutil.copytree(REPO / "src" / "repro_torch", dst,
                    ignore=shutil.ignore_patterns("__pycache__", "csrc"))
    return dst


def test_mutated_fleet_inline_billing_fails_strict(mutated_tree):
    fleet = mutated_tree / "serving" / "fleet.py"
    src = fleet.read_text()
    fleet.write_text(src + "\n\ndef _leak(wall_s, power_w):\n    return wall_s * power_w\n")
    bad_line = src.count("\n") + 4
    res = _run_cli("--strict", str(mutated_tree))
    assert res.returncode == 1, res.stdout + res.stderr
    assert "billed-time" in res.stdout and f"fleet.py:{bad_line}" in res.stdout


def test_mutated_core_wall_clock_fails_strict_and_a_baseline_suppresses_it(
        mutated_tree, tmp_path):
    core = mutated_tree / "serving" / "core.py"
    src = core.read_text()
    core.write_text(src + "\n\nimport time\n\ndef _leak_now():\n    return time.time()\n")
    bad_line = src.count("\n") + 6
    res = _run_cli("--strict", str(mutated_tree))
    assert res.returncode == 1, res.stdout + res.stderr
    assert "wall-clock" in res.stdout and f"core.py:{bad_line}" in res.stdout
    assert _run_cli(str(mutated_tree)).returncode == 0      # report-only mode
    baseline = tmp_path / "baseline.json"
    assert _run_cli("--write-baseline", str(baseline), str(mutated_tree)).returncode == 0
    res = _run_cli("--strict", "--baseline", str(baseline), str(mutated_tree))
    assert res.returncode == 0, res.stdout + res.stderr
