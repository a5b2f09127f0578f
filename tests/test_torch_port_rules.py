"""Rules the port keeps: no jax and nothing of the JAX package; the GPU
unless the caller names the CPU; clear failures where the toolchain or the
card is missing."""

import os
import pathlib
import re
import shutil
import subprocess
import sys

import pytest
import torch

import repro_torch
from repro_torch.configs import get_arch
from repro_torch.kernels import build

REPO = pathlib.Path(__file__).resolve().parents[1]
PKG = pathlib.Path(repro_torch.__file__).resolve().parent


def test_every_module_imports_without_jax():
    code = (
        "import sys, pkgutil, importlib\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['repro'] = None\n"
        "import repro_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.')]\n"
        "for n in names: importlib.import_module(n)\n"
        "assert not any(k == 'jax' or k.startswith('jax.') for k, v in sys.modules.items()"
        " if v is not None)\n"
        "print(len(names))\n"
    )
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=env, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 20


def test_sources_name_no_jax_and_no_reference_package():
    pattern = re.compile(r"\bjax\b|\brepro\.")
    sources = [p for p in PKG.rglob("*") if p.suffix in (".py", ".cu", ".cuh")]
    assert len(sources) >= 25
    for path in sources:
        for i, line in enumerate(path.read_text().splitlines(), 1):
            assert not pattern.search(line), f"{path}:{i}: {line}"


def test_entry_points_raise_without_a_gpu(monkeypatch, tmp_path):
    from repro_torch.core.engines import CompiledEngine, EagerEngine
    from repro_torch.models import transformer as T
    from repro_torch.serving import formats

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_arch("minitron-4b-smoke")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        T.init_params(cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        T.init_cache(cfg, 1, 8)
    params = T.init_params(cfg, device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        T.params_from_numpy(params, cfg)
    for cls in (EagerEngine, CompiledEngine):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            cls(cfg, params, 16)
    formats.save_rsm(params, str(tmp_path / "rsm"))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        formats.load_rsm(params, str(tmp_path / "rsm"))
    # the spec API, its adapters and the launcher
    from repro_torch.core.add import Deployment
    from repro_torch.launch import serve
    from repro_torch.serving.api import ServingSession
    from repro_torch.serving.cloud import CloudService
    from repro_torch.serving.server import ServingServer

    for make in (ServingSession, lambda: CloudService(str(tmp_path / "reg")),
                 lambda: ServingServer(Deployment(arch=cfg.name)),
                 lambda: serve.main(["--arch", cfg.name, "--requests", "1"])):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make()


def test_kernel_build_raises_without_nvcc(monkeypatch, tmp_path):
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(build, "DEFAULT_CUDA_HOME", str(tmp_path / "no-cuda-either"))
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(build.KernelBuildError, match="nvcc not found"):
        build.nvcc_path()
    with pytest.raises(build.KernelBuildError, match="nvcc not found"):
        build.build_all()


def test_kernel_build_reports_compiler_output(monkeypatch, tmp_path):
    """A refused source raises with what the compiler said."""
    fake = tmp_path / "bin" / "nvcc"
    fake.parent.mkdir()
    fake.write_text("#!/bin/sh\necho 'error: expected a ;' >&2\nexit 2\n")
    fake.chmod(0o755)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(build.KernelBuildError, match="expected a ;"):
        build.build_all(["int8_matmul"])


def test_library_path_follows_the_sources():
    paths = {build.library_path(n) for n in build.KERNELS}
    assert len(paths) == len(build.KERNELS)
    assert all(p.parent == build.BUILD_DIR and p.suffix == ".so" for p in paths)
    assert build.library_path("int8_matmul") == build.library_path("int8_matmul")


@pytest.mark.parametrize("alone", [False, True], ids=["repo", "alone"])
def test_chip_smoke_fails_without_gpu_or_repo(alone, tmp_path):
    script = REPO / "chip_smoke.py"
    if alone:
        shutil.copy(script, tmp_path / "chip_smoke.py")
        script = tmp_path / "chip_smoke.py"
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    env.pop("PYTHONPATH", None)
    out = subprocess.run([sys.executable, str(script)], capture_output=True, text=True,
                         env=env, cwd=script.parent, timeout=120)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
