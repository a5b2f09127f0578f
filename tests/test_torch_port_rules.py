"""Rules the port keeps: no jax and nothing of the JAX package; the GPU
unless the caller names the CPU; clear failures where the toolchain or the
card is missing."""

import importlib.util
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
# the entry points outside the package: the twins of examples/*.py and of
# scripts/dump_ops.py
TWINS = sorted(REPO.glob("examples/torch_*.py")) + [REPO / "scripts" / "torch_dump_ops.py"]


def _load(path: pathlib.Path):
    spec = importlib.util.spec_from_file_location(path.stem, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_every_module_imports_without_jax():
    code = (
        "import sys, pkgutil, importlib, importlib.util\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['repro'] = None\n"
        "sys.modules['benchmarks'] = None\n"
        "import repro_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.')]\n"
        "for n in names: importlib.import_module(n)\n"
        "for path in sys.argv[1:]:\n"
        "    spec = importlib.util.spec_from_file_location(path.split('/')[-1][:-3], path)\n"
        "    spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
        "assert not any(k == 'jax' or k.startswith('jax.') for k, v in sys.modules.items()"
        " if v is not None)\n"
        "print(len(names), len(sys.argv) - 1)\n"
    )
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    out = subprocess.run([sys.executable, "-c", code, *map(str, TWINS)], capture_output=True,
                         text=True, env=env, timeout=120)
    assert out.returncode == 0, out.stderr
    modules, twins = map(int, out.stdout.split())
    assert modules >= 20 and twins == len(TWINS) == 12


def test_sources_name_no_jax_and_no_reference_package():
    pattern = re.compile(r"\bjax\b|\brepro\.")
    sources = [p for p in PKG.rglob("*") if p.suffix in (".py", ".cu", ".cuh")]
    assert len(sources) >= 25
    for path in sources + TWINS:
        for i, line in enumerate(path.read_text().splitlines(), 1):
            assert not pattern.search(line), f"{path}:{i}: {line}"
    for path in TWINS:
        assert not re.search(r"\bbenchmarks\b\s*import|import\s+benchmarks\b",
                             path.read_text()), path


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
    # training: the step, the loop, checkpoints, the optimizer state, the launcher
    from repro_torch.launch import train
    from repro_torch.training import checkpoint, optim, trainer

    opt = optim.AdamWConfig()
    state = optim.init_opt_state(params)
    checkpoint.save_checkpoint(str(tmp_path / "ckpt"), params, state, 0)
    for make in (lambda: trainer.make_train_step(cfg, opt),
                 lambda: trainer.train_loop(cfg, opt, iter([]), 0),
                 lambda: checkpoint.load_checkpoint(str(tmp_path / "ckpt"), params, state),
                 lambda: optim.opt_state_from_numpy(optim.opt_state_to_numpy(state)),
                 lambda: train.main(["--arch", cfg.name, "--steps", "1"])):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make()
    # the twins of the examples and of dump_ops, at their default arguments
    for path in TWINS:
        argv = (["--arch", "minitron-4b", "--shape", "decode_32k"]
                if path.stem == "torch_dump_ops" else [])
        with pytest.raises(RuntimeError, match="device='cpu'"):
            _load(path).main(argv)


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


def test_twins_write_outside_the_tracked_tree_by_default():
    """The twins' default outputs go under examples_out/, which git ignores
    (the originals write BENCH_*.json / .html beside the tracked files)."""
    ignored = (REPO / ".gitignore").read_text().split()
    assert "examples_out/" in ignored
    writers = [p for p in TWINS if "OUT_DIR" in p.read_text()]
    assert {p.stem for p in writers} == {"torch_sweep_decisions", "torch_serve_monitored",
                                         "torch_serve_traced", "torch_train_small"}
    for path in writers:
        assert pathlib.Path(_load(path).OUT_DIR).resolve() == REPO / "examples_out"
