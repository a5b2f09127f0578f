"""Build the CUDA kernels with ``nvcc`` at first use and load them with ctypes.

Each ``csrc/<name>.cu`` becomes one shared library with a plain C interface,
``build/repro_torch/<name>-<hash>.so`` under the repository root, where the
hash covers the sources and the compiler flags: a changed source builds
anew, an unchanged one is loaded from the earlier build.  ``build_all``
starts one ``nvcc`` per source, all at once.  A missing ``nvcc`` or a failed
build raises with the compiler's output; nothing falls back.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable, Optional

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
KERNELS = ("flash_attention", "decode_attention", "int8_matmul")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
DEFAULT_CUDA_HOME = "/usr/local/cuda"
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}   # csrc/common.cuh

_libs: Dict[str, ctypes.CDLL] = {}


class KernelBuildError(RuntimeError):
    """nvcc is missing, or it refused a kernel source."""


def nvcc_path() -> str:
    """The nvcc to build with: $CUDA_HOME/bin, then PATH, then /usr/local/cuda."""
    cuda_home = os.environ.get("CUDA_HOME")
    candidates = [os.path.join(cuda_home, "bin", "nvcc")] if cuda_home else []
    on_path = shutil.which("nvcc")
    if on_path:
        candidates.append(on_path)
    candidates.append(os.path.join(DEFAULT_CUDA_HOME, "bin", "nvcc"))
    for c in candidates:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise KernelBuildError(
        "nvcc not found (looked in $CUDA_HOME/bin, PATH and "
        f"{DEFAULT_CUDA_HOME}/bin): the CUDA kernels of repro_torch are "
        "built from csrc/*.cu at first use and need the CUDA toolkit")


def library_path(name: str) -> Path:
    h = hashlib.sha256()
    for src in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build_all(names: Iterable[str] = KERNELS) -> Dict[str, dict]:
    """Build every named kernel that has no current library, in parallel.

    Returns {name: {"path", "seconds", "built", "log"}}; ``log`` is nvcc's
    report (registers, shared memory and spills per kernel, from -Xptxas -v).
    """
    names = list(names)
    report: Dict[str, dict] = {}
    todo = []
    for name in names:
        path = library_path(name)
        if path.exists():
            log_path = path.with_suffix(".log")
            report[name] = {"path": str(path), "seconds": 0.0, "built": False,
                            "log": log_path.read_text() if log_path.exists() else ""}
        else:
            todo.append((name, path))
    if not todo:
        return report
    nvcc = nvcc_path()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = []
    t0 = time.perf_counter()
    for name, path in todo:
        tmp = path.with_name(f"{path.stem}.{os.getpid()}.tmp.so")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs.append((name, path, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    failures = []
    for name, path, tmp, proc in procs:
        log, _ = proc.communicate()
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            failures.append(f"--- {name}.cu (nvcc exit {proc.returncode})\n{log}")
            continue
        os.replace(tmp, path)   # atomic: a concurrent build sees old or new
        path.with_suffix(".log").write_text(log)
        report[name] = {"path": str(path), "seconds": seconds, "built": True,
                        "log": log}
    if failures:
        raise KernelBuildError("nvcc failed:\n" + "\n".join(failures))
    return report


def library(name: str, signatures: Optional[dict] = None) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if needed.

    ``signatures`` maps each C function to (argtypes, restype); they are set
    once, when the library is loaded.
    """
    lib = _libs.get(name)
    if lib is None:
        path = build_all([name])[name]["path"]
        lib = ctypes.CDLL(path)
        lib.repro_kernel_error_string.argtypes = [ctypes.c_int]
        lib.repro_kernel_error_string.restype = ctypes.c_char_p
        for fn, (argtypes, restype) in (signatures or {}).items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = restype
        _libs[name] = lib
    return lib


def check(lib: ctypes.CDLL, code: int, what: str) -> None:
    """Raise if a kernel's C entry point reported a CUDA error."""
    if code != 0:
        msg = lib.repro_kernel_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} ({msg})")


def current_stream() -> ctypes.c_void_p:
    """PyTorch's current stream (the capture stream inside a CUDA graph)."""
    return ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
