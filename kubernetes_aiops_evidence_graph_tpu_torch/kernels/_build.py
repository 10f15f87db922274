"""Build the port's CUDA sources at first use and load them with ctypes.

Each ``kernels/<name>.cu`` compiles with ``nvcc`` into a shared library
with a plain C interface (no PyTorch headers: a file that includes them
takes minutes to compile, a plain one seconds). Libraries land in
``kernels/_build/``, named by a hash of their source and of the shared
headers (``kernels/*.cuh``), so an edited source never loads a stale
library. Nothing here runs at import time.

The target is ``sm_90a``: Hopper (H100, H200).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

KERNEL_DIR = Path(__file__).resolve().parent
BUILD_DIR = KERNEL_DIR / "_build"
SOURCES = ("rules_fold", "gms", "fused_tick", "grad_w")

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


class KernelError(RuntimeError):
    """A kernel failed to build, load or launch. Callers that degrade on
    device faults (the crash shield's ladder) re-raise it: a broken kernel
    is a defect to surface, never a fault to serve around."""


def _nvcc() -> str:
    """nvcc from PATH, else from the toolkit PyTorch found (CUDA_HOME,
    CUDA_PATH or /usr/local/cuda)."""
    from torch.utils.cpp_extension import CUDA_HOME
    nvcc = shutil.which("nvcc") or (
        os.path.join(CUDA_HOME, "bin", "nvcc") if CUDA_HOME else "")
    if not (nvcc and os.access(nvcc, os.X_OK)):
        raise KernelError("nvcc not found: put it on PATH or set CUDA_HOME")
    return nvcc


_ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]


def library_path(name: str) -> Path:
    digest = hashlib.sha256((KERNEL_DIR / f"{name}.cu").read_bytes())
    for header in sorted(KERNEL_DIR.glob("*.cuh")):
        digest.update(header.read_bytes())
    digest.update(" ".join(_ARCH_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def _command(name: str, out: Path) -> list[str]:
    return [_nvcc(), *_ARCH_FLAGS, "-std=c++17", "-O3", "-shared",
            "-Xcompiler", "-fPIC", "-Xptxas=-v", "-lineinfo",
            "-o", str(out), str(KERNEL_DIR / f"{name}.cu")]


def build_all(names: tuple[str, ...] = SOURCES) -> dict[str, dict]:
    """Compile every missing library, one ``nvcc`` per source, all started
    together. Returns ``{name: {"seconds", "log", "cached"}}`` with the
    compiler's output (``-Xptxas=-v`` prints registers, shared memory and
    spills). Raises if any build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    report: dict[str, dict] = {}
    procs = {}
    t0 = time.perf_counter()
    for name in names:
        out = library_path(name)
        if out.exists():
            report[name] = {"seconds": 0.0, "log": "", "cached": True}
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        procs[name] = (subprocess.Popen(
            _command(name, tmp), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True), tmp, out)
    failed = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        report[name] = {"seconds": time.perf_counter() - t0, "log": log,
                        "cached": False}
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exited {proc.returncode}\n{log}")
            continue
        os.replace(tmp, out)
    if failed:
        raise KernelError("kernel build failed:\n" + "\n".join(failed))
    return report


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``kernels/<name>.cu``, built on first use."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            path = library_path(name)
            if not path.exists():
                build_all((name,))
            try:
                lib = ctypes.CDLL(str(path))
            except OSError as exc:
                raise KernelError(f"{name}: cannot load {path}: {exc}") \
                    from exc
            _libs[name] = lib
    return lib
