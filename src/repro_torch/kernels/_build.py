"""Build the port's CUDA kernels at first use and load them with ctypes.

Each kernel is one ``csrc/*.cu`` file with a plain C interface, compiled by
``nvcc`` into its own shared library (no PyTorch headers, so a build takes
seconds).  Libraries go to ``build/repro_torch_kernels/`` at the repository
root, named by a hash of the source and the flags, so an edited source
rebuilds and an unchanged one loads what is there.  Importing this module
builds nothing; the CPU tests import every module on a machine without
``nvcc``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from dataclasses import dataclass
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


class KernelBuildError(RuntimeError):
    """nvcc is missing or refused a source; the message holds its stderr."""


@dataclass
class BuiltKernel:
    lib: ctypes.CDLL
    path: Path
    log: str            # nvcc's output of the build (ptxas: registers, smem)
    build_s: float      # 0.0 when the library was already built


_LOADED: dict[str, BuiltKernel] = {}
_LOCK = threading.Lock()


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise KernelBuildError(
        "nvcc not found (PATH, $CUDA_HOME/bin or /usr/local/cuda/bin): the "
        "CUDA kernels are built from source on the machine with the card")


def _digest(source: Path) -> str:
    h = hashlib.sha256(source.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def build(name: str) -> BuiltKernel:
    """Compile ``csrc/<name>.cu`` (once per process and source hash) and
    load it.  Raises :class:`KernelBuildError` with nvcc's stderr."""
    with _LOCK:
        if name in _LOADED:
            return _LOADED[name]
        src = CSRC / f"{name}.cu"
        out = BUILD_DIR / f"{name}-{_digest(src)}.so"
        log_path = out.with_suffix(".log")
        build_s = 0.0
        if not out.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
            os.close(fd)
            t0 = time.perf_counter()
            proc = subprocess.run([nvcc_path(), *NVCC_FLAGS, "-o", tmp, str(src)],
                                  capture_output=True, text=True)
            build_s = time.perf_counter() - t0
            if proc.returncode != 0:
                os.unlink(tmp)
                raise KernelBuildError(
                    f"nvcc failed on {src} (exit {proc.returncode}):\n"
                    f"{proc.stderr}{proc.stdout}")
            log_path.write_text(proc.stderr + proc.stdout)
            os.replace(tmp, out)  # atomic: a concurrent builder sees all or nothing
        log = log_path.read_text() if log_path.exists() else ""
        built = BuiltKernel(lib=ctypes.CDLL(str(out)), path=out, log=log,
                            build_s=build_s)
        _LOADED[name] = built
        return built
