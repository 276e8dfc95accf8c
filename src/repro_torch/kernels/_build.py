"""Build and load the port's CUDA sources (``src/repro_torch/csrc``).

Each source has a plain ``extern "C"`` interface and includes no PyTorch
header, so ``nvcc`` builds it into a shared library in seconds; the library
is loaded with ``ctypes``. The build runs at first use, never at import,
into ``build/repro_torch/`` at the repository root. The library's file name
carries a digest of the source and the flags, so an edited source is
rebuilt and a stale library is never loaded.

There is no fallback: a missing ``nvcc`` or a failed build raises with the
compiler's output.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Sequence

from repro_torch.spans import span

__all__ = ["BUILD_DIR", "NVCC_FLAGS", "build", "find_nvcc", "load_library"]

_PKG = Path(__file__).resolve().parents[1]
CSRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG.parents[1] / "build" / "repro_torch"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)

_LOCK = threading.Lock()
_LIBS: Dict[str, ctypes.CDLL] = {}


def find_nvcc() -> str:
    """Path of ``nvcc``: on ``PATH``, else under ``$CUDA_HOME`` or
    ``/usr/local/cuda``.

    Raises:
      RuntimeError: no ``nvcc`` is found.
    """
    found = shutil.which("nvcc")
    if found:
        return found
    for home in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if home and os.access(os.path.join(home, "bin", "nvcc"), os.X_OK):
            return os.path.join(home, "bin", "nvcc")
    raise RuntimeError(
        "nvcc not found on PATH, under $CUDA_HOME or /usr/local/cuda; the "
        "port's CUDA kernels are built from source at first use"
    )


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` into ``build/repro_torch/`` (once per
    source digest) and return the library's path.

    The compiler's output, including ``-Xptxas=-v``'s register and shared
    memory report, is kept beside the library as ``<lib>.log``.

    Raises:
      RuntimeError: nvcc is missing or the build fails (with its output).
    """
    src = CSRC_DIR / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode())
    lib = BUILD_DIR / f"lib{name}-{digest.hexdigest()[:12]}.so"
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    cmd = [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
    with span("tc.nvcc"):
        proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}) building {src}:\n"
            f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}"
        )
    lib.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    os.replace(tmp, lib)  # atomic: a concurrent loader never sees half a file
    return lib


def load_library(name: str, signatures: Dict[str, Sequence]) -> ctypes.CDLL:
    """Build (if needed) and load ``csrc/<name>.cu``, declaring each
    function's ``argtypes`` from ``signatures`` and an int return (the
    ``cudaGetLastError()`` after the launch)."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build(name)))
            for fn, argtypes in signatures.items():
                getattr(lib, fn).argtypes = list(argtypes)
                getattr(lib, fn).restype = ctypes.c_int
            _LIBS[name] = lib
        return lib
