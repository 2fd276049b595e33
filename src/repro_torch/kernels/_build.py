"""Build and load the hand-written CUDA kernels of ``csrc/``.

A source ``csrc/<name>.cu`` is compiled by ``nvcc`` on first use into a
shared library with a plain C interface under ``build/kernels/`` at the
root of the checkout, and loaded with ``ctypes``; no PyTorch headers are
involved, so a build takes seconds. The library's file name carries a hash
of its source and flags, so an edited source is rebuilt and an unchanged
one is reused. Nothing here runs at import: the CPU tests import every
module.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Callable, Dict

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIBS: Dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()


def nvcc() -> str:
    """Path of ``nvcc``: ``$CUDA_HOME/bin``, then ``/usr/local/cuda/bin``,
    then ``PATH``. Raises ``RuntimeError`` when there is none."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc")
    candidates.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in candidates:
        if c.is_file():
            return str(c)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (CUDA_HOME, /usr/local/cuda, "
                           "PATH); the CUDA kernels are built on a machine "
                           "with the CUDA toolkit")
    return found


def source_path(name: str) -> Path:
    return CSRC / f"{name}.cu"


def library_path(name: str) -> Path:
    src = source_path(name).read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:16]}.so"


def build(name: str) -> str:
    """Compile ``csrc/<name>.cu`` unless it is built already. Returns the
    compiler's output (with ``-Xptxas -v`` it lists registers, shared
    memory and spills), or an empty string for a library that was built
    before. Raises ``RuntimeError`` with that output when nvcc fails."""
    target = library_path(name)
    if target.exists():
        return ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = target.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run(
        [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(source_path(name))],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"CUDA kernel build failed: nvcc exited "
                           f"{proc.returncode} for {name}\n{proc.stdout}")
    os.replace(tmp, target)            # atomic: a reader never sees half
    return proc.stdout


def load_library(name: str, bind: Callable[[ctypes.CDLL], None]
                 ) -> ctypes.CDLL:
    """The loaded kernel library ``name``, built first if needed, with its
    C interface declared by ``bind``."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            build(name)
            lib = ctypes.CDLL(str(library_path(name)))
            bind(lib)
            _LIBS[name] = lib
        return lib
