"""Build and bind the port's hand-written CUDA kernel.

The kernel source under ``ops/csrc/`` exposes a plain C launch function (no
PyTorch headers). ``load`` compiles it with ``nvcc`` for Hopper (``sm_90a``)
into a shared library under ``build/kernels/`` at the repository root, if
that library is missing, and binds the launch function with ``ctypes``. The
library name carries a hash of the source and of the nvcc flags, so an
edited source or a change of flags is rebuilt, and an unchanged pair is
reused within a checkout.

Nothing here runs at import: the kernel is built on its first launch.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parents[1]
BUILD_DIR = PACKAGE_DIR.parent / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def find_nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                       "machine with the CUDA toolkit")


def library_path(source: str) -> Path:
    """build/kernels/lib<stem>-<hash of the source and NVCC_FLAGS>.so for a
    package-relative source path."""
    src = PACKAGE_DIR / source
    h = hashlib.sha256(src.read_bytes())
    h.update("\0".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{src.stem}-{h.hexdigest()[:16]}.so"


def build(source: str) -> str:
    """Compile `source` (relative to the package) unless its library exists.
    Returns nvcc's output, or "" when the library was already there."""
    out = library_path(source)
    if out.exists():
        return ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # compile to a private name and move it into place, so two processes
    # building at once never load a half-written library
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    p = subprocess.run([find_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
                        str(PACKAGE_DIR / source)],
                       capture_output=True, text=True)
    log = p.stdout + p.stderr
    if p.returncode != 0:
        raise RuntimeError(f"nvcc failed for {source}:\n{log}")
    os.replace(tmp, out)
    return log


def load(source: str, symbol: str, argtypes):
    """Build `source` if needed and return its C launch function `symbol`,
    which returns a cudaError code."""
    build(source)
    fn = getattr(ctypes.CDLL(str(library_path(source))), symbol)
    fn.argtypes = list(argtypes)
    fn.restype = ctypes.c_int
    return fn
