"""Build ``surf_tpu_torch/csrc/*.cu`` into one shared library at first use.

The library has a plain C interface and is loaded with ctypes; it is
compiled with nvcc for ``sm_90a`` into ``surf_tpu_torch/_build/`` (listed
in ``.gitignore``), under a name that carries a hash of the sources and
flags, so a changed source rebuilds and an unchanged one is reused.  The
sources are the only input.  ``--fmad=false`` keeps every multiply and add
separately rounded, as the plain PyTorch versions compute them.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "--fmad=false", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_LIB: ctypes.CDLL | None = None


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def _nvcc() -> str:
    path = shutil.which("nvcc")
    if path is None:
        from torch.utils.cpp_extension import CUDA_HOME

        if CUDA_HOME is not None:
            path = os.path.join(CUDA_HOME, "bin", "nvcc")
    if path is None or not os.path.isfile(path):
        raise RuntimeError("nvcc not found: put it on PATH or set CUDA_HOME")
    return path


def library_path() -> Path:
    """Where the library for the current sources lives (built or not)."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libsurf_kernels-{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the sources unless a library for them exists; returns its
    path.  nvcc's output (ptxas register and shared-memory use) is kept
    beside it in ``<library>.log``."""
    so = library_path()
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.parent / f"{so.stem}.{os.getpid()}.tmp.so"
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, _sources())]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    so.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, so)
    return so


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first use), with argtypes set."""
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(str(build()))
        p, i = ctypes.c_void_p, ctypes.c_int
        for name in ("leaf_rows_closest", "leaf_rows_any"):
            fn = getattr(lib, name)
            # table, table_rows, lists, cap, n_rows, rays, n_rays,
            # block_rays, t, r, u, v, stream
            fn.argtypes = [p, i, p, i, p, p, i, i, p, p, p, p, p]
            fn.restype = i
        lib.leaf_rows_threads_per_block.argtypes = []
        lib.leaf_rows_threads_per_block.restype = i
        _LIB = lib
    return _LIB
