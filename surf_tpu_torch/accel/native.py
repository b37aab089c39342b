"""ctypes binding of the native SAH builder and refit
(``native/surf_native.cpp``).

The library is compiled with g++ at first use into ``surf_tpu_torch/_build/``
(listed in ``.gitignore``), under a name that carries a hash of the source
and flags, so a changed source rebuilds.  ``SURF_NO_NATIVE=1`` selects the
NumPy builder instead, as in ``surf_tpu``; the two order leaf primitives
differently (builder.py), so both packages must make the same choice to
build the same tree.  Without that variable a failed build raises: the port
never falls back to NumPy on its own.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

from ._build import BUILD_DIR

SRC = Path(__file__).resolve().parent.parent / "native" / "surf_native.cpp"
GXX_FLAGS = ("-O2", "-mtune=generic", "-shared", "-fPIC", "-std=c++17")

_LOCK = threading.Lock()
_LIB: ctypes.CDLL | None = None


def enabled() -> bool:
    """Whether the native builder is selected (SURF_NO_NATIVE unset)."""
    return not os.environ.get("SURF_NO_NATIVE")


def library_path() -> Path:
    h = hashlib.sha256(" ".join(GXX_FLAGS).encode() + SRC.read_bytes())
    return BUILD_DIR / f"libsurfnative-{h.hexdigest()[:16]}.so"


def _compile(so: Path) -> None:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.parent / f"{so.stem}.{os.getpid()}.tmp.so"
    proc = subprocess.run(["g++", *GXX_FLAGS, "-o", str(tmp), str(SRC)],
                          capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed ({proc.returncode}) building {SRC}:\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, so)


def library() -> ctypes.CDLL:
    """The loaded builder library, compiled on first use."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            so = library_path()
            if not so.exists():
                _compile(so)
            lib = ctypes.CDLL(str(so))
            u32p = ctypes.POINTER(ctypes.c_uint32)
            f32p = ctypes.POINTER(ctypes.c_float)
            lib.surf_bvh_build.restype = ctypes.c_uint32
            lib.surf_bvh_build.argtypes = [f32p, f32p, f32p, ctypes.c_uint32,
                                           u32p, f32p, f32p, u32p, u32p,
                                           ctypes.c_uint32]
            lib.surf_bvh_refit.restype = None
            lib.surf_bvh_refit.argtypes = [f32p, f32p, u32p, f32p, f32p,
                                           u32p, u32p, ctypes.c_uint32]
            _LIB = lib
        return _LIB


def _fp(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def _up(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32))


def native_build(prim_lo, prim_hi, key, min_leaf: int = 1):
    """Returns (indices, node_lo, node_hi, left_first, count, nodes_used)."""
    lib = library()
    n = len(prim_lo)
    prim_lo = np.ascontiguousarray(prim_lo, np.float32)
    prim_hi = np.ascontiguousarray(prim_hi, np.float32)
    key = np.ascontiguousarray(key, np.float32)
    indices = np.empty(n, np.uint32)
    # zeros (not empty): node 1 and the unused pool tail stay deterministic,
    # matching the reference's memset (bvh.cpp:76) and the NumPy builder.
    node_lo = np.zeros((2 * n, 3), np.float32)
    node_hi = np.zeros((2 * n, 3), np.float32)
    left_first = np.zeros(2 * n, np.uint32)
    count = np.zeros(2 * n, np.uint32)
    used = lib.surf_bvh_build(
        _fp(prim_lo), _fp(prim_hi), _fp(key), n,
        _up(indices), _fp(node_lo), _fp(node_hi), _up(left_first), _up(count),
        min_leaf,
    )
    return indices, node_lo, node_hi, left_first, count, int(used)


def native_refit(prim_lo, prim_hi, indices, node_lo, node_hi, left_first, count,
                 nodes_used: int) -> None:
    """In-place leaf-up refit of node_lo / node_hi (C-contiguous [2n, 3]
    float32)."""
    lib = library()
    prim_lo = np.ascontiguousarray(prim_lo, np.float32)
    prim_hi = np.ascontiguousarray(prim_hi, np.float32)
    if not (node_lo.flags.c_contiguous and node_hi.flags.c_contiguous):
        raise ValueError("node_lo and node_hi must be C-contiguous")
    lib.surf_bvh_refit(
        _fp(prim_lo), _fp(prim_hi), _up(np.ascontiguousarray(indices, np.uint32)),
        _fp(node_lo), _fp(node_hi), _up(np.ascontiguousarray(left_first, np.uint32)),
        _up(np.ascontiguousarray(count, np.uint32)), nodes_used,
    )
