"""Build ``surf_tpu_torch/csrc/*.cu`` into one shared library at first use.

The library has a plain C interface and is loaded with ctypes; it is
compiled with nvcc for ``sm_90a`` into ``surf_tpu_torch/_build/`` (listed
in ``.gitignore``), under a name that carries a hash of the sources and
flags, so a changed source rebuilds and an unchanged one is reused.  The
sources and the headers they include (``csrc/*.cuh``) are the only input.
Each source is compiled by its own nvcc process, all started together,
and the objects are then linked into the library.  ``--fmad=false`` keeps every multiply and add separately rounded,
as the plain PyTorch versions compute them.
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
    "--fmad=false", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

# The C entry points of the walks (stream_walk.cu, stream_walk_ilv.cu,
# stream_walk_spec.cu, stream_walk_stack.cu: one kernel template per walk),
# dep_micro.cu, leaf_micro.cu, visit_micro.cu, shape_micro.cu, op_micro.cu
# and mxu_micro.cu (one per variant); their wrappers count launches under
# these names.
WALK_ENTRY_POINTS = tuple(f"stream_walk_{a}_{m}" for a in ("skip", "stack", "ilv", "spec", "specb")
                          for m in ("closest", "any"))
# The stack walk's first design (stream_walk.cu): reached only to time it
# beside stream_walk_stack_{closest,any} (stream_walk_stack.cu).
STACK_PR3_ENTRY_POINTS = ("stream_walk_stack_closest_pr3", "stream_walk_stack_any_pr3")
# skip2 / ilvN's first design (stream_walk.cu): reached only to time it
# beside stream_walk_ilv_{closest,any} (stream_walk_ilv.cu).
ILV_PR5_ENTRY_POINTS = ("stream_walk_ilv_closest_pr5", "stream_walk_ilv_any_pr5")
# specN / specbN's first design (stream_walk.cu): reached only to time it
# beside stream_walk_spec{,b}_{closest,any} (stream_walk_spec.cu).
SPEC_PR5_ENTRY_POINTS = tuple(f"stream_walk_{a}_{m}_pr5" for a in ("spec", "specb")
                              for m in ("closest", "any"))
# The walk kernels with an entry.cuh getter: the skip walk's first design
# (stream_walk_skip_*, reached only by stream_walk_skip_pr3: algo="skip"
# launches stream_walk_ilv_*), the first ilv and spec designs,
# stream_walk_ilv.cu's and stream_walk_spec.cu's; the stack walk's two
# designs.
WALK_KERNELS = ("stream_walk_skip_closest", "stream_walk_skip_any", *ILV_PR5_ENTRY_POINTS,
                "stream_walk_ilv_closest", "stream_walk_ilv_any", *SPEC_PR5_ENTRY_POINTS,
                *(f"stream_walk_{a}_{m}" for a in ("spec", "specb") for m in ("closest", "any")),
                *STACK_PR3_ENTRY_POINTS, "stream_walk_stack_closest", "stream_walk_stack_any")
DEP_ENTRY_POINTS = tuple(f"dep_chain_{v}" for v in ("dep0", "dep1", "dep1red", "dep1lean",
                                                     "depb8", "depb8all"))
GROUP_ENTRY_POINTS = tuple(f"leaf_groups_{v}" for v in ("full", "nodiv", "noext", "halftri"))
VISIT_ENTRY_POINTS = tuple(f"leaf_visit_{v}" for v in ("empty", "full", "recip", "nodiv",
                                                        "extonly", "half"))
COST_ENTRY_POINTS = tuple(f"visit_cost_{v}" for v in ("shell", "ext48", "ext120", "slab",
                                                        "slabfma", "mt", "full", "fullred",
                                                        "bf4", "bf8"))
QUANT_ENTRY_POINTS = tuple(f"quant_visit_{v}" for v in ("node_f32", "node_q8", "full_f32",
                                                         "full_q8"))
STACK_ENTRY_POINTS = tuple(f"stack_visit_push{n}" for n in (0, 1, 2, 4))
MASK_ENTRY_POINTS = tuple(f"mask_reduce_{v}" for v in ("eight_any", "or_reduce", "max_byte"))
PARTS_ENTRY_POINTS = tuple(f"visit_parts_{v}" for v in ("base", "roll", "any", "fori0", "while",
                                                         "full"))
COND_ENTRY_POINTS = tuple(f"cond_visit_{v}" for v in ("both", "cond"))
BODY_ENTRY_POINTS = tuple(f"visit_body_{v}" for v in ("bin_sroll", "wide_x", "wide_bc",
                                                       "smem_stack"))
# op_micro.cu: the op-cost microbenchmarks.
SPLAT_ENTRY_POINTS = tuple(f"lane_splat_{v}" for v in ("scalar_extract", "bcast_1x128",
                                                       "rep_then_slice", "concat_then_slice",
                                                       "repeat_prim", "roll_lane0"))
EXTRACT_ENTRY_POINTS = tuple(f"lane_extract_e{e}_v{v}" for e, v in ((8, 0), (32, 0), (64, 0),
                                                                     (128, 0), (8, 56), (8, 120),
                                                                     (8, 248)))
INTERLEAVE_ENTRY_POINTS = tuple(f"walk_interleave_{v}" for v in ("serial_any", "inter2",
                                                                 "inter4", "inter8", "inter16",
                                                                 "roll_tput"))
SPEC_ENTRY_POINTS = tuple(f"spec_visit_{v}" for v in ("cur", "w1", "w2", "w3", "w4", "w6"))
# mxu_micro.cu: the matrix-unit microbenchmarks (one template per layout).
MXU_ENTRY_POINTS = (tuple(f"mxu_tiles{n}_{m}" for n in (8, 16) for m in ("static", "dyn"))
                    + tuple(f"mxu_parts_{v}" for v in ("full", "dotonly", "epionly", "dotbf16",
                                                        "bigdot"))
                    + ("mxu_pltd",))

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
    for src in sorted(CSRC.glob("*.cu*")):
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
    tag = BUILD_DIR / f"{so.stem}.{os.getpid()}"
    nvcc, srcs = _nvcc(), _sources()
    objs = [Path(f"{tag}.{src.stem}.o") for src in srcs]
    procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for src, obj in zip(srcs, objs)]
    log = "".join(f"== {src.name}\n{p.communicate()[0]}" for src, p in zip(srcs, procs))
    tmp = Path(f"{tag}.tmp.so")
    ok = all(p.returncode == 0 for p in procs)
    if ok:
        link = subprocess.run([nvcc, "-shared", "-o", str(tmp), *map(str, objs)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        log += f"== link\n{link.stdout}"
        ok = link.returncode == 0
    for obj in objs:
        obj.unlink(missing_ok=True)
    so.with_suffix(".log").write_text(log)
    if not ok:
        raise RuntimeError("nvcc failed:\n" + log)
    os.replace(tmp, so)
    return so


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first use), with argtypes set."""
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(str(build()))
        p, i = ctypes.c_void_p, ctypes.c_int
        from .leaf_rows import (BF16_ENTRY_POINTS, ENTRY_POINTS, FIRST_DESIGNS,
                                LIVE_ENTRY_POINTS)

        for name in (*ENTRY_POINTS, *FIRST_DESIGNS.values()):
            fn = getattr(lib, name)
            if name in LIVE_ENTRY_POINTS + BF16_ENTRY_POINTS:
                # table, table_rows, lists, cap, n_rows, rays, n_rays,
                # block_rays, split_rows, t_in, r_in, u_in, v_in, t, r, u, v,
                # keys, arrivals, stream
                fn.argtypes = [p, i, p, i, p, p, i, i, i, p, p, p, p, p, p, p, p, p, p, p]
            else:
                # table, table_rows, lists, cap, n_rows, rays, n_rays,
                # block_rays, t_in, r_in, u_in, v_in, t, r, u, v, stream
                fn.argtypes = [p, i, p, i, p, p, i, i, p, p, p, p, p, p, p, p, p]
            fn.restype = i
        from .inst_rows import FIRST_DESIGNS as INST_FIRST

        for name in (*INST_FIRST, *INST_FIRST.values()):
            fn = getattr(lib, name)
            if name in INST_FIRST:
                # table, lists, cap_tot, counts, n_inst, segs, inv, rays,
                # n_rays, block_rays, split_rows, splits, t, r, u, v, inst,
                # keys, arrivals, stream
                fn.argtypes = [p, p, i, p, i, p, p, p, i, i, i, i, p, p, p, p, p, p, p, p]
            else:
                # table, lists, cap_tot, counts, n_inst, segs, inv, rays,
                # n_rays, block_rays, t, r, u, v, inst, stream
                fn.argtypes = [p, p, i, p, i, p, p, p, i, i, p, p, p, p, p, p]
            fn.restype = i
        for name in (WALK_ENTRY_POINTS + STACK_PR3_ENTRY_POINTS + ILV_PR5_ENTRY_POINTS
                     + SPEC_PR5_ENTRY_POINTS):
            fn = getattr(lib, name)
            # stream, n_entries, rays, act, n_rays, block_rays, arg (stack
            # depth, ilvN's N or rows per window), t, r, u, v, visits, stream
            fn.argtypes = [p, i, p, p, i, i, i, p, p, p, p, p, p]
            fn.restype = i
        for name in DEP_ENTRY_POINTS + VISIT_ENTRY_POINTS + QUANT_ENTRY_POINTS:
            fn = getattr(lib, name)
            # table, n_rows, rays, n_steps (leaf_visit, quant_visit: iters), t,
            # r, end, stream
            fn.argtypes = [p, i, p, i, p, p, p, p]
            fn.restype = i
        for name in COST_ENTRY_POINTS:
            fn = getattr(lib, name)
            # table, n_rows, rays, rows_total, t, r, acc, boxes, state, stream
            fn.argtypes = [p, i, p, i, p, p, p, p, p, p]
            fn.restype = i
        for name in (STACK_ENTRY_POINTS + MASK_ENTRY_POINTS + PARTS_ENTRY_POINTS
                     + COND_ENTRY_POINTS + BODY_ENTRY_POINTS + SPLAT_ENTRY_POINTS
                     + EXTRACT_ENTRY_POINTS + INTERLEAVE_ENTRY_POINTS):
            fn = getattr(lib, name)
            # table, n_rows, x, iters, o, state (mask_reduce: end), stream
            fn.argtypes = [p, i, p, i, p, p, p]
            fn.restype = i
        for name in SPEC_ENTRY_POINTS:
            fn = getattr(lib, name)
            # table, n_rows, rays, rows_total, t, r, state, stream
            fn.argtypes = [p, i, p, i, p, p, p, p]
            fn.restype = i
        for name in MXU_ENTRY_POINTS:
            fn = getattr(lib, name)
            if name == "mxu_pltd":
                # rays_t, rows, tmax_t, n_blocks, t, k, stream
                fn.argtypes = [p, p, p, i, p, p, p]
            else:
                # trips, rays, rows, tmax, n_blocks, t, k, chk, stream
                fn.argtypes = [p, p, p, p, i, p, p, p, p]
            fn.restype = i
        for name in GROUP_ENTRY_POINTS:
            fn = getattr(lib, name)
            # table, lists, cap8, counts, rays, t_max, n_rays, t, r, u, v, stream
            fn.argtypes = [p, p, i, p, p, p, i, p, p, p, p, p]
            fn.restype = i
        from .bvh_walk import ENTRY_POINTS as BVH_ENTRY, FIRST_DESIGNS as BVH_FIRST

        for name in (*BVH_ENTRY, *BVH_FIRST.values()):
            fn = getattr(lib, name)
            # nodes, n_nodes, tris, rays, act, n_rays, t, p, u, v, counts, stream
            fn.argtypes = [p, i, p, p, p, i, p, p, p, p, p, p]
            fn.restype = i
        # The kernel an entry point launches (entry.cuh) and its device name.
        for name in (LIVE_ENTRY_POINTS + BF16_ENTRY_POINTS + tuple(FIRST_DESIGNS.values())
                     + tuple(INST_FIRST) + tuple(INST_FIRST.values()) + PARTS_ENTRY_POINTS
                     + COND_ENTRY_POINTS + BODY_ENTRY_POINTS + SPLAT_ENTRY_POINTS
                     + EXTRACT_ENTRY_POINTS + INTERLEAVE_ENTRY_POINTS + SPEC_ENTRY_POINTS
                     + MXU_ENTRY_POINTS + WALK_KERNELS + BVH_ENTRY
                     + tuple(BVH_FIRST.values())):
            fn = getattr(lib, f"{name}_kernel")
            fn.argtypes = []
            fn.restype = p
        lib.surf_kernel_name.argtypes = [p, ctypes.POINTER(ctypes.c_char_p)]
        lib.surf_kernel_name.restype = i
        for name in ("leaf_rows_threads_per_block", "inst_rows_threads_per_block",
                     "stream_walk_threads_per_block"):
            getattr(lib, name).argtypes = []
            getattr(lib, name).restype = i
        _LIB = lib
    return _LIB
