"""Scene compiler: host Scene -> ``TorchScene`` on a device.

Port of the flattened branch of ``surf_tpu.scene.compile.HostCompiled``
(compile.py:131-176, 304-429), reduced to what the ``bitsru8`` render
reads.  Instances are pre-transformed to world space, one SAH BVH is built
over all world triangles (``surf_tpu.accel.builder.build_blas`` with
min_leaf=4, max_leaf=8), and its leaf order is packed into the dense leaf
table of ``surf_tpu.accel.wide.build_leaf_table`` — both JAX-free modules
of the reference package, imported rather than copied so the two packages
traverse the same table.

``from_render_scene`` takes the JAX package's ``RenderScene`` leaves,
handed over as NumPy arrays, and produces the same ``TorchScene``: the
state carried across the two packages in tests.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from surf_tpu.accel import builder
from surf_tpu.accel.wide import build_leaf_table

from .material import build_material_table
from .scene import Scene


class LeafTrace(NamedTuple):
    """The dense leaf table the bits traversal reads (accel/bits.py)."""

    ltab: torch.Tensor    # [E, 128] f32: 8 triangles per row, 16 lanes each
    box_lo: torch.Tensor  # [3, EB] f32: leaf-row boxes, then 8-ary levels
    box_hi: torch.Tensor  # [3, EB] f32
    anc: torch.Tensor     # [L, MAXD] int32: each leaf row's box chain
    inert_row: int        # an all-zero row (ltab.shape[0] - 1): list padding


class TorchScene(NamedTuple):
    """Flattened scene on one device (the fields of RenderScene that the
    render reads).  Leaf-order arrays are indexed by traversal slot;
    ``samp_*`` are in the original instance-contiguous order."""

    trace: LeafTrace
    perm: torch.Tensor             # [T] int32 leaf slot -> original tri id
    tri_inst: torch.Tensor         # [T] int32 leaf-ordered instance id
    samp_v0: torch.Tensor          # [T, 3] world-space vertices
    samp_v1: torch.Tensor
    samp_v2: torch.Tensor
    samp_n0: torch.Tensor          # [T, 3] world normals (M @ n, unnormalized)
    samp_n1: torch.Tensor
    samp_n2: torch.Tensor
    inst_tri_offset: torch.Tensor  # [I] int32 into samp_*
    inst_tri_count: torch.Tensor   # [I] int32
    inst_area: torch.Tensor        # [I] f32 transformed surface area
    inst_material: torch.Tensor    # [I] int32
    mat_albedo: torch.Tensor             # [M, 3]
    mat_emission_color: torch.Tensor     # [M, 3]
    mat_absorption: torch.Tensor         # [M, 3]
    mat_emission_strength: torch.Tensor  # [M]
    mat_reflectivity: torch.Tensor       # [M]
    mat_refractivity: torch.Tensor       # [M]
    mat_ior: torch.Tensor                # [M]
    mat_is_light: torch.Tensor           # [M] bool
    light_inst: torch.Tensor       # [max(1, num_lights)] int32 instance ids
    bg_type: int                   # 0 solid / 1 gradient
    bg_color: torch.Tensor         # [3]
    bg_gradient_a: torch.Tensor    # [3]
    bg_gradient_b: torch.Tensor    # [3]
    num_lights: int


# TorchScene field (or LeafTrace field) -> RenderScene / TraceArrays leaf.
_TRACE_KEYS = {"ltab": "wide_ltab", "box_lo": "wide_box_lo",
               "box_hi": "wide_box_hi", "anc": "wide_anc"}


def _dedupe_materials(scene: Scene):
    mats, ids = [], {}
    for inst in scene.instances:
        if id(inst.material) not in ids:
            ids[id(inst.material)] = len(mats)
            mats.append(inst.material)
    inst_material = np.array([ids[id(i.material)] for i in scene.instances], np.int32)
    return mats, inst_material


def scene_arrays(scene: Scene) -> dict[str, np.ndarray]:
    """The NumPy leaves of the compiled scene, keyed by their RenderScene
    (and TraceArrays) names — the same arrays ``HostCompiled`` uploads."""
    mats, inst_material = _dedupe_materials(scene)
    mt = build_material_table(mats)
    w = [inst.world_triangles() for inst in scene.instances]
    samp = [np.concatenate([x[k] for x in w]) for k in range(6)]
    counts = np.asarray([inst.mesh.tri_count for inst in scene.instances], np.int32)
    offsets = np.concatenate([[0], np.cumsum(counts)[:-1]]).astype(np.int32)
    tri_inst = np.repeat(np.arange(len(scene.instances), dtype=np.int32), counts)

    bvh = builder.build_blas(samp[0], samp[1], samp[2],
                             min_leaf=4, max_leaf=8)
    perm = bvh.indices.astype(np.int64)
    lt = build_leaf_table(samp[0][perm], samp[1][perm], samp[2][perm])

    light_inst = np.asarray(scene.light_indices, np.int32)
    if len(light_inst) == 0:
        light_inst = np.zeros(1, np.int32)  # padded; gated by num_lights
    bg = scene.background
    return {
        "wide_ltab": lt.table,
        "wide_box_lo": lt.box_lo.T.copy(),
        "wide_box_hi": lt.box_hi.T.copy(),
        "wide_anc": lt.anc,
        "perm": perm.astype(np.int32),
        "tri_inst": tri_inst[perm],
        "samp_v0": samp[0], "samp_v1": samp[1], "samp_v2": samp[2],
        "samp_n0": samp[3], "samp_n1": samp[4], "samp_n2": samp[5],
        "inst_tri_offset": offsets,
        "inst_tri_count": counts,
        "inst_area": np.array([i.area for i in scene.instances], np.float32),
        "inst_material": inst_material,
        "mat_albedo": mt.albedo,
        "mat_emission_color": mt.emission_color,
        "mat_absorption": mt.absorption,
        "mat_emission_strength": mt.emission_strength,
        "mat_reflectivity": mt.reflectivity,
        "mat_refractivity": mt.refractivity,
        "mat_ior": mt.ior,
        "mat_is_light": mt.is_light,
        "light_inst": light_inst,
        "bg_type": np.int32(bg.type),
        "bg_color": bg.color,
        "bg_gradient_a": bg.gradient_a,
        "bg_gradient_b": bg.gradient_b,
    }


def from_render_scene(arrays: dict[str, np.ndarray],
                      device: torch.device) -> TorchScene:
    """Build a TorchScene on ``device`` from RenderScene leaves given as
    NumPy arrays (keys: RenderScene field names, plus the TraceArrays names
    ``wide_ltab``, ``wide_box_lo``, ``wide_box_hi``, ``wide_anc``).  Extra
    keys are ignored.  The light count is the number of ``light_inst``
    entries whose material emits (a scene without lights pads one)."""

    def put(key):
        return torch.tensor(np.asarray(arrays[key]), device=device)

    ltab = put("wide_ltab")
    trace = LeafTrace(inert_row=int(ltab.shape[0]) - 1, ltab=ltab,
                      **{k: put(v) for k, v in _TRACE_KEYS.items() if k != "ltab"})
    light_mat = np.asarray(arrays["inst_material"])[np.asarray(arrays["light_inst"])]
    num_lights = int(np.asarray(arrays["mat_is_light"])[light_mat].sum())
    fields = {f: put(f) for f in TorchScene._fields
              if f not in ("trace", "bg_type", "num_lights")}
    return TorchScene(trace=trace, bg_type=int(arrays["bg_type"]),
                      num_lights=num_lights, **fields)


def compile_scene(scene: Scene, device: torch.device) -> TorchScene:
    """Flatten ``scene`` and upload it to ``device``."""
    return from_render_scene(scene_arrays(scene), device)
