"""Scene compiler: host Scene -> a scene on a device.

Two compiles, ports of the two branches of
``surf_tpu.scene.compile.HostCompiled`` that the render reads:

- flattened (``TorchScene``, compile.py:131-176, 282-429): instances are
  pre-transformed to world space and one SAH BVH is built over all world
  triangles (``accel.builder.build_blas`` with min_leaf=4, max_leaf=8).
  The one tree feeds three layouts, one per traversal: the dense leaf
  table of the ``bits*`` algos (``accel.wide.build_leaf_table``, with its
  Baldwin–Weber twin for ``bitsw``), the 8-wide DFS
  stream of ``skip`` / ``stack`` (``accel.wide.build_wide_stream``) and
  the skip-link node list of the binary walk (``accel.skiplinks``).  The
  stream and node list are padded to JAX's capacity classes;
- pure two-level (``PureScene``, ``two_level="pure"``, compile.py:177-280):
  one object-space leaf table per unique mesh plus per-instance transforms
  (``accel.instanced``), and the shading set in object space, so device
  memory is O(unique mesh triangles); no flattened table and no world-space
  triangle arrays are built.

``from_render_scene`` takes the JAX package's ``RenderScene`` leaves,
handed over as NumPy arrays under their JAX names (and, for the pure
compile, its ``InstancedMeta`` as a plain tuple), and produces the same
scene: the state carried across the two packages in tests.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..accel.bits import LeafTrace
from ..accel.builder import build_blas
from ..accel.bvh_walk import BinaryTrace
from ..accel.instanced import (InstancedMeta, InstancedTrace,
                               build_instanced_trace, make_trace)
from ..accel.skiplinks import build_skiplinks, pack_trace_tables
from ..accel.stream import StreamTrace
from ..accel.wide import (build_leaf_table, build_wide_stream, pad_wide_stream,
                          stream_depth)
from .material import build_material_table
from .scene import Scene


class TorchScene(NamedTuple):
    """Flattened scene on one device (the fields of RenderScene that the
    render reads).  Leaf-order arrays are indexed by traversal slot;
    ``samp_*`` are in the original instance-contiguous order."""

    trace: LeafTrace               # the bits* algos
    stream: StreamTrace            # skip / stack
    binary: BinaryTrace            # the binary walk (use_wide=False)
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


class PureScene(NamedTuple):
    """Pure two-level scene on one device (the fields of the pure
    RenderScene that the ``twolevelp`` render reads).  ``obj_*`` hold every
    unique mesh once, in object space and original triangle order,
    concatenated per mesh; instance i's triangles start at
    ``inst_obj_base[i]``."""

    inst: InstancedTrace           # two-level tables + meta (accel/instanced)
    inst_obj_base: torch.Tensor    # [I] int32 first obj_* row of the mesh
    inst_slot_perm: torch.Tensor   # [Tu] int32 mesh-local leaf slot -> original id
    obj_v0: torch.Tensor           # [Tu, 3] object-space vertices
    obj_v1: torch.Tensor
    obj_v2: torch.Tensor
    obj_n0: torch.Tensor           # [Tu, 3] object-space normals
    obj_n1: torch.Tensor
    obj_n2: torch.Tensor
    inst_fwd: torch.Tensor         # [I, 12] forward 3x4 rows (affine)
    inst_tri_offset: torch.Tensor  # [I] int32 into obj_* (= inst_obj_base)
    inst_tri_count: torch.Tensor   # [I] int32
    inst_area: torch.Tensor        # [I] f32 transformed surface area
    inst_material: torch.Tensor    # [I] int32
    mat_albedo: torch.Tensor
    mat_emission_color: torch.Tensor
    mat_absorption: torch.Tensor
    mat_emission_strength: torch.Tensor
    mat_reflectivity: torch.Tensor
    mat_refractivity: torch.Tensor
    mat_ior: torch.Tensor
    mat_is_light: torch.Tensor
    light_inst: torch.Tensor
    bg_type: int
    bg_color: torch.Tensor
    bg_gradient_a: torch.Tensor
    bg_gradient_b: torch.Tensor
    num_lights: int


# TorchScene field (or LeafTrace field) -> RenderScene / TraceArrays leaf.
_TRACE_KEYS = {"ltab": "wide_ltab", "ltabw": "wide_ltabw",
               "box_lo": "wide_box_lo", "box_hi": "wide_box_hi",
               "anc": "wide_anc"}
# InstancedTrace field -> pure RenderScene TraceArrays leaf.
_INST_KEYS = {"ltab": "inst_ltab", "box_lo": "inst_box_lo",
              "box_hi": "inst_box_hi", "inv": "inst_inv",
              "inst_lo": "inst_wlo", "inst_hi": "inst_whi"}
_SCALARS = ("bg_type", "num_lights")
_TRACES = ("trace", "stream", "binary")


def _capacity(n: int, quantum: int = 1024) -> int:
    """JAX's sticky capacity class on first use (compile.py:282-292): n
    plus 12.5% headroom, rounded up to the quantum."""
    return -(-int(n * 1.125 + 1) // quantum) * quantum


def _dedupe_materials(scene: Scene):
    mats, ids = [], {}
    for inst in scene.instances:
        if id(inst.material) not in ids:
            ids[id(inst.material)] = len(mats)
            mats.append(inst.material)
    inst_material = np.array([ids[id(i.material)] for i in scene.instances], np.int32)
    return mats, inst_material


def _shared_arrays(scene: Scene) -> dict[str, np.ndarray]:
    """Materials, lights, background and per-instance areas: the leaves
    both compiles share."""
    mats, inst_material = _dedupe_materials(scene)
    mt = build_material_table(mats)
    light_inst = np.asarray(scene.light_indices, np.int32)
    if len(light_inst) == 0:
        light_inst = np.zeros(1, np.int32)  # padded; gated by num_lights
    bg = scene.background
    return {
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


def scene_arrays(scene: Scene) -> dict[str, np.ndarray]:
    """The NumPy leaves of the flattened compile, keyed by their
    RenderScene (and TraceArrays) names — the same arrays ``HostCompiled``
    uploads."""
    w = [inst.world_triangles() for inst in scene.instances]
    samp = [np.concatenate([x[k] for x in w]) for k in range(6)]
    counts = np.asarray([inst.mesh.tri_count for inst in scene.instances], np.int32)
    offsets = np.concatenate([[0], np.cumsum(counts)[:-1]]).astype(np.int32)
    tri_inst = np.repeat(np.arange(len(scene.instances), dtype=np.int32), counts)

    bvh = build_blas(samp[0], samp[1], samp[2], min_leaf=4, max_leaf=8)
    perm = bvh.indices.astype(np.int64)
    tv = [x[perm] for x in samp[:3]]
    lt = build_leaf_table(*tv)
    ws = build_wide_stream(bvh, *tv)
    ws = pad_wide_stream(ws, _capacity(ws.stream.shape[0]))
    boxes, meta = build_skiplinks(bvh)
    # Capacity padding (compile.py:335-346): NaN boxes never hit, and a pad
    # node's skip jumps to the end, so a packet reaching it pays one visit.
    d_cap = _capacity(len(meta))
    node_boxes = np.full((d_cap, 6), np.nan, np.float32)
    node_boxes[:len(boxes)] = boxes
    node_meta = np.zeros((d_cap, 3), np.int32)
    node_meta[:, 2] = d_cap
    node_meta[:len(meta)] = meta
    nodes_packed, tris_packed = pack_trace_tables(*tv, node_boxes, node_meta)
    return {
        "wide_stream": ws.stream,
        "wide_rec_slot": ws.rec_slot,
        "node_boxes": node_boxes,
        "node_meta": node_meta,
        "nodes_packed": nodes_packed,
        "tris_packed": tris_packed,
        "wide_ltab": lt.table,
        "wide_ltabw": lt.tablew,
        "wide_box_lo": lt.box_lo.T.copy(),
        "wide_box_hi": lt.box_hi.T.copy(),
        "wide_anc": lt.anc,
        "perm": perm.astype(np.int32),
        "tri_inst": tri_inst[perm],
        "samp_v0": samp[0], "samp_v1": samp[1], "samp_v2": samp[2],
        "samp_n0": samp[3], "samp_n1": samp[4], "samp_n2": samp[5],
        "inst_tri_offset": offsets,
        "inst_tri_count": counts,
        **_shared_arrays(scene),
    }


def pure_scene_arrays(scene: Scene, inst_cap: int | None = None):
    """The NumPy leaves of the pure two-level compile under their pure
    RenderScene names (the [I, 12] inverse transforms as ``inst_inv``), and
    its ``InstancedMeta`` as a plain tuple — what ``HostCompiled(scene,
    two_level="pure", inst_cap=inst_cap)`` builds.  ``inst_cap`` bounds each
    (packet, instance) candidate list (default 512 rows)."""
    mesh_ids: dict[int, int] = {}
    meshes, insts = [], []
    for inst in scene.instances:
        if not np.allclose(inst.transform[3], [0, 0, 0, 1]):
            raise ValueError("the pure two-level compile needs affine "
                             "instance transforms (last row 0, 0, 0, 1)")
        if id(inst.mesh) not in mesh_ids:
            mesh_ids[id(inst.mesh)] = len(meshes)
            meshes.append(inst.mesh)
        insts.append((mesh_ids[id(inst.mesh)], inst.inv_transform,
                      inst.bounds_min, inst.bounds_max))
    kw = {} if inst_cap is None else {"cap_per_inst": inst_cap}
    ih = build_instanced_trace([(m.v0, m.v1, m.v2) for m in meshes], insts,
                               torch.device("cpu"), **kw)
    base = np.concatenate([[0], np.cumsum([m.tri_count for m in meshes])])
    inst_obj_base = np.asarray([base[mi] for mi, *_ in insts], np.int32)
    out = {jax_key: getattr(ih.trace, f).numpy() for f, jax_key in _INST_KEYS.items()}
    out.update({f"obj_{f}": np.concatenate([getattr(m, f) for m in meshes])
                for f in ("v0", "v1", "v2", "n0", "n1", "n2")})
    out.update({
        "inst_obj_base": inst_obj_base,
        "inst_slot_perm": np.concatenate(ih.perms).astype(np.int32),
        "inst_fwd": np.stack([inst.transform[:3, :4].reshape(12)
                              for inst in scene.instances]).astype(np.float32),
        "inst_tri_offset": inst_obj_base,
        "inst_tri_count": np.asarray([inst.mesh.tri_count for inst in scene.instances],
                                     np.int32),
        **_shared_arrays(scene),
    })
    return out, tuple(ih.trace.meta)


def from_render_scene(arrays: dict[str, np.ndarray], device: torch.device,
                      inst_meta: tuple | None = None) -> TorchScene | PureScene:
    """Build a scene on ``device`` from RenderScene leaves given as NumPy
    arrays, keyed by their JAX names; extra keys are ignored.  Without
    ``inst_meta`` the leaves are the flattened compile's (plus the
    TraceArrays names ``wide_ltab``, ``wide_ltabw``, ``wide_box_lo``, ``wide_box_hi``,
    ``wide_anc``, ``wide_stream``, ``wide_rec_slot``, ``node_boxes``,
    ``nodes_packed``, ``tris_packed``) and the result is a TorchScene; the
    stream's depth is read from the stream.  With ``inst_meta`` (the
    fields of ``InstancedMeta`` as a plain tuple) they are the pure
    compile's (``inst_ltab``, ``inst_box_lo``, ``inst_box_hi``,
    ``inst_inv``, ``inst_wlo``, ``inst_whi``, ``inst_obj_base``,
    ``inst_slot_perm``, ``obj_*``, ``inst_fwd`` ...) and the result is a
    PureScene.  The light count is the number of ``light_inst`` entries
    whose material emits (a scene without lights pads one)."""

    def put(key):
        return torch.tensor(np.asarray(arrays[key]), device=device)

    light_mat = np.asarray(arrays["inst_material"])[np.asarray(arrays["light_inst"])]
    scalars = {"bg_type": int(arrays["bg_type"]),
               "num_lights": int(np.asarray(arrays["mat_is_light"])[light_mat].sum())}
    if inst_meta is None:
        ltab = put("wide_ltab")
        trace = LeafTrace(inert_row=int(ltab.shape[0]) - 1, ltab=ltab,
                          **{k: put(v) for k, v in _TRACE_KEYS.items() if k != "ltab"})
        stream = StreamTrace(put("wide_stream"), put("wide_rec_slot"),
                             stream_depth(np.asarray(arrays["wide_stream"])))
        binary = BinaryTrace(put("nodes_packed"), put("tris_packed"),
                             int(np.asarray(arrays["node_boxes"]).shape[0]))
        fields = {f: put(f) for f in TorchScene._fields
                  if f not in (*_TRACES, *_SCALARS)}
        return TorchScene(trace=trace, stream=stream, binary=binary, **scalars, **fields)
    meta = InstancedMeta(*inst_meta)
    inst = make_trace(*(arrays[v] for v in _INST_KEYS.values()), meta, device)
    fields = {f: put(f) for f in PureScene._fields if f not in ("inst", *_SCALARS)}
    return PureScene(inst=inst, **scalars, **fields)


def compile_scene(scene: Scene, device: torch.device,
                  two_level: bool | str = False,
                  inst_cap: int | None = None) -> TorchScene | PureScene:
    """Compile ``scene`` and upload it to ``device``: flattened by default,
    or pure two-level with ``two_level="pure"`` (``inst_cap`` as in
    ``pure_scene_arrays``).  The hybrid two-level mode of the JAX package
    (``two_level=True``) is not ported."""
    if two_level == "pure":
        arrays, meta = pure_scene_arrays(scene, inst_cap)
        return from_render_scene(arrays, device, meta)
    if two_level is not False:
        raise ValueError(f"two_level must be False or 'pure', not {two_level!r}")
    return from_render_scene(scene_arrays(scene), device)
