"""Scene compiler: host Scene -> a scene on a device, kept up to date as
the scene animates.

``HostCompiled`` is the port of ``surf_tpu.scene.compile.HostCompiled``:
it keeps the host arrays, so an animation step re-transforms only the
moved instances' triangles and then refits the BVH (or rebuilds it), and
it uploads only the arrays that changed.  Its ``scene`` is one of three
scene types on one device:

- flattened (``TorchScene``, compile.py:131-176, 282-429): instances are
  pre-transformed to world space and one SAH BVH is built over all world
  triangles (``accel.builder.build_blas`` with min_leaf=4, max_leaf=8).
  The one tree feeds three layouts, one per traversal: the dense leaf
  table of the ``bits*`` algos (``accel.wide.build_leaf_table``, with its
  Baldwin–Weber twin for ``bitsw``), the 8-wide DFS
  stream of ``skip`` / ``stack`` (``accel.wide.build_wide_stream``) and
  the skip-link node list of the binary walk (``accel.skiplinks``).  The
  stream and node list are padded to JAX's sticky capacity classes, so a
  rebuild gives arrays of the first compile's shapes;
- hybrid two-level (``HybridScene``, ``two_level=True``, compile.py:469-521):
  a flattened scene plus the shared per-mesh object-space tables and
  per-instance transforms of ``accel.instanced``, and the map from an
  (instance, mesh-local leaf slot) winner back to the flattened leaf slot,
  so ``algo="twolevel"`` traverses the two levels and shades, samples
  lights and differentiates as the flattened scene does.  It is a third
  type rather than optional fields of ``TorchScene``, so a flattened scene
  has no fields that are None;
- pure two-level (``PureScene``, ``two_level="pure"``, compile.py:177-280):
  one object-space leaf table per unique mesh plus per-instance transforms
  (``accel.instanced``), and the shading set in object space, so device
  memory is O(unique mesh triangles); no flattened table and no world-space
  triangle arrays are built.  A refresh moves only the per-instance arrays.

``from_render_scene`` takes the JAX package's ``RenderScene`` leaves,
handed over as NumPy arrays under their JAX names (and, for the two-level
scenes, its ``InstancedMeta`` as a plain tuple), and produces the same
scene: the state carried across the two packages in tests.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..accel.bits import LeafTrace
from ..accel.builder import build_blas, refit, triangle_bounds
from ..accel.bvh_walk import BinaryTrace
from ..accel.instanced import (InstancedMeta, InstancedTrace,
                               build_instanced_trace, make_trace)
from ..accel.skiplinks import (build_skiplinks, bvh_max_depth, pack_trace_tables,
                               skiplink_boxes)
from ..accel.stream import StreamTrace
from ..accel.wide import (build_leaf_table, build_wide_stream, pad_wide_stream,
                          refit_wide_stream, stream_depth)
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



# A flattened scene plus the two-level tables (see the module docstring).
HybridScene = NamedTuple("HybridScene", [
    *TorchScene.__annotations__.items(),
    ("inst", InstancedTrace),            # two-level tables + meta (accel/instanced)
    ("inst_prim_map", torch.Tensor),     # [sum of instance tris] int32 -> flattened leaf slot
    ("inst_prim_base", torch.Tensor),    # [I] int32 instance's first inst_prim_map entry
])


# TorchScene field (or LeafTrace field) -> RenderScene / TraceArrays leaf.
_TRACE_KEYS = {"ltab": "wide_ltab", "ltabw": "wide_ltabw",
               "box_lo": "wide_box_lo", "box_hi": "wide_box_hi",
               "anc": "wide_anc"}
# InstancedTrace field -> two-level RenderScene TraceArrays leaf.
_INST_KEYS = {"ltab": "inst_ltab", "box_lo": "inst_box_lo",
              "box_hi": "inst_box_hi", "inv": "inst_inv",
              "inst_lo": "inst_wlo", "inst_hi": "inst_whi"}
_SCALARS = ("bg_type", "num_lights")
_TRACES = ("trace", "stream", "binary")
_SAMP = ("samp_v0", "samp_v1", "samp_v2", "samp_n0", "samp_n1", "samp_n2")
# The leaves a refit uploads again; every other tensor of the scene is kept.
_REFIT_KEYS = ("wide_ltab", "wide_ltabw", "wide_box_lo", "wide_box_hi", "wide_stream",
               "nodes_packed", "tris_packed", *_SAMP, "inst_area")


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


def _instance_arrays(scene: Scene) -> dict[str, np.ndarray]:
    """The per-instance arrays a two-level refresh re-derives: inverse
    3x4 rows [I, 12] (inverted in float64), world AABBs [3, I], forward
    3x4 rows [I, 12] and transformed areas [I]."""
    insts = scene.instances
    return {
        "inst_inv": np.stack([i.inv_transform[:3, :4].reshape(12) for i in insts]),
        "inst_wlo": np.stack([i.bounds_min for i in insts]).T.copy(),
        "inst_whi": np.stack([i.bounds_max for i in insts]).T.copy(),
        "inst_fwd": np.stack([i.transform[:3, :4].reshape(12)
                              for i in insts]).astype(np.float32),
        "inst_area": np.array([i.area for i in insts], np.float32),
    }


class HostCompiled:
    """A scene compiled onto ``device`` that follows the host scene's
    animation (compile.py:186-597).  ``scene`` is the device scene
    (``TorchScene``, ``HybridScene`` with ``two_level=True``, or
    ``PureScene`` with ``two_level="pure"``); ``host_scene`` the host
    Scene; ``arrays`` the NumPy leaves of the last upload under their
    RenderScene names.  ``update(dt)`` advances the host scene's animation
    and refreshes; ``refresh()`` picks up instances moved by hand
    (``Instance.set_transform``).  A flattened scene is refit by default:
    the skip-link order and meta are kept, the stream is refit in place,
    the leaf table is rebuilt whole, and only the changed arrays are
    uploaded (the material table, lanes' maps and topology tensors keep
    their tensors); ``rebuild=True`` runs the SAH build again, padded to
    the sticky capacities of first use.  A two-level scene's per-instance
    transforms and world boxes are re-derived on every refresh; the
    hybrid map is re-derived after every rebuild (``perm`` changes)."""

    def __init__(self, scene: Scene, device: torch.device,
                 two_level: bool | str = False, inst_cap: int | None = None):
        if two_level not in (False, True, "pure"):
            raise ValueError(f"two_level must be False, True or 'pure', not {two_level!r}")
        self.host_scene = scene
        self.device = device
        self.pure = two_level == "pure"
        self.two_level = bool(two_level)
        if self.pure:
            self.arrays, self.inst_meta = pure_scene_arrays(scene, inst_cap)
            self.scene = from_render_scene(self.arrays, device, self.inst_meta)
            return
        w = [inst.world_triangles() for inst in scene.instances]
        self.samp = [np.concatenate([x[k] for x in w]) for k in range(6)]
        self.inst_tri_count = np.asarray([i.mesh.tri_count for i in scene.instances],
                                         np.int32)
        self.inst_tri_offset = np.concatenate(
            [[0], np.cumsum(self.inst_tri_count)[:-1]]).astype(np.int32)
        self.tri_inst = np.repeat(np.arange(len(scene.instances), dtype=np.int32),
                                  self.inst_tri_count)
        self._shared = _shared_arrays(scene)
        self._versions = [inst.version for inst in scene.instances]
        self._caps: dict[str, int] = {}
        self._inst_host = None  # the hybrid's mesh-level build, cached
        self._rebuild()

    def _put(self, a: np.ndarray) -> torch.Tensor:
        return torch.tensor(np.asarray(a), device=self.device)

    def _cap(self, name: str, n: int, quantum: int = 1024) -> int:
        """JAX's sticky capacity class (compile.py:282-292): n plus 12.5%
        headroom rounded up to the quantum on first use, kept until n
        exceeds it."""
        c = self._caps.get(name, 0)
        if n > c:
            c = -(-int(n * 1.125 + 1) // quantum) * quantum
            self._caps[name] = c
        return c

    def _pad_node_boxes(self, boxes: np.ndarray) -> np.ndarray:
        """Skip-link boxes padded with NaN rows (never hit) to the node
        capacity."""
        out = np.full((self._cap("nodes", len(boxes)), 6), np.nan, np.float32)
        out[:len(boxes)] = boxes
        return out

    def _rebuild(self) -> None:
        self.bvh = build_blas(*self.samp[:3], min_leaf=4, max_leaf=8)
        boxes, meta, self._skip_order = build_skiplinks(self.bvh, return_order=True)
        # a pad node's skip jumps to the end, so a packet reaching it pays
        # one visit (compile.py:335-346)
        node_meta = np.zeros((self._cap("nodes", len(meta)), 3), np.int32)
        node_meta[:, 2] = len(node_meta)
        node_meta[:len(meta)] = meta
        perm = self.bvh.indices.astype(np.int64)
        tv = [x[perm] for x in self.samp[:3]]
        ws = build_wide_stream(self.bvh, *tv)
        self._ws = pad_wide_stream(ws, self._cap("stream_rows", ws.stream.shape[0]))
        self.stack_depth = self._cap("stack_depth", bvh_max_depth(self.bvh) + 2, quantum=8)
        self.arrays = {
            **self._tables(tv, self._pad_node_boxes(boxes), node_meta),
            "wide_rec_slot": self._ws.rec_slot,
            "node_meta": node_meta,
            "perm": perm.astype(np.int32),
            "tri_inst": self.tri_inst[perm],
            "inst_tri_offset": self.inst_tri_offset,
            "inst_tri_count": self.inst_tri_count,
            **self._shared,
            **self._moving(),
        }
        self.scene = from_render_scene(self.arrays, self.device)
        if self.two_level:
            self._attach_instanced(perm)

    def _tables(self, tv, node_boxes, node_meta) -> dict[str, np.ndarray]:
        """The traversal tables of leaf-ordered triangles ``tv``: the leaf
        table (rebuilt whole: vectorised packing), the stream and the
        packed node list."""
        lt = build_leaf_table(*tv)
        nodes_packed, tris_packed = pack_trace_tables(*tv, node_boxes, node_meta)
        return {"wide_ltab": lt.table, "wide_ltabw": lt.tablew,
                "wide_box_lo": lt.box_lo.T.copy(), "wide_box_hi": lt.box_hi.T.copy(),
                "wide_anc": lt.anc, "wide_stream": self._ws.stream, "node_boxes": node_boxes,
                "nodes_packed": nodes_packed, "tris_packed": tris_packed}

    def _moving(self) -> dict[str, np.ndarray]:
        """The world-space sampling set and the instances' areas."""
        return {**dict(zip(_SAMP, self.samp)),
                "inst_area": np.array([i.area for i in self.host_scene.instances],
                                      np.float32)}

    def _refit(self) -> None:
        """compile.py:320-395: refit the tree, re-gather the skip-link boxes
        in the kept order, refit the stream in place, rebuild the leaf
        table, and upload the changed leaves only."""
        self.bvh = refit(self.bvh, *triangle_bounds(*self.samp[:3]))
        perm = self.bvh.indices.astype(np.int64)
        tv = [x[perm] for x in self.samp[:3]]
        self._ws = refit_wide_stream(self._ws, self.bvh, *tv)
        node_boxes = self._pad_node_boxes(skiplink_boxes(self.bvh, self._skip_order))
        new = {**self._tables(tv, node_boxes, self.arrays["node_meta"]), **self._moving()}
        self.arrays.update(new)
        t = {k: self._put(new[k]) for k in _REFIT_KEYS}
        ts = self.scene
        self.scene = ts._replace(
            trace=ts.trace._replace(**{f: t[k] for f, k in _TRACE_KEYS.items() if k in t}),
            stream=ts.stream._replace(stream=t["wide_stream"]),
            binary=ts.binary._replace(nodes=t["nodes_packed"], tris=t["tris_packed"]),
            **{k: t[k] for k in (*_SAMP, "inst_area")})
        if self.two_level:
            self._refresh_instanced_xf()

    def _attach_instanced(self, perm: np.ndarray) -> None:
        """The hybrid tables (compile.py:469-521): the mesh-level build
        (shared BLASes, caps, per-mesh leaf orders) is made once; the map
        from each (instance, mesh-local leaf slot) to the flattened leaf
        slot is re-derived from ``perm``, and the per-instance transforms
        and world boxes from the instances' current state."""
        if self._inst_host is None:
            mesh_ids: dict[int, int] = {}
            meshes, insts = [], []
            for inst in self.host_scene.instances:
                if id(inst.mesh) not in mesh_ids:
                    mesh_ids[id(inst.mesh)] = len(meshes)
                    meshes.append((inst.mesh.v0, inst.mesh.v1, inst.mesh.v2))
                insts.append((mesh_ids[id(inst.mesh)], inst.inv_transform,
                              inst.bounds_min, inst.bounds_max))
            self._inst_host = build_instanced_trace(meshes, insts, self.device)
        ih = self._inst_host
        meta = ih.trace.meta
        inv_perm = np.zeros(len(perm), np.int64)
        inv_perm[perm] = np.arange(len(perm))
        prim_map = np.concatenate([inv_perm[self.inst_tri_offset[i] + ih.perms[m]]
                                   for i, m in enumerate(meta.mesh_of)]).astype(np.int32)
        prim_base = np.concatenate(
            [[0], np.cumsum([len(ih.perms[m]) for m in meta.mesh_of])])[:-1].astype(np.int32)
        self.inst_meta = tuple(meta)
        self.arrays.update({jax_key: getattr(ih.trace, f).cpu().numpy()
                            for f, jax_key in _INST_KEYS.items()})
        self.arrays.update(inst_prim_map=prim_map, inst_prim_base=prim_base)
        self.scene = HybridScene(*self.scene, inst=ih.trace,
                                 inst_prim_map=self._put(prim_map),
                                 inst_prim_base=self._put(prim_base))
        self._refresh_instanced_xf()

    def _refresh_instanced_xf(self) -> None:
        """compile.py:523-550 (and the pure refresh, :565-577): the
        per-instance inverse transforms and world AABBs from the instances'
        current state, and for a pure scene the forward transforms and the
        areas; the shared per-mesh tables keep their tensors."""
        a = _instance_arrays(self.host_scene)
        if not self.pure:  # the flattened refit uploaded the areas
            del a["inst_fwd"], a["inst_area"]
        self.arrays.update(a)
        ts = self.scene
        inst = ts.inst._replace(inv=self._put(a["inst_inv"]), inst_lo=self._put(a["inst_wlo"]),
                                inst_hi=self._put(a["inst_whi"]))
        extra = {k: self._put(a[k]) for k in ("inst_fwd", "inst_area")} if self.pure else {}
        self.scene = ts._replace(inst=inst, **extra)

    def update(self, delta_time: float, rebuild: bool = False) -> None:
        """Advance the host scene's animation by ``delta_time`` and refresh
        (``rebuild=True``: a full SAH rebuild, BASELINE config 4)."""
        self.host_scene.update(delta_time)
        self.refresh(rebuild=rebuild)

    def refresh(self, rebuild: bool = False) -> None:
        """Re-transform the triangles of the instances whose ``version``
        moved since the last refresh, then refit or rebuild.  A pure scene
        re-derives its per-instance arrays only (``rebuild`` does not
        apply)."""
        if self.pure:
            self._refresh_instanced_xf()
            return
        for i, inst in enumerate(self.host_scene.instances):
            if inst.version == self._versions[i]:
                continue
            self._versions[i] = inst.version
            o, c = self.inst_tri_offset[i], self.inst_tri_count[i]
            for dst, src in zip(self.samp, inst.world_triangles()):
                dst[o:o + c] = src
        if rebuild:
            self._rebuild()
        else:
            self._refit()


def scene_arrays(scene: Scene) -> dict[str, np.ndarray]:
    """The NumPy leaves of the flattened compile, keyed by their
    RenderScene (and TraceArrays) names — the arrays ``HostCompiled``
    uploads."""
    return HostCompiled(scene, torch.device("cpu")).arrays


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
        "inst_fwd": _instance_arrays(scene)["inst_fwd"],
        "inst_tri_offset": inst_obj_base,
        "inst_tri_count": np.asarray([inst.mesh.tri_count for inst in scene.instances],
                                     np.int32),
        **_shared_arrays(scene),
    })
    return out, tuple(ih.trace.meta)


def from_render_scene(arrays: dict[str, np.ndarray], device: torch.device,
                      inst_meta: tuple | None = None) -> TorchScene | HybridScene | PureScene:
    """Build a scene on ``device`` from RenderScene leaves given as NumPy
    arrays, keyed by their JAX names; extra keys are ignored.  Without
    ``inst_meta`` the leaves are the flattened compile's (plus the
    TraceArrays names ``wide_ltab``, ``wide_ltabw``, ``wide_box_lo``, ``wide_box_hi``,
    ``wide_anc``, ``wide_stream``, ``wide_rec_slot``, ``node_boxes``,
    ``nodes_packed``, ``tris_packed``) and the result is a TorchScene; the
    stream's depth is read from the stream.  With ``inst_meta`` (the
    fields of ``InstancedMeta`` as a plain tuple) and ``inst_prim_map``
    among the leaves they are the hybrid compile's (the flattened leaves,
    ``inst_ltab``, ``inst_box_lo``, ``inst_box_hi``, ``inst_inv``,
    ``inst_wlo``, ``inst_whi``, ``inst_prim_map``, ``inst_prim_base``) and
    the result is a HybridScene; without ``inst_prim_map`` they are the
    pure compile's (those ``inst_*`` tables, ``inst_obj_base``,
    ``inst_slot_perm``, ``obj_*``, ``inst_fwd`` ...) and the result is a
    PureScene.  The light count is the number of ``light_inst`` entries
    whose material emits (a scene without lights pads one)."""

    def put(key):
        return torch.tensor(np.asarray(arrays[key]), device=device)

    light_mat = np.asarray(arrays["inst_material"])[np.asarray(arrays["light_inst"])]
    scalars = {"bg_type": int(arrays["bg_type"]),
               "num_lights": int(np.asarray(arrays["mat_is_light"])[light_mat].sum())}
    inst = None if inst_meta is None else make_trace(
        *(arrays[v] for v in _INST_KEYS.values()), InstancedMeta(*inst_meta), device)
    if inst is not None and "inst_prim_map" not in arrays:
        fields = {f: put(f) for f in PureScene._fields if f not in ("inst", *_SCALARS)}
        return PureScene(inst=inst, **scalars, **fields)
    ltab = put("wide_ltab")
    trace = LeafTrace(inert_row=int(ltab.shape[0]) - 1, ltab=ltab,
                      **{k: put(v) for k, v in _TRACE_KEYS.items() if k != "ltab"})
    stream = StreamTrace(put("wide_stream"), put("wide_rec_slot"),
                         stream_depth(np.asarray(arrays["wide_stream"])))
    binary = BinaryTrace(put("nodes_packed"), put("tris_packed"),
                         int(np.asarray(arrays["node_boxes"]).shape[0]))
    fields = {f: put(f) for f in TorchScene._fields if f not in (*_TRACES, *_SCALARS)}
    ts = TorchScene(trace=trace, stream=stream, binary=binary, **scalars, **fields)
    if inst is None:
        return ts
    return HybridScene(*ts, inst=inst, inst_prim_map=put("inst_prim_map"),
                       inst_prim_base=put("inst_prim_base"))


def compile_scene(scene: Scene, device: torch.device,
                  two_level: bool | str = False,
                  inst_cap: int | None = None) -> TorchScene | HybridScene | PureScene:
    """Compile ``scene`` and upload it to ``device``: flattened by default,
    hybrid two-level with ``two_level=True``, pure two-level with
    ``two_level="pure"`` (``inst_cap`` as in ``pure_scene_arrays``).  To
    animate the scene, keep the ``HostCompiled``."""
    return HostCompiled(scene, device, two_level, inst_cap).scene
