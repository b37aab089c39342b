"""Declarative JSON scene files (port of ``surf_tpu.scene.loader``, built
on the port's own scene layer).

The reference hard-codes its scene in main.cpp (SURVEY.md §2 'Entry point /
test scene' row prescribes a data-driven scene module);
this loader makes arbitrary scenes constructible without code:

{
  "meshes": {
    "monkey": "assets/susanne.obj",
    "box":    {"procedural": "cube"},
    "ball":   {"procedural": "icosphere", "subdivisions": 3}
  },
  "materials": {
    "red":   {"albedo": [1, 0, 0]},
    "glass": {"albedo": [0.7, 0.7, 0.2], "refractivity": 1.0,
              "index_of_refraction": 1.42, "absorption": [0.03, 0.04, 0.03]},
    "lamp":  {"emission_color": [1, 0.8, 0.6], "emission_strength": 5.0}
  },
  "instances": [
    {"mesh": "box", "material": "lamp",
     "transform": [["translate", [-8, 7, 5]], ["scale", [0.5, 0.5, 0.5]]]}
  ],
  "background": {"type": "gradient", "a": [0.8, 0.8, 0.8], "b": [0.1, 0.4, 0.6]},
  "camera": {"position": [0, 0, -7], "target": [0, 0, 0], "fov_y": 70,
             "focal_length": 7, "defocus_angle": 0.5}
}

Transforms compose left-to-right like the glm chains in main.cpp
(translate -> rotate -> scale == T @ R @ S).
"""

from __future__ import annotations

import json
import os

import numpy as np

from ..core import transform as tf
from .camera import Camera
from .instance import Instance
from .material import Material
from .mesh import Mesh, make_cube, make_icosphere, make_plane
from .scene import BG_GRADIENT, BG_SOLID, Scene, SceneBackground


def _build_mesh(spec, base_dir: str) -> Mesh:
    if isinstance(spec, str):
        path = spec if os.path.isabs(spec) else os.path.join(base_dir, spec)
        return Mesh.from_obj(path)
    kind = spec["procedural"]
    if kind == "cube":
        return make_cube()
    if kind == "plane":
        return make_plane()
    if kind == "icosphere":
        return make_icosphere(
            spec.get("subdivisions", 2), spec.get("radius", 1.0)
        )
    raise ValueError(f"unknown procedural mesh: {kind}")


def _build_transform(ops) -> np.ndarray:
    m = tf.identity()
    for op in ops or []:
        name, arg = op[0], op[1]
        if name == "translate":
            m = tf.translate(m, arg)
        elif name == "scale":
            m = tf.scale(m, arg if isinstance(arg, list) else [arg] * 3)
        elif name == "rotate":
            # ["rotate", [degrees, axis_xyz]]
            deg, axis = arg
            m = tf.rotate(m, float(np.radians(deg)), axis)
        else:
            raise ValueError(f"unknown transform op: {name}")
    return m


def load_scene_file(path: str):
    """Returns (Scene, camera_spec | None)."""
    with open(path) as fh:
        doc = json.load(fh)
    base_dir = os.path.dirname(os.path.abspath(path))

    meshes = {k: _build_mesh(v, base_dir) for k, v in doc["meshes"].items()}
    materials = {k: Material(**v) for k, v in doc["materials"].items()}
    instances = [
        Instance(
            meshes[e["mesh"]], materials[e["material"]],
            _build_transform(e.get("transform")),
        )
        for e in doc["instances"]
    ]

    bg_doc = doc.get("background", {})
    if bg_doc.get("type") == "gradient":
        bg = SceneBackground(
            type=BG_GRADIENT,
            gradient_a=bg_doc.get("a", [0, 0, 0]),
            gradient_b=bg_doc.get("b", [0, 0, 0]),
        )
    else:
        bg = SceneBackground(type=BG_SOLID, color=bg_doc.get("color", [0, 0, 0]))

    return Scene(bg, instances), doc.get("camera")


def camera_from_spec(spec, width: int, height: int) -> Camera:
    return Camera(
        position=spec.get("position", [0, 0, -7]),
        target=spec.get("target", [0, 0, 0]),
        screen_width=width,
        screen_height=height,
        fov_y=spec.get("fov_y", 70.0),
        focal_length=spec.get("focal_length", 1.5),
        defocus_angle=spec.get("defocus_angle", 0.0),
    )
