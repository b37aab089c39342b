"""Built-in scenes (carried over from ``surf_tpu.scene.builtin``): the
indoor test scene of the reference entry point (main.cpp:141-348), the
diffuse box scene and the instanced stress scene, with their cameras.

Mesh assets come from ``SURF_ASSETS`` or ``<repo>/assets`` when present;
procedural stand-ins (cube / icosphere / flattened icosphere lens) keep the
scene functional when they are absent — geometry then differs but
materials, layout and lights are identical.  The search order is the JAX
package's, less its fixed mount point of the reference asset pack: set
``SURF_ASSETS`` to that pack so both packages build the same scene.
"""

from __future__ import annotations

import os

import numpy as np

from ..core import transform as tf
from .camera import Camera
from .instance import Instance
from .material import Material
from .mesh import Mesh, make_cube, make_icosphere, make_plane
from .scene import BG_GRADIENT, Scene, SceneBackground

DEFAULT_ASSET_DIRS = (
    os.environ.get("SURF_ASSETS", ""),
    os.path.join(os.path.dirname(__file__), "..", "..", "assets"),
)


def _find_asset(name: str) -> str | None:
    for d in DEFAULT_ASSET_DIRS:
        if d and os.path.isfile(os.path.join(d, name)):
            return os.path.join(d, name)
    return None


def load_mesh_or_fallback(name: str) -> Mesh:
    path = _find_asset(name)
    if path is not None:
        return Mesh.from_obj(path)
    if name == "plane.obj":
        return make_plane()
    if name == "cube.obj":
        return make_cube()
    if name == "lens.obj":
        m = make_icosphere(2)
        squash = np.diag([1.0, 1.0, 0.35, 1.0]).astype(np.float32)
        v = np.stack([m.v0, m.v1, m.v2], axis=1)
        n = np.stack([m.n0, m.n1, m.n2], axis=1)
        v = v @ squash[:3, :3].T
        return Mesh(v[:, 0], v[:, 1], v[:, 2], n[:, 0], n[:, 1], n[:, 2])
    if name == "susanne.obj":
        return make_icosphere(3)
    raise FileNotFoundError(name)


def make_materials() -> dict[str, Material]:
    """main.cpp:173-207."""
    return {
        "floor": Material(albedo=[0.8, 0.8, 0.8], reflectivity=0.01),
        "wall_red": Material(albedo=[1.0, 0.0, 0.0]),
        "wall_green": Material(albedo=[0.0, 1.0, 0.0]),
        "diffuse": Material(albedo=[1.0, 0.0, 0.0]),
        "dielectric": Material(
            albedo=[0.7, 0.7, 0.2],
            absorption=[0.03, 0.04, 0.03],
            refractivity=1.0,
            index_of_refraction=1.42,
        ),
        "specular": Material(albedo=[0.2, 0.9, 1.0], reflectivity=0.8),
        "soft_light": Material(emission_color=[1.0, 0.8, 0.6], emission_strength=5.0),
        "red_light": Material(emission_color=[1.0, 0.5, 0.2], emission_strength=5.0),
    }


def _radians(deg: float) -> float:
    return float(np.float32(deg) * np.float32(np.pi) / np.float32(180.0))


def make_indoor_scene(meshes: dict[str, Mesh] | None = None) -> Scene:
    """Instance order replicates main.cpp:350-366: {floor, cubeL, cubeR,
    susanne0, susanne1, lens0, wallL, wallR, wallTop, wallFront, wallBack}."""
    if meshes is None:
        meshes = {
            name: load_mesh_or_fallback(f"{name}.obj")
            for name in ("susanne", "cube", "lens", "plane")
        }
    m = make_materials()
    I = tf.identity()
    WORLD_FORWARD = [0.0, 0.0, -1.0]
    WORLD_RIGHT = [1.0, 0.0, 0.0]

    cube_l = Instance(
        meshes["cube"], m["soft_light"],
        tf.scale(tf.translate(I, [-8.0, 7.0, 5.0]), [0.5, 0.5, 0.5]),
    )
    cube_r = Instance(
        meshes["cube"], m["red_light"],
        tf.scale(tf.translate(I, [9.0, 5.0, -5.0]), [1.0, 1.0, 1.0]),
    )
    floor = Instance(
        meshes["plane"], m["floor"],
        tf.scale(tf.translate(I, [0.0, -1.0, 0.0]), [10.0, 10.0, 10.0]),
    )
    susanne0 = Instance(
        meshes["susanne"], m["diffuse"], tf.translate(I, [0.0, 0.0, -1.0])
    )
    susanne1 = Instance(
        meshes["susanne"], m["specular"], tf.translate(I, [3.0, 0.0, -1.0])
    )
    lens0 = Instance(
        meshes["lens"], m["dielectric"], tf.translate(I, [-3.0, 0.0, -1.0])
    )
    wall_l = Instance(
        meshes["plane"], m["wall_red"],
        tf.scale(
            tf.rotate(tf.translate(I, [-10.0, 4.0, 0.0]), _radians(90.0), WORLD_FORWARD),
            [5.0, 10.0, 10.0],
        ),
    )
    wall_r = Instance(
        meshes["plane"], m["wall_green"],
        tf.scale(
            tf.rotate(tf.translate(I, [10.0, 4.0, 0.0]), _radians(90.0), WORLD_FORWARD),
            [5.0, 10.0, 10.0],
        ),
    )
    wall_top = Instance(
        meshes["plane"], m["floor"],
        tf.scale(tf.translate(I, [0.0, 9.0, 0.0]), [10.0, 10.0, 10.0]),
    )
    wall_front = Instance(
        meshes["plane"], m["floor"],
        tf.scale(
            tf.rotate(tf.translate(I, [0.0, 4.0, -10.0]), _radians(90.0), WORLD_RIGHT),
            [10.0, 10.0, 5.0],
        ),
    )
    wall_back = Instance(
        meshes["plane"], m["floor"],
        tf.scale(
            tf.rotate(tf.translate(I, [0.0, 4.0, 10.0]), _radians(90.0), WORLD_RIGHT),
            [10.0, 10.0, 5.0],
        ),
    )

    background = SceneBackground(
        type=BG_GRADIENT,
        gradient_a=[0.8, 0.8, 0.8],
        gradient_b=[0.1, 0.4, 0.6],
    )
    return Scene(
        background,
        [floor, cube_l, cube_r, susanne0, susanne1, lens0,
         wall_l, wall_r, wall_top, wall_front, wall_back],
    )


def make_indoor_camera(width: int, height: int) -> Camera:
    """main.cpp:141-149."""
    return Camera(
        position=[0.0, 0.0, -7.0],
        target=[0.0, 0.0, 0.0],
        screen_width=width,
        screen_height=height,
        fov_y=70.0,
        focal_length=7.0,
        defocus_angle=0.5,
    )


def make_instanced_stress_scene(n_instances: int = 200,
                                mesh_name: str = "susanne.obj") -> Scene:
    """High-instance-count scene for the two-level traversal: n copies of
    ONE shared mesh on a jittered grid over a floor plane, one emissive
    cube.  A flattened compile stores n * mesh_tris world triangles;
    ``compile_scene(..., two_level="pure")`` stores the mesh once."""
    mesh = load_mesh_or_fallback(mesh_name)
    plane = load_mesh_or_fallback("plane.obj")
    cube = load_mesh_or_fallback("cube.obj")
    m = make_materials()
    I = tf.identity()
    side = max(1, int(np.ceil(np.sqrt(n_instances))))
    insts = [Instance(plane, m["floor"],
                      tf.scale(tf.translate(I, [0.0, -1.0, 0.0]),
                               [4.0 * side, 1.0, 4.0 * side]))]
    rng = np.random.default_rng(7)
    mats = [m["diffuse"], m["specular"], m["wall_green"]]
    for k in range(n_instances):
        gx, gz = k % side, k // side
        pos = [3.0 * (gx - (side - 1) / 2) + float(rng.uniform(-.4, .4)),
               float(rng.uniform(0.0, 1.5)),
               3.0 * (gz - (side - 1) / 2) + float(rng.uniform(-.4, .4))]
        s = float(rng.uniform(0.5, 1.1))
        xf = tf.scale(tf.rotate(tf.translate(I, pos),
                                float(rng.uniform(0, 2 * np.pi)),
                                [0.0, 1.0, 0.0]), [s, s, s])
        insts.append(Instance(mesh, mats[k % len(mats)], xf))
    insts.append(Instance(cube, m["soft_light"],
                          tf.scale(tf.translate(I, [0.0, 6.0, 0.0]),
                                   [2.0, 0.25, 2.0])))
    background = SceneBackground(
        type=BG_GRADIENT, gradient_a=[0.8, 0.8, 0.8],
        gradient_b=[0.1, 0.4, 0.6])
    return Scene(background, insts)


def make_stress_camera(width: int, height: int,
                       n_instances: int = 200) -> Camera:
    """Camera overlooking the stress grid (most primary rays hit geometry)."""
    side = max(1, int(np.ceil(np.sqrt(n_instances))))
    d = 2.2 * side
    return Camera(
        position=[0.0, 0.55 * d, -1.1 * d],
        target=[0.0, 0.0, 0.0],
        screen_width=width,
        screen_height=height,
        fov_y=70.0,
        focal_length=d,
        defocus_angle=0.3,
    )


def make_box_camera(width: int, height: int) -> Camera:
    """Camera framed on the diffuse-box scene's own geometry (cube at the
    origin, 20x20 floor at y=-1), pitched down from above so nearly every
    primary ray hits a surface."""
    return Camera(
        position=[0.0, 3.0, -6.0],
        target=[0.0, -1.0, 1.0],
        screen_width=width,
        screen_height=height,
        fov_y=70.0,
        focal_length=7.0,
        defocus_angle=0.5,
    )


def make_diffuse_box_scene() -> Scene:
    """cube.obj + plane.obj only, diffuse materials and a single emissive
    cube — the minimal end-to-end scene."""
    cube = load_mesh_or_fallback("cube.obj")
    plane = load_mesh_or_fallback("plane.obj")
    m = make_materials()
    I = tf.identity()
    floor = Instance(plane, m["floor"],
                     tf.scale(tf.translate(I, [0.0, -1.0, 0.0]), [10.0, 10.0, 10.0]))
    box = Instance(cube, m["diffuse"], tf.translate(I, [0.0, 0.0, 0.0]))
    light = Instance(cube, m["soft_light"],
                     tf.scale(tf.translate(I, [-3.0, 4.0, 2.0]), [0.5, 0.5, 0.5]))
    background = SceneBackground(
        type=BG_GRADIENT, gradient_a=[0.8, 0.8, 0.8], gradient_b=[0.1, 0.4, 0.6]
    )
    return Scene(background, [floor, box, light])
