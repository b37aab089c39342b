"""The wavefront path-tracing integrator (port of
``surf_tpu.wavefront.integrator``, forward path).  A flattened
``TorchScene`` is traversed by a ``bits*`` algo (``"bitsru8"`` by default),
a stream walk (``"skip"``, ``"stack"`` or a TPU schedule of the skip walk:
``"skip2"``, ``"ilvN"``, ``"specN"``, ``"specbN"``), or with
``use_wide=False`` by the binary packet walk; a hybrid two-level
``HybridScene`` also by ``algo="twolevel"``, whose instanced hit maps back
to the flattened leaf slot; a pure two-level ``PureScene`` by
``algo="twolevelp"``, whose shading re-derives world geometry per lane
from the shared object-space meshes and the hit instance's forward
transform.

Every pixel owns one path per sample in a dense SoA lane state; each wave
runs extend (closest-hit traversal), shade (lobe select, Schlick
dielectric, Beer–Lambert, Russian roulette), connect (next-event
estimation with any-hit shadow rays) and the bounce-ray update, all masked
per lane.  Each lane consumes random numbers exactly as the reference's
sequential CPU renderer does, so images agree with the NumPy oracle.

JAX runs the wave loop on the device in ``lax.while_loop``; here the host
drives it.  The loop reads the live-lane count once per wave (a device
sync), and the rejection samplers read their redraw flag once per round:
the same checks at the same waves as the JAX loop, so per-lane results are
unchanged.  With ``max_bounces`` set the loop runs exactly that many waves
and reads no live count (JAX's ``fori_loop``).

Gradients flow as in JAX (``surf_tpu_torch.diff``): autograd records the
host-driven loop, every traversal gets detached rays (its hit only picks
the triangle, which ``_reintersect`` intersects again differentiably), and
the discrete decisions (lobe, light, Fresnel, Russian roulette and its 1/p
weight, the rejection samplers' tests) read detached values.  A bounce
loop measures the tape of its first wave; when the tape of all its waves
would take more than ``TAPE_SHARE`` of the device's free memory, the later
waves are checkpointed and run again in the backward pass (``_stepper``).

Frame entry points, as in JAX: ``render_frame`` (seeds from the sample
count), ``render_frame_seeded`` (continues given seeds),
``render_frame_carry`` (cross-frame deferral: paths alive at the wave cap
persist in a ``FrameCarry`` and resume next frame) and
``render_frame_instrumented`` (the image and the wave statistics).
"""

from __future__ import annotations

import os
from typing import NamedTuple

import numpy as np
import torch
import torch.utils.checkpoint

from ..accel.bits import Hit, parse_algo, traverse_bits
from ..accel.bvh_walk import traverse_binary
from ..accel.instanced import traverse_instanced
from ..accel.stream import traverse_stream
from ..accel.stream_walk import ALGOS as STREAM_ALGOS
from ..core import rng, sampling
from ..core.vecmath import (
    F32_EPSILON,
    F32_FAR_AWAY,
    F32_INV_PI,
    cross,
    dot,
    normalize,
    radians,
    reflect,
)
from ..scene.camera import CameraParams, ViewPlane, view_plane
from ..scene.compile import HybridScene, PureScene, TorchScene

# The ported algos besides the bits* family, whose every string that
# JAX's traverse_wide accepts renders (accel.bits.parse_algo): the stream
# walks (accel.stream_walk.ALGOS: skip, stack, skip2, ilv1-4, spec1-8,
# specb1-8), twolevel and twolevelp.
ALGOS = (*STREAM_ALGOS, "twolevel", "twolevelp")
# bench.py's render knobs (wave cap, packet size, compaction, width ladder,
# lane order), applied with RenderConfig._replace(**BENCH_KNOBS).
BENCH_KNOBS = dict(wave_limit=32, block_rays=2048, compact=True,
                   compact_every=16, ladder=6, ladder_shrink=2,
                   pixel_order="morton")


def is_ported(algo: str) -> bool:
    """True for an algo the port renders: one of ALGOS or a valid bits*
    string."""
    if algo in ALGOS:
        return True
    try:
        parse_algo(algo)
    except ValueError:
        return False
    return True


def algo_of(scene: TorchScene | PureScene) -> str:
    """The traversal a scene is rendered with: "twolevelp" for a PureScene,
    "bitsru8" for a flattened TorchScene (or a HybridScene, as in JAX)."""
    return "twolevelp" if isinstance(scene, PureScene) else "bitsru8"


class RenderConfig(NamedTuple):
    """Render configuration: the fields of ``surf_tpu``'s RenderConfig that
    the forward path reads, with the same names and defaults.  ``algo``
    names the traversal, with JAX's precedence: "twolevelp" (the only one
    of a PureScene) and "twolevel" (a HybridScene's instanced tables) go
    to the instanced walk; else ``use_wide`` picks a
    ``bits*`` algo or a stream walk over the 8-wide layouts, and
    ``use_wide=False`` the binary packet walk.  ``cap_rows`` and
    ``pair_groups`` size the bits lists (0: BITS_CAP_ROWS, PAIR_GROUPS).  ``for_scene`` picks
    "bitsru8" or "twolevelp" by the scene's type (``algo_of``), and every
    frame entry point raises on an algo that is not ported or does not fit
    the scene.  With ``max_bounces=None`` the wave loop runs until every
    path has terminated or ``wave_limit`` waves; with a count it runs
    exactly that many waves, and the width ladder is off.  ``rr=False``
    turns Russian roulette's kill and its 1/p weight off (its random number
    is still drawn)."""

    width: int
    height: int
    spp: int
    use_defocus: bool
    num_lights: int
    wave_limit: int = 128
    block_rays: int = 1024       # rays per traversal packet
    compact: bool = False        # partition live paths to the front ...
    compact_every: int = 4       # ... on every k-th wave
    ladder: int = 0              # width-ladder rungs (0 = off)
    ladder_shrink: int = 4       # width divisor per rung
    pixel_order: str = "native"  # lane -> pixel map: "native" or "morton"
    algo: str = "bitsru8"        # traversal: a bits* string or one of ALGOS
    use_wide: bool = True        # False: the binary walk (unless twolevel[p])
    cap_rows: int = 0            # bits list capacity (0 = BITS_CAP_ROWS)
    pair_groups: int = 0         # bitsp per-ray groups (0 = PAIR_GROUPS)
    max_bounces: int | None = None  # None: wave_limit-capped while loop
    rr: bool = True              # Russian roulette's kill and 1/p weight

    @classmethod
    def for_scene(cls, scene: TorchScene | PureScene, width: int, height: int,
                  spp: int, use_defocus: bool,
                  max_bounces: int | None = None) -> "RenderConfig":
        return cls(width=width, height=height, spp=spp,
                   use_defocus=use_defocus, num_lights=scene.num_lights,
                   max_bounces=max_bounces, algo=algo_of(scene))


class PathState(NamedTuple):
    """Dense SoA lane state; ``pixel`` is the owning pixel, so compaction
    can permute lanes."""

    origin: torch.Tensor         # [N, 3]
    direction: torch.Tensor      # [N, 3]
    seed: torch.Tensor           # [N] int64 holding uint32
    transmission: torch.Tensor   # [N, 3]
    energy: torch.Tensor         # [N, 3]
    last_specular: torch.Tensor  # [N] bool
    in_medium: torch.Tensor      # [N] bool
    alive: torch.Tensor          # [N] bool
    pixel: torch.Tensor          # [N] int64


def compact_paths(state: PathState) -> PathState:
    """Stable partition: live lanes first, each group in its old order
    (two cumsums and one scatter, then gathers — as in JAX)."""
    alive = state.alive
    n = alive.shape[0]
    live_i = alive.to(torch.int64)
    c_live = live_i.cumsum(0)
    c_dead = (1 - live_i).cumsum(0)
    pos = torch.where(alive, c_live - 1, c_live[-1] + c_dead - 1)
    perm = torch.empty_like(pos)
    perm[pos] = torch.arange(n, device=pos.device)
    return PathState(*(x[perm] for x in state))


# --------------------------------------------------------------------------
# Stage 1: ray generation (ray_generation.comp:30-80, camera.h:59-87)
# --------------------------------------------------------------------------

def ray_generation(cfg: RenderConfig, vp: ViewPlane, seed: torch.Tensor,
                   px: torch.Tensor, py: torch.Tensor):
    """AA-jittered thin-lens primary rays, one per lane.  Returns (seed,
    origin [N, 3], direction [N, 3])."""
    seed, jx = rng.next_f32(seed)
    seed, jy = rng.next_f32(seed)
    fx = px.to(torch.float32) + (jx - 0.5)
    fy = py.to(torch.float32) + (jy - 0.5)
    u = fx * float(np.float32(1.0 / cfg.width))
    v = fy * float(np.float32(1.0 / cfg.height))

    if cfg.use_defocus:
        radius = vp.focal_length * torch.tan(radians(vp.defocus_angle / 2.0))
        du = vp.right * radius
        dv = -1.0 * vp.up * radius
        ones = torch.ones_like(seed, dtype=torch.bool)
        seed, su, sv = sampling.unit_disk(seed, ones)
        origin = vp.position + su[:, None] * du + sv[:, None] * dv
    else:
        origin = vp.position.expand(seed.shape[0], 3)

    plane = vp.first_pixel + u[:, None] * vp.u_vector + v[:, None] * vp.v_vector
    direction = normalize(plane - origin)
    return seed, origin, direction


# --------------------------------------------------------------------------
# Stages 2-4: extend / shade / connect in one masked bounce step
# --------------------------------------------------------------------------

def _traverse(scene: TorchScene | PureScene, cfg: RenderConfig, origin,
              direction, t_max, active, any_hit: bool):
    """Closest-hit (or any-hit) traversal of the scene by cfg's walk
    (``surf_tpu.wavefront.integrator._dispatch_traverse``).  Returns (Hit,
    inst): for a PureScene the hit's prim is the object-space triangle
    (``inst_obj_base[inst] + inst_slot_perm[base + slot]``) and ``inst``
    the hit instance (-1 on a miss); for a flattened scene prim is the
    leaf slot and ``inst`` is None, also with "twolevel", whose
    (instance, mesh-local slot) winner maps back to the leaf slot through
    ``inst_prim_base`` and ``inst_prim_map`` (integrator.py:291-296)."""
    args = (origin, direction, t_max, active)
    if cfg.algo == "twolevel":
        h = traverse_instanced(scene.inst, *args, any_hit=any_hit,
                               block_rays=cfg.block_rays)
        found = h.prim >= 0
        base = scene.inst_prim_base[h.inst.clamp(min=0)]
        slot = scene.inst_prim_map[base + h.prim.clamp(min=0)]
        return Hit(prim=torch.where(found, slot, -1), t=h.t, u=h.u, v=h.v), None
    if not isinstance(scene, PureScene):
        if not cfg.use_wide:
            return traverse_binary(scene.binary, *args, any_hit=any_hit), None
        if cfg.algo.startswith("bits"):
            return traverse_bits(scene.trace, *args, any_hit=any_hit,
                                 block_rays=cfg.block_rays, cap_rows=cfg.cap_rows,
                                 algo=cfg.algo, pair_groups=cfg.pair_groups), None
        return traverse_stream(scene.stream, *args, any_hit=any_hit,
                               block_rays=cfg.block_rays, algo=cfg.algo), None
    h = traverse_instanced(scene.inst, origin, direction, t_max, active,
                           any_hit=any_hit, block_rays=cfg.block_rays)
    found = h.prim >= 0
    base = scene.inst_obj_base[h.inst.clamp(min=0)]
    g = base + scene.inst_slot_perm[base + h.prim.clamp(min=0)]
    return (Hit(prim=torch.where(found, g, -1), t=h.t, u=h.u, v=h.v),
            torch.where(found, h.inst, -1))


def _xf_point(a, p):
    """Affine 3x4 rows a [N, 12] applied to points p [N, 3], each component
    ((a0*x + a1*y) + a2*z) + a3 as in JAX."""
    return torch.stack([a[:, 4 * k] * p[:, 0] + a[:, 4 * k + 1] * p[:, 1]
                        + a[:, 4 * k + 2] * p[:, 2] + a[:, 4 * k + 3]
                        for k in range(3)], dim=-1)


def _xf_vector(a, d):
    """The linear part of a [N, 12] applied to vectors d [N, 3]."""
    return torch.stack([a[:, 4 * k] * d[:, 0] + a[:, 4 * k + 1] * d[:, 1]
                        + a[:, 4 * k + 2] * d[:, 2] for k in range(3)], dim=-1)


def _sample_background(scene: TorchScene, direction):
    """Scene::sampleBackground (scene.cpp:35-51)."""
    if scene.bg_type != 1:
        return scene.bg_color.expand(direction.shape)
    alpha = 0.5 * (1.0 + direction[:, 1])
    return (alpha[:, None] * scene.bg_gradient_b
            + (1.0 - alpha)[:, None] * scene.bg_gradient_a)


def _material(table: torch.Tensor, mat: torch.Tensor) -> torch.Tensor:
    """The rows of a material table, one a lane.  ``index_select``, whose
    backward is one ``index_add_``: indexing's backward sorts the lanes by
    row and walks each row's lanes in one warp, and a table has a few rows
    for 262,144 lanes (28 ms a call at 512² on an H100, against a wave's
    ~25 ms: ``python -m surf_tpu_torch.breakdown --grad``)."""
    return table.index_select(0, mat)


def _emittance(scene: TorchScene, mat):
    return (_material(scene.mat_emission_strength, mat)[:, None]
            * _material(scene.mat_emission_color, mat))


def bounce_step(scene: TorchScene, cfg: RenderConfig, s: PathState) -> PathState:
    """One wave: extend -> shade -> connect -> bounce-ray update."""
    n = s.origin.shape[0]
    dev = s.origin.device

    # ---- EXTEND: closest hit, detached ----------------------------------
    hit, hit_inst = _traverse(scene, cfg, s.origin.detach(), s.direction.detach(),
                              torch.full((n,), F32_FAR_AWAY, device=dev),
                              s.alive, any_hit=False)
    found = hit.prim >= 0
    if isinstance(scene, PureScene):
        # twolevelp: world geometry from the shared object-space mesh and
        # the hit instance's forward transform (bvh.cpp:481-594)
        g = hit.prim.clamp(min=0)  # object-space triangle id
        inst = hit_inst.clamp(min=0)
        a = scene.inst_fwd[inst]
        v0 = _xf_point(a, scene.obj_v0[g])
        v1 = _xf_point(a, scene.obj_v1[g])
        v2 = _xf_point(a, scene.obj_v2[g])
        n0_ = _xf_vector(a, scene.obj_n0[g])
        n1_ = _xf_vector(a, scene.obj_n1[g])
        n2_ = _xf_vector(a, scene.obj_n2[g])
    else:
        slot = hit.prim.clamp(min=0)
        g = scene.perm[slot]  # original-order triangle id
        inst = scene.tri_inst[slot]
        v0 = scene.samp_v0[g]
        v1 = scene.samp_v1[g]
        v2 = scene.samp_v2[g]
        n0_ = scene.samp_n0[g]
        n1_ = scene.samp_n1[g]
        n2_ = scene.samp_n2[g]
    t, u, v = _reintersect(s.origin, s.direction, v0, v1, v2)

    miss = s.alive & ~found
    energy = torch.where(
        miss[:, None],
        s.energy + s.transmission * _sample_background(scene, s.direction),
        s.energy,
    )
    alive = s.alive & found

    mat = scene.inst_material[inst]

    # ---- light hit termination (ray_shade.comp:64-69) ----------------------
    hit_light = alive & scene.mat_is_light[mat]
    lit = hit_light & s.last_specular
    energy = torch.where(
        lit[:, None], energy + s.transmission * _emittance(scene, mat), energy)
    alive = alive & ~hit_light

    # ---- SHADE (ray_shade.comp:71-189, renderer.cpp:354-459) ---------------
    # Miss lanes re-intersected slot 0 with an unrelated ray (t/u/v may be
    # +-inf); neutral values keep every consumer finite.  Every consumer is
    # masked by alive, a subset of found, so the image is unchanged.
    t = torch.where(found, t, 0.0)
    u = torch.where(found, u, 0.25)
    v = torch.where(found, v, 0.25)
    medium_scale = torch.where(
        s.in_medium[:, None],
        torch.exp(_material(scene.mat_absorption, mat) * -t[:, None]),
        1.0,
    )
    I = s.origin + t[:, None] * s.direction
    N = u[:, None] * n0_ + v[:, None] * n2_ + (1.0 - u - v)[:, None] * n1_
    N = normalize(N)

    seed, r_lobe = rng.next_f32_masked(s.seed, alive)
    N = torch.where(dot(s.direction, N)[:, None] > 0, -N, N)

    refl = scene.mat_reflectivity[mat]
    refr = scene.mat_refractivity[mat]
    albedo = _material(scene.mat_albedo, mat)
    m_spec = alive & (r_lobe < refl)
    m_diel = alive & ~m_spec & (r_lobe < refl + refr)
    m_diff = alive & ~m_spec & ~m_diel

    refl_dir = reflect(s.direction, N)
    r_out = torch.zeros_like(s.direction)

    # specular mirror
    r_out = torch.where(m_spec[:, None], refl_dir, r_out)
    spec_trans = s.transmission * albedo * medium_scale
    new_trans = torch.where(m_spec[:, None], spec_trans, s.transmission)
    new_last_spec = m_spec | s.last_specular

    # dielectric with Schlick Fresnel (renderer.cpp:376-406).  Non-dielectric
    # materials carry ior = 0; ior is read only on m_diel lanes, so 1 is
    # substituted elsewhere to keep n1 / n2 finite.
    ior = torch.where(m_diel, scene.mat_ior[mat], 1.0)
    n1 = torch.where(s.in_medium, ior, 1.0)
    n2 = torch.where(s.in_medium, 1.0, ior)
    ior_ratio = n1 / n2
    cos_i = -dot(s.direction, N)
    cos_theta2 = 1.0 - ior_ratio * ior_ratio * (1.0 - cos_i * cos_i)
    can_refract = cos_theta2 > 0
    a_ = n1 - n2
    b_ = n1 + n2
    r0 = (a_ * a_) / (b_ * b_)
    c_ = 1.0 - cos_i
    fresnel = r0 + (1.0 - r0) * (c_ * c_ * c_ * c_ * c_)
    seed, r_fr = rng.next_f32_masked(seed, m_diel & can_refract)
    must_refract = m_diel & can_refract & (r_fr > fresnel)
    # The sqrt argument is floored at 1e-12 as in JAX (it is consumed only
    # where cos_theta2 > 0).
    refract_dir = (
        ior_ratio[:, None] * s.direction
        + (ior_ratio * cos_i
           - torch.sqrt(cos_theta2.abs().clamp(min=1e-12)))[:, None] * N
    )
    r_out = torch.where(
        m_diel[:, None],
        torch.where(must_refract[:, None], refract_dir, refl_dir),
        r_out,
    )
    new_trans = torch.where(m_diel[:, None], spec_trans, new_trans)
    new_last_spec = m_diel | new_last_spec
    new_in_medium = torch.where(must_refract, ~s.in_medium, s.in_medium)

    # diffuse: cosine bounce + NEE + RR
    seed, cos_dir = sampling.cosine_hemisphere(seed, N, m_diff)
    r_out = torch.where(m_diff[:, None], cos_dir, r_out)
    cos_theta = dot(N, cos_dir)
    brdf = albedo * F32_INV_PI

    if cfg.num_lights > 0:
        seed, energy = _next_event(scene, cfg, seed, m_diff, I, N, brdf,
                                   s.transmission, energy)

    # Russian roulette (renderer.cpp:446-454).  cfg.rr=False turns the kill
    # and the 1/p weight off; the draw is still consumed, so every other
    # stream is unchanged (as in JAX).
    p = s.transmission.amax(dim=1).clamp(0.0, 1.0)
    seed, r_rr = rng.next_f32_masked(seed, m_diff)
    rr_kill = m_diff & (p < r_rr) if cfg.rr else torch.zeros_like(m_diff)
    alive = alive & ~rr_kill
    m_diff_live = m_diff & ~rr_kill
    # pdf 1 on non-diffuse lanes and p floored at 1e-12 keep the masked
    # branch finite (as in JAX); neither changes a consumed value.  The
    # 1/p weight is detached as in JAX: p is part of the sampling measure,
    # fixed at the linearization point.
    diffuse_pdf = torch.where(m_diff, cos_theta * F32_INV_PI, 1.0)
    inv_pdf = 1.0 / diffuse_pdf
    rr_scale = (1.0 / torch.where(m_diff, p.clamp(min=1e-12), 1.0).detach() if cfg.rr
                else torch.ones_like(p))
    diff_trans = (
        s.transmission
        * cos_theta[:, None] * inv_pdf[:, None] * brdf
        * medium_scale * rr_scale[:, None]
    )
    new_trans = torch.where(m_diff_live[:, None], diff_trans, new_trans)
    new_last_spec = new_last_spec & ~m_diff_live

    origin = torch.where(alive[:, None], I + F32_EPSILON * r_out, s.origin)
    direction = torch.where(alive[:, None], r_out, s.direction)

    return PathState(
        origin=origin,
        direction=direction,
        seed=seed,
        transmission=torch.where(alive[:, None], new_trans, s.transmission),
        energy=energy,
        last_specular=torch.where(alive, new_last_spec, s.last_specular),
        in_medium=torch.where(alive, new_in_medium, s.in_medium),
        alive=alive,
        pixel=s.pixel,
    )


def _reintersect(origin, direction, v0, v1, v2):
    """Möller–Trumbore at a fixed triangle (no tests).  |a| is clamped at
    1e-12 as in JAX: lanes the traversal reports found have |a| >= 1e-5, and
    miss lanes (re-intersecting slot 0) stay finite."""
    e1 = v1 - v0
    e2 = v2 - v0
    h = cross(direction, e2)
    a = dot(e1, h)
    a = torch.where(a.abs() < 1e-12, torch.where(a < 0, -1e-12, 1e-12), a)
    f = 1.0 / a
    srel = origin - v0
    u = f * dot(srel, h)
    q = cross(srel, e1)
    v = f * dot(direction, q)
    t = f * dot(e2, q)
    return t, u, v


def _next_event(scene: TorchScene, cfg: RenderConfig, seed, m_diff, I, N,
                brdf, transmission, energy):
    """NEE: sample one light instance and a point on it, trace an any-hit
    shadow ray (ray_shade.comp:125-174 + ray_connect.comp:178-212).  RNG
    order per diffuse lane: light pick, u, v, triangle id.  For
    "twolevelp" the point and normal are sampled on the object-space mesh
    and taken to world space by the light instance's forward transform
    (Instance::samplePoint, bvh.cpp:533-552)."""
    seed, li_raw = rng.next_u32_masked(seed, m_diff)
    light_inst = scene.light_inst[li_raw % cfg.num_lights]
    seed, su = rng.next_f32_masked(seed, m_diff)
    seed, sv_raw = rng.next_f32_masked(seed, m_diff)
    sv = sv_raw * (1.0 - su)
    seed, ti_raw = rng.next_u32_masked(seed, m_diff)
    tri_local = ti_raw % scene.inst_tri_count[light_inst]
    tri_idx = scene.inst_tri_offset[light_inst] + tri_local

    w = 1.0 - su - sv
    pure = isinstance(scene, PureScene)
    src = "obj" if pure else "samp"
    lv0, lv1, lv2, ln0, ln1, ln2 = (getattr(scene, f"{src}_{k}") for k in
                                    ("v0", "v1", "v2", "n0", "n1", "n2"))
    p_pos = (su[:, None] * lv0[tri_idx] + sv[:, None] * lv2[tri_idx]
             + w[:, None] * lv1[tri_idx])
    p_raw = (su[:, None] * ln0[tri_idx] + sv[:, None] * ln2[tri_idx]
             + w[:, None] * ln1[tri_idx])
    if pure:
        a = scene.inst_fwd[light_inst]
        p_pos = _xf_point(a, p_pos)
        p_raw = _xf_vector(a, p_raw)
    p_nrm = normalize(p_raw)
    IL = p_pos - I
    L = normalize(IL)
    SO = I + F32_EPSILON * L
    sr_depth = torch.sqrt(dot(IL, IL)) - 2.0 * F32_EPSILON
    falloff = 1.0 / dot(IL, IL)
    cos_o = dot(N, L)
    cos_li = dot(p_nrm, -L)
    nee_ok = m_diff & (cos_o > 0) & (cos_li > 0)

    # CONNECT: any-hit occlusion, detached
    occ, _ = _traverse(scene, cfg, SO.detach(), L.detach(), sr_depth.detach(), nee_ok,
                       any_hit=True)
    unoccluded = nee_ok & (occ.prim < 0)

    area = scene.inst_area[light_inst]
    SA = cos_li * area * falloff
    l_emit = _emittance(scene, scene.inst_material[light_inst])
    Ld = l_emit * SA[:, None] * brdf * cos_o[:, None] * float(cfg.num_lights)
    energy = torch.where(unoccluded[:, None], energy + transmission * Ld, energy)
    return seed, energy


# --------------------------------------------------------------------------
# Sample / frame loops (replace the host wave loop, renderer.cpp:1030-1106)
# --------------------------------------------------------------------------

def _wave(scene: TorchScene, cfg: RenderConfig, i: int, s: PathState) -> PathState:
    if cfg.compact and i % cfg.compact_every == 0:
        s = compact_paths(s)
    return bounce_step(scene, cfg, s)


# The share of the free memory that a bounce loop's autograd tape may take
# before its waves are checkpointed.  At 512x512 (one spp, 12 waves of the
# indoor scene, H100) the forward alone peaks at 2.17 GiB (bits lists, merge
# scratch) and with the tape at 4.05 GiB, and the backward adds a wave's
# gradients: a quarter leaves room for all three.
TAPE_SHARE = 0.25


def _free_bytes(device: torch.device) -> int:
    """The memory a tape can still take on ``device``: the card's free
    memory and what the caching allocator holds unused, or the host's
    free memory."""
    if device.type == "cuda":
        free, _ = torch.cuda.mem_get_info(device)
        return free + torch.cuda.memory_reserved(device) - torch.cuda.memory_allocated(device)
    return os.sysconf("SC_AVPHYS_PAGES") * os.sysconf("SC_PAGE_SIZE")


def _taped_wave(scene: TorchScene, cfg: RenderConfig, i: int, s: PathState):
    """Wave i and the bytes autograd saved for its backward, each storage
    once (0 when nothing on the wave requires grad).  The storages are
    held until the wave ends, so that one the wave frees cannot pass its
    address on to another and hide it.  Returns (state, bytes)."""
    storages = {}

    def pack(t):
        st = t.untyped_storage()
        storages[st.data_ptr()] = st
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        s = _wave(scene, cfg, i, s)
    return s, sum(st.nbytes() for st in storages.values())


def _stepper(waves: int):
    """The wave function of one bounce loop of at most ``waves`` waves.
    The first wave runs as it is and its tape is measured; when ``waves``
    such tapes would take more than TAPE_SHARE of the free memory, every
    later wave is checkpointed (JAX's ``remat``): the backward keeps only
    the wave's inputs and runs the wave again.  Non-reentrant: the
    reentrant form takes no NamedTuple and loses the gradients of what
    the wave closes over (the material table, the vertices).  Without a
    tape (no_grad, or no input requiring grad) nothing is checkpointed."""
    remat = None

    def step(scene: TorchScene, cfg: RenderConfig, i: int, s: PathState) -> PathState:
        nonlocal remat
        if remat is None:
            s, taped = _taped_wave(scene, cfg, i, s)
            remat = taped > 0 and taped * (waves - 1) > TAPE_SHARE * _free_bytes(s.seed.device)
            return s
        if remat:
            return torch.utils.checkpoint.checkpoint(_wave, scene, cfg, i, s,
                                                     use_reentrant=False)
        return _wave(scene, cfg, i, s)

    return step


def _run_waves(scene: TorchScene, cfg: RenderConfig, i: int, s: PathState,
               thresh: int | None = None, step=None):
    """Bounce while some lane is alive, fewer than wave_limit waves have run
    and (with ``thresh``) more than ``thresh`` lanes are alive, each wave
    through ``step`` (``_wave`` without it).  One device sync per wave
    reads the live count.  Returns (waves run so far, state, the live
    counts summed over the waves this call ran)."""
    step = _wave if step is None else step
    lane_steps = 0
    while i < cfg.wave_limit:
        live = int(s.alive.sum())
        if live == 0 or (thresh is not None and live <= thresh):
            break
        lane_steps += live
        s = step(scene, cfg, i, s)
        i += 1
    return i, s, lane_steps


def _bounce_loop(scene: TorchScene, cfg: RenderConfig,
                 state: PathState) -> PathState:
    """Bounce until every path terminates or the wave cap; with
    ``max_bounces`` set, exactly that many waves and no live count read
    (JAX's fori_loop).  Paths alive at the end contribute nothing more
    unless a FrameCarry defers them.  Waves are checkpointed as
    ``_stepper`` decides."""
    if cfg.max_bounces is None:
        return _run_waves(scene, cfg, 0, state, step=_stepper(cfg.wave_limit))[1]
    step = _stepper(cfg.max_bounces)
    for i in range(cfg.max_bounces):
        state = step(scene, cfg, i, state)
    return state


def _bounce_loop_ladder(scene: TorchScene, cfg: RenderConfig, state: PathState):
    """Width-ladder wave loop: run at full width while more than
    1/ladder_shrink of the lanes live, then stable-compact, bank the dead
    suffix, and go on with the live prefix at 1/ladder_shrink the width
    (up to ``ladder`` rungs, none narrower than 1024 lanes).  Each lane sees
    the same op sequence as in the plain loop.  Returns (seed, energy) in
    pixel order."""
    if cfg.ladder_shrink < 2:
        raise ValueError("ladder_shrink must be >= 2 (1 makes every rung a no-op)")
    n = state.seed.shape[0]
    widths = []
    m = n
    for _ in range(cfg.ladder):
        m //= cfg.ladder_shrink
        if m >= 1024:
            widths.append(m)

    banked = []  # (pixel, seed, energy) of lanes retired from the loop
    i = 0
    for m in widths:
        i, state, _ = _run_waves(scene, cfg, i, state, m)
        state = compact_paths(state)
        banked.append((state.pixel[m:], state.seed[m:], state.energy[m:]))
        state = PathState(*(x[:m] for x in state))
    i, state, _ = _run_waves(scene, cfg, i, state)
    banked.append((state.pixel, state.seed, state.energy))

    seed_out = torch.zeros(n, dtype=state.seed.dtype, device=state.seed.device)
    energy_out = torch.zeros(n, 3, dtype=torch.float32, device=state.seed.device)
    for p, sd, e in banked:
        seed_out[p] = sd
        energy_out[p] = e
    return seed_out, energy_out


def _primary_paths(cfg: RenderConfig, vp: ViewPlane, seed, px, py,
                   pixel_ids=None) -> PathState:
    """Raygen and the fresh lane state of one sample: lane i owns pixel
    ``pixel_ids[i]`` (i without it)."""
    seed, origin, direction = ray_generation(cfg, vp, seed, px, py)
    n = seed.shape[0]
    dev = seed.device
    return PathState(
        origin=origin,
        direction=direction,
        seed=seed,
        transmission=torch.ones(n, 3, device=dev),
        energy=torch.zeros(n, 3, device=dev),
        last_specular=torch.ones(n, dtype=torch.bool, device=dev),
        in_medium=torch.zeros(n, dtype=torch.bool, device=dev),
        alive=torch.ones(n, dtype=torch.bool, device=dev),
        pixel=(torch.arange(n, device=dev) if pixel_ids is None else pixel_ids),
    )


def _in_pixel_order(state: PathState):
    """(seed, energy) of a lane permutation, back in pixel order (the
    inverse permutation is one scatter)."""
    order = torch.empty_like(state.pixel)
    order[state.pixel] = torch.arange(state.pixel.shape[0], device=state.pixel.device)
    return state.seed[order], state.energy[order]


def render_sample(scene: TorchScene, cfg: RenderConfig, vp: ViewPlane,
                  seed, px, py, pixel_ids=None):
    """One sample for every pixel lane: raygen + the full bounce loop.
    ``pixel_ids`` maps lane i to a pixel other than i (morton order);
    seed and energy come back in pixel order."""
    state = _primary_paths(cfg, vp, seed, px, py, pixel_ids)
    if cfg.ladder > 0 and cfg.max_bounces is None:
        return _bounce_loop_ladder(scene, cfg, state)
    state = _bounce_loop(scene, cfg, state)
    if cfg.compact or pixel_ids is not None:
        return _in_pixel_order(state)
    return state.seed, state.energy


def lane_pixel_perm(cfg: RenderConfig, device: torch.device):
    """Lane -> pixel permutation for cfg.pixel_order ([N] int64), or None
    for the identity.  "morton" interleaves the x/y bits of the pixel
    coordinate (stable argsort, so any W/H works)."""
    if cfg.pixel_order == "native":
        return None
    if cfg.pixel_order != "morton":
        raise ValueError(f"unknown pixel_order {cfg.pixel_order!r}")
    n = cfg.width * cfg.height
    px = np.arange(n, dtype=np.uint64) % cfg.width
    py = np.arange(n, dtype=np.uint64) // cfg.width
    code = np.zeros(n, np.uint64)
    for b in range(max(cfg.width, cfg.height).bit_length()):
        code |= ((px >> np.uint64(b)) & np.uint64(1)) << np.uint64(2 * b)
        code |= ((py >> np.uint64(b)) & np.uint64(1)) << np.uint64(2 * b + 1)
    return torch.as_tensor(np.argsort(code, kind="stable"), device=device)


def _check_algo(scene: TorchScene | HybridScene | PureScene, cfg: RenderConfig) -> None:
    """Raises unless cfg.algo is ported and renders this kind of scene
    ("twolevel" needs a HybridScene's instanced tables, as JAX asserts)."""
    pure = isinstance(scene, PureScene)
    if (not is_ported(cfg.algo) or pure != (cfg.algo == "twolevelp")
            or (cfg.algo == "twolevel" and not isinstance(scene, HybridScene))):
        fits = "twolevelp" if pure else "bits*, a stream walk or use_wide=False"
        if isinstance(scene, HybridScene):
            fits += ", or twolevel"
        raise ValueError(f"algo={cfg.algo!r} does not render a {type(scene).__name__} "
                         f"(it renders with {fits}; the ported algos are {ALGOS} and "
                         f"every bits* string of traverse_wide)")


def _native_lanes(cfg: RenderConfig, device: torch.device):
    """(px, py) of native row-major lanes."""
    lane = torch.arange(cfg.width * cfg.height, device=device)
    return lane % cfg.width, lane // cfg.width


def render_frame_seeded(scene: TorchScene, cfg: RenderConfig,
                        cam: CameraParams, seed0: torch.Tensor):
    """Render cfg.spp samples continuing the per-pixel seed streams
    ``seed0``; returns (radiance sums [H, W, 3], final seeds).  Chunking a
    large spp budget into several calls gives the same image as one call."""
    _check_algo(scene, cfg)
    vp = view_plane(cam, cfg.width, cfg.height)
    n = cfg.width * cfg.height
    dev = seed0.device
    perm = lane_pixel_perm(cfg, dev)
    lane_pixel = torch.arange(n, device=dev) if perm is None else perm
    px = lane_pixel % cfg.width
    py = lane_pixel // cfg.width
    seed = seed0
    acc = torch.zeros(n, 3, device=dev)
    for _ in range(cfg.spp):
        seed_lane = seed if perm is None else seed[perm]
        seed, energy = render_sample(scene, cfg, vp, seed_lane, px, py,
                                     pixel_ids=perm)
        acc = acc + energy
    return acc.reshape(cfg.height, cfg.width, 3), seed


def initial_seeds(cfg: RenderConfig, total_samples: int,
                  device: torch.device) -> torch.Tensor:
    """Per-pixel seeds for a frame at ``total_samples`` (renderer.cpp:169)."""
    n = cfg.width * cfg.height
    return rng.pixel_seed(torch.arange(n, dtype=torch.int64, device=device),
                          total_samples)


def render_frame(scene: TorchScene, cfg: RenderConfig, cam: CameraParams,
                 total_samples: int, device: torch.device) -> torch.Tensor:
    """One frame of cfg.spp samples a pixel, seeded from the accumulated
    sample count; returns the radiance sums [H, W, 3] (divide by the sample
    count outside)."""
    acc, _ = render_frame_seeded(scene, cfg, cam,
                                 initial_seeds(cfg, total_samples, device))
    return acc


# --------------------------------------------------------------------------
# Cross-frame deferral (renderer.cpp:27-29, 1101-1104): paths still alive at
# the wave cap persist in a FrameCarry and resume in the next frame with
# their own seed streams, so the cap's estimator bias is zero once the pool
# has drained.
# --------------------------------------------------------------------------

DEFER_DRAIN = 64  # the drain's least wave cap (JAX's RenderConfig.defer_drain)

class FrameCarry(NamedTuple):
    """The deferred paths: a fixed pool of W*H lanes whose live lanes form
    a prefix (``deferred.alive``; ``deferred.pixel`` routes their energy),
    and ``dropped`` [] int64, the survivors that found the pool full."""

    deferred: PathState
    dropped: torch.Tensor


def empty_frame_carry(cfg: RenderConfig, device: torch.device) -> FrameCarry:
    n = cfg.width * cfg.height

    def z(*shape, dtype=torch.float32):
        return torch.zeros(*shape, dtype=dtype, device=device)

    return FrameCarry(
        deferred=PathState(
            origin=z(n, 3), direction=z(n, 3), seed=z(n, dtype=torch.int64),
            transmission=z(n, 3), energy=z(n, 3),
            last_specular=z(n, dtype=torch.bool), in_medium=z(n, dtype=torch.bool),
            alive=z(n, dtype=torch.bool), pixel=z(n, dtype=torch.int64),
        ),
        dropped=z((), dtype=torch.int64),
    )


def _merge_deferred(d: PathState, s: PathState, dropped: torch.Tensor):
    """Append s's live lanes, compacted, after the pool's m live lanes
    (the pool ``d`` is live-prefix compact and stays so); the survivors
    past the pool's end, the last in compacted order, are lost and counted
    into ``dropped``.  Device ops only: no sync."""
    n = d.alive.shape[0]
    s = compact_paths(s)
    m = d.alive.sum()
    k = s.alive.sum()
    idx = torch.arange(n, device=d.alive.device)
    src = (idx - m).clamp(0, n - 1)
    take_new = (idx >= m) & (idx < m + k)

    def mix(df, sf):
        mask = take_new if df.dim() == 1 else take_new[:, None]
        return torch.where(mask, sf[src], df)

    merged = PathState(*(mix(df, sf) for df, sf in zip(d, s)))
    return merged, dropped + (m + k - n).clamp(min=0)


def _continue_deferred(scene: TorchScene, cfg: RenderConfig, carry: FrameCarry):
    """Run the wave loop over the pool (at least DEFER_DRAIN waves,
    compacting); bank its new energy by pixel, zero it in the pool and
    re-compact it.  Returns (energy [N, 3] by pixel, carry)."""
    n = carry.deferred.alive.shape[0]
    drain_cfg = cfg._replace(
        wave_limit=max(cfg.wave_limit, DEFER_DRAIN), compact=True,
        compact_every=min(cfg.compact_every, 4) if cfg.compact else 4)
    d = _bounce_loop(scene, drain_cfg, carry.deferred)
    # with spp > 1 two pool lanes can own one pixel: a scatter-add
    add = torch.zeros(n, 3, device=d.energy.device).index_add_(0, d.pixel, d.energy)
    d = d._replace(energy=torch.zeros_like(d.energy))
    # the drain's last waves may kill lanes after its last compaction
    return add, carry._replace(deferred=compact_paths(d))


def render_sample_deferring(scene: TorchScene, cfg: RenderConfig,
                            vp: ViewPlane, seed, px, py):
    """render_sample that keeps the capped-out paths: (next seeds, energy
    [N, 3] by pixel, the lane state with its energy zeroed).  Native lanes
    and the plain bounce loop whatever cfg.pixel_order and cfg.ladder say,
    as in JAX."""
    state = _bounce_loop(scene, cfg, _primary_paths(cfg, vp, seed, px, py))
    n = state.seed.shape[0]
    energy = torch.zeros(n, 3, device=state.energy.device).index_add_(
        0, state.pixel, state.energy)
    seed_out = torch.zeros_like(state.seed)
    seed_out[state.pixel] = state.seed
    return seed_out, energy, state._replace(energy=torch.zeros_like(state.energy))


def render_frame_carry(scene: TorchScene, cfg: RenderConfig, cam: CameraParams,
                       seed0: torch.Tensor, carry: FrameCarry):
    """One frame with cross-frame deferral: drain last frame's pool (its
    energy first), render cfg.spp fresh samples, and defer this frame's
    capped-out paths.  Returns (radiance sums [H, W, 3], next seeds, next
    carry); with spp=0 it only drains."""
    _check_algo(scene, cfg)
    vp = view_plane(cam, cfg.width, cfg.height)
    px, py = _native_lanes(cfg, seed0.device)
    acc, carry = _continue_deferred(scene, cfg, carry)
    seed = seed0
    for _ in range(cfg.spp):
        seed, energy, surv = render_sample_deferring(scene, cfg, vp, seed, px, py)
        carry = FrameCarry(*_merge_deferred(carry.deferred, surv, carry.dropped))
        acc = acc + energy
    return acc.reshape(cfg.height, cfg.width, 3), seed, carry


def render_sample_instrumented(scene: TorchScene, cfg: RenderConfig,
                               vp: ViewPlane, seed, px, py):
    """render_sample with wave statistics: (seed, energy, {waves,
    lane_steps, deferred}): lane_steps sums the live lanes over the waves,
    deferred counts the paths alive at the cap.  Native lanes, no ladder,
    compaction on every wave with cfg.compact, the cap max_bounces if set
    (else wave_limit), and the loop stops when no lane is alive: JAX's
    semantics.  The loop reads the live count each wave, so lane_steps is
    free."""
    limit = cfg.wave_limit if cfg.max_bounces is None else cfg.max_bounces
    waves, state, lane_steps = _run_waves(
        scene, cfg._replace(wave_limit=limit, compact_every=1), 0,
        _primary_paths(cfg, vp, seed, px, py))
    deferred = int(state.alive.sum())
    seed_out, energy = _in_pixel_order(state) if cfg.compact else (state.seed, state.energy)
    return seed_out, energy, dict(waves=waves, lane_steps=lane_steps, deferred=deferred)


def render_frame_instrumented(scene: TorchScene, cfg: RenderConfig,
                              cam: CameraParams, total_samples: int,
                              device: torch.device):
    """One frame seeded from ``total_samples`` and its wave statistics,
    summed over the samples: (radiance sums [H, W, 3], {waves, lane_steps,
    deferred, occupancy}); occupancy = lane_steps / (waves * W * H) in
    float32, as JAX computes it."""
    _check_algo(scene, cfg)
    vp = view_plane(cam, cfg.width, cfg.height)
    n = cfg.width * cfg.height
    px, py = _native_lanes(cfg, device)
    seed = initial_seeds(cfg, total_samples, device)
    acc = torch.zeros(n, 3, device=device)
    total = dict(waves=0, lane_steps=0, deferred=0)
    for _ in range(cfg.spp):
        seed, energy, st = render_sample_instrumented(scene, cfg, vp, seed, px, py)
        acc = acc + energy
        total = {k: total[k] + st[k] for k in total}
    f32 = np.float32
    total["occupancy"] = float(f32(total["lane_steps"])
                               / np.maximum(f32(total["waves"]) * f32(n), f32(1.0)))
    return acc.reshape(cfg.height, cfg.width, 3), total
