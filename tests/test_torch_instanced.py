"""surf_tpu_torch.accel.instanced (pure two-level traversal) against
surf_tpu.accel.pallas_instanced: the host build, the traversal through the
plain instanced leaf-row version against the NumPy oracle with the
kernel's total order (exact inst and prim) and against JAX's Pallas kernel
in interpret mode, any-hit, inactive rays, forced per-pair sweeps, and the
O(unique mesh triangles) memory of the pure compile."""

import numpy as np
import pytest
import torch

from surf_tpu.accel import pallas_instanced as jpi
from surf_tpu.core import transform as jtf
from surf_tpu.scene.mesh import make_cube, make_icosphere, make_plane
from surf_tpu_torch.accel import instanced
from surf_tpu_torch.core import transform as ptf
from surf_tpu_torch.scene import builtin
from surf_tpu_torch.scene.compile import PureScene, compile_scene
from surf_tpu_torch.scene.instance import world_bounds

# One intra-op thread: tier-1 runs six pytest workers on the machine's
# cores, and torch's default of one thread per core oversubscribes them.
torch.set_num_threads(1)

CPU = torch.device("cpu")


def _xforms():
    return [
        (0, jtf.identity()),
        (0, jtf.rotate(jtf.translate(jtf.identity(), [2.5, 0.5, 0.0]),
                       0.7, [0, 1, 0])),
        (0, jtf.scale(jtf.translate(jtf.identity(), [-2.0, 0.0, 1.0]),
                      [1.5, 0.5, 1.0])),
        (1, jtf.scale(jtf.translate(jtf.identity(), [0.0, -1.0, 0.0]),
                      [10, 1, 10])),
    ]


def _rays(n=512, seed=3):
    """The rays of tests/test_instanced.py: half aimed at the scene, six
    axis-aligned."""
    rng = np.random.default_rng(seed)
    o = rng.uniform(-5, 5, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    aim = rng.uniform(-2, 2, (n // 2, 3)).astype(np.float32)
    d[: n // 2] = aim - o[: n // 2]
    d[: n // 2] /= np.linalg.norm(d[: n // 2], axis=1, keepdims=True)
    d[:6] = 0.0
    d[np.arange(6), np.arange(6) % 3] = np.where(np.arange(6) % 2 == 0, 1.0, -1.0)
    return o, d, np.full(n, 1e30, np.float32)


def _build(meshes, cap=None):
    """(JAX InstancedHost, port InstancedHost) for the fixture transforms.
    JAX derives the world bounds and the inverse from the transform; the
    port takes them as ``Instance`` caches them."""
    kw = {} if cap is None else {"cap_per_inst": cap}
    jinsts = [(m, x, None, None) for m, x in _xforms()]
    insts = [(m, ptf.inverse(x), *world_bounds(x, *meshes[m])) for m, x in _xforms()]
    return (jpi.build_instanced_trace(meshes, jinsts, **kw),
            instanced.build_instanced_trace(meshes, insts, CPU, **kw))


@pytest.fixture(scope="module")
def setup():
    cube, plane = make_cube(), make_plane()
    jhost, host = _build([(cube.v0, cube.v1, cube.v2),
                          (plane.v0, plane.v1, plane.v2)])
    return jhost, host, _rays()


def _trace(host, o, d, tm, act=None, any_hit=False, block_rays=256):
    act = np.ones(len(o), bool) if act is None else act
    return instanced.traverse_instanced(
        host.trace, torch.from_numpy(o), torch.from_numpy(d),
        torch.from_numpy(tm), torch.from_numpy(act), any_hit=any_hit,
        block_rays=block_rays)


def test_build_equals_jax(setup):
    jhost, host, _ = setup
    jt, t = jhost.trace, host.trace
    assert tuple(t.meta) == tuple(jt.meta)
    for got, want in ((t.ltab, jt.ltab), (t.box_lo, jt.box_lo),
                      (t.box_hi, jt.box_hi), (t.inst_lo, jt.inst_lo),
                      (t.inst_hi, jt.inst_hi), (t.inv, jhost.inv3x4),
                      (t.inv, np.asarray(jt.xf_rows)[:, :12])):
        assert np.array_equal(got.numpy().view(np.int32),
                              np.asarray(want).view(np.int32))
    for a, b in zip(host.perms, jhost.perms):
        assert np.array_equal(a, b)
    seg_off, row0, rows8 = t.segs.numpy()
    assert list(seg_off) == list(np.cumsum((0,) + t.meta.caps[:-1]))
    assert list(row0) == [t.meta.row_off[m] for m in t.meta.mesh_of]
    assert all(r % 8 == 0 and r >= t.meta.n_rows[m]
               for r, m in zip(rows8, t.meta.mesh_of))


@pytest.mark.parametrize("block_rays", [256, 512])
def test_matches_numpy_oracle_exactly(setup, block_rays):
    jhost, host, (o, d, tm) = setup
    ref = jpi.traverse_instanced_np(jhost, o, d, tm)
    hit = _trace(host, o, d, tm, block_rays=block_rays)
    assert (ref["inst"] >= 0).mean() > 0.3, "fixture rays barely hit the scene"
    assert np.array_equal(hit.inst.numpy(), ref["inst"])
    assert np.array_equal(hit.prim.numpy(), ref["prim"])
    m = ref["inst"] >= 0
    np.testing.assert_allclose(hit.t.numpy()[m], ref["t"][m], rtol=1e-6, atol=0)


def _jax_kernel(jhost, o, d, tm):
    """JAX's Pallas kernel in interpret mode.  unroll=1 (rows per loop
    trip; the result does not depend on it) keeps the interpreter at
    seconds where the default 8 takes minutes."""
    return jpi.traverse_instanced(jhost, o, d, tm, np.ones(len(o), bool),
                                  interpret=True, block_rays=1024, unroll=1)


def test_matches_jax_kernel_interpret(setup):
    """Against the Pallas kernel in interpret mode: inst and prim equal, t
    within rtol 5e-6 (XLA's CPU backend contracts multiply-adds into FMAs,
    the port rounds every op separately)."""
    jhost, host, (o, d, tm) = setup
    jh = _jax_kernel(jhost, o, d, tm)
    hit = _trace(host, o, d, tm)
    assert np.array_equal(hit.inst.numpy(), np.asarray(jh.inst))
    assert np.array_equal(hit.prim.numpy(), np.asarray(jh.prim))
    m = hit.inst.numpy() >= 0
    np.testing.assert_allclose(hit.t.numpy()[m], np.asarray(jh.t)[m], rtol=5e-6, atol=0)


def test_any_hit_mode(setup):
    jhost, host, (o, d, _) = setup
    tm = np.full(len(o), 4.0, np.float32)
    ref = jpi.traverse_instanced_np(jhost, o, d, tm)
    hit = _trace(host, o, d, tm, any_hit=True)
    occluded = hit.prim.numpy() >= 0
    assert 0.05 < occluded.mean() < 0.95
    assert np.array_equal(occluded, ref["inst"] >= 0)


def test_inactive_rays_masked(setup):
    jhost, host, (o, d, tm) = setup
    act = np.zeros(len(o), bool)
    act[::2] = True
    hit = _trace(host, o, d, tm, act=act)
    assert (hit.inst.numpy()[~act] == -1).all()
    assert (hit.prim.numpy()[~act] == -1).all()
    ref = jpi.traverse_instanced_np(jhost, o[act], d[act], tm[act])
    assert np.array_equal(hit.inst.numpy()[act], ref["inst"])
    assert np.array_equal(hit.prim.numpy()[act], ref["prim"])


def test_forced_per_pair_sweep():
    """inst_cap=8 on a 40-row icosphere: lists overflow, and the port
    sweeps the overflowing instance's mesh only, where JAX sweeps every
    instance of the packet.  Lists are exact and rows keep leaf order
    either way, so the winners equal the oracle's and JAX's."""
    ico, plane = make_icosphere(2), make_plane()
    jhost, host = _build([(ico.v0, ico.v1, ico.v2),
                          (plane.v0, plane.v1, plane.v2)], cap=8)
    assert host.trace.meta.n_rows[0] == 40 and host.trace.meta.caps[0] == 8
    o, d, tm = _rays()
    args = [torch.from_numpy(x) for x in (o, d, tm)]
    _, _, counts = instanced.prepare(host.trace, *args,
                                     torch.ones(len(o), dtype=torch.bool), 256)
    assert (counts < 0).any() and (counts > 0).any()
    hit = _trace(host, o, d, tm)
    ref = jpi.traverse_instanced_np(jhost, o, d, tm)
    assert np.array_equal(hit.inst.numpy(), ref["inst"])
    assert np.array_equal(hit.prim.numpy(), ref["prim"])
    jh = _jax_kernel(jhost, o, d, tm)
    assert np.array_equal(hit.inst.numpy(), np.asarray(jh.inst))
    assert np.array_equal(hit.prim.numpy(), np.asarray(jh.prim))


# PureScene fields that hold one entry (or row) per instance.
PER_INSTANCE = ("inst_obj_base", "inst_fwd", "inst_tri_offset",
                "inst_tri_count", "inst_area", "inst_material")
PER_INSTANCE_TRACE = ("inv", "inst_lo", "inst_hi", "segs", "caps", "mesh_insts")


def _bytes(ts: PureScene):
    """(bytes of the per-instance tensors, bytes of everything else)."""
    per, rest = 0, 0
    tensors = [(f, getattr(ts, f)) for f in PureScene._fields if f != "inst"]
    tensors += [(f, x) for f in ts.inst._fields if f != "meta"
                for x in (lambda v: v if isinstance(v, tuple) else (v,))(getattr(ts.inst, f))]
    for f, x in tensors:
        if isinstance(x, torch.Tensor):
            n = x.numel() * x.element_size()
            if f in PER_INSTANCE or f in PER_INSTANCE_TRACE:
                per += n
            else:
                rest += n
    return per, rest


def test_pure_memory_is_o_unique_tris():
    """The stress scene (cube mesh) at 8 and 32 instances: the geometry
    tensors have equal bytes, and the growth is only the per-instance
    arrays, 164 bytes per instance (inverse and forward 3x4, world AABB,
    segment row, list cap, id in its mesh's instance list, obj base, tri
    offset and count, area, material)."""
    scenes = {n: compile_scene(builtin.make_instanced_stress_scene(n, mesh_name="cube.obj"),
                               CPU, two_level="pure") for n in (8, 32)}
    (per8, geo8), (per32, geo32) = _bytes(scenes[8]), _bytes(scenes[32])
    assert geo8 == geo32
    per_inst = (per32 - per8) // 24
    assert per32 - per8 == 24 * per_inst and per_inst == 164
    assert per8 == (8 + 2) * per_inst
