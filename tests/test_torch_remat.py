"""Per-wave rematerialisation (the integrator's ``_stepper``), vertex
gradients, detached traversal and the carrying of targets across
packages, for surf_tpu_torch's differentiable estimator on CPU.

- a bounce loop checkpoints its later waves (non-reentrantly) when its
  first wave's tape, times the waves, would take more than ``TAPE_SHARE``
  of the free memory: the tests force that side by reporting no free
  memory, and then the forward image and every gradient are bit-identical
  to the run without checkpoints (the per-lane arithmetic is the same;
  the backward only runs each wave again);
- vertex gradients flow through ``samp_*`` only, as in JAX
  (``tests/test_vertex_grads.py``): a rigid floor shift's AD against JAX's
  and against FD of a scene whose leaf rows are repacked at the shifted
  vertices, and the per-vertex gradient against JAX's;
- no traversal sees a tensor that requires grad;
- ``targets_from_arrays`` of JAX's ``DiffTargets`` leaves, and the port's
  ``finite_difference`` against JAX's on the same tree.
"""

import math
import warnings
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from surf_tpu.diff import DiffTargets as JDiffTargets
from surf_tpu.diff import finite_difference as jfinite_difference
from surf_tpu.scene import builtin as jbuiltin
from surf_tpu.scene.camera import CameraParams as JCameraParams
from surf_tpu.scene.compile import HostCompiled
from surf_tpu.wavefront import RenderConfig as JRenderConfig
from surf_tpu.wavefront.integrator import render_frame as jrender_frame
from surf_tpu_torch.accel.wide import build_leaf_table
from surf_tpu_torch.diff import (DiffTargets, apply_targets, finite_difference,
                                 grad_image_loss, render_image_diff, targets_from_arrays,
                                 tree_flatten)
from surf_tpu_torch.scene import builtin
from surf_tpu_torch.scene.camera import CameraParams
from surf_tpu_torch.scene.compile import compile_scene, from_render_scene, scene_arrays
from surf_tpu_torch.wavefront import integrator as wi

warnings.filterwarnings("ignore", category=RuntimeWarning)
torch.set_num_threads(1)

CPU = torch.device("cpu")
W = H = 16


@pytest.fixture(scope="module")
def box():
    ts = compile_scene(builtin.make_diffuse_box_scene(), CPU)
    cam = CameraParams.from_camera(builtin.make_indoor_camera(W, H), CPU)
    return ts, DiffTargets.from_scene(ts, cam)


def _frame_grads(ts, cfg, targets, free=None):
    """(image, loss, gradients, waves run, waves checkpointed) of the mean
    radiance a sample through render_frame (``render_image_diff``'s
    arithmetic, with or without a bounce cap), the device reporting
    ``free`` bytes free if given (0: a card under load, so every loop
    with a tape checkpoints its later waves).  The waves run count the
    forward's and the backward's."""
    leaves, unflatten = tree_flatten(targets)
    leaves = [x.detach().clone().requires_grad_(True) for x in leaves]
    t = unflatten(leaves)
    waves, checkpoints = [], []
    wave, checkpoint = wi._wave, torch.utils.checkpoint.checkpoint

    def counted(*args):
        waves.append(args[2])
        return wave(*args)

    def counted_checkpoint(*args, **kw):
        checkpoints.append(args[3])
        return checkpoint(*args, **kw)

    free_bytes = wi._free_bytes if free is None else (lambda device: free)
    with mock.patch.object(wi, "_wave", counted), \
            mock.patch.object(torch.utils.checkpoint, "checkpoint", counted_checkpoint), \
            mock.patch.object(wi, "_free_bytes", free_bytes):
        img = wi.render_frame(apply_targets(ts, t), cfg, t.camera, 0, CPU)
        img = img / img.new_tensor(float(cfg.spp))
        loss = img.mean()
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    return img.detach(), loss.detach(), grads, len(waves), len(checkpoints)


@pytest.mark.parametrize("bounces", [12, None])
def test_remat_gradients_bit_equal(box, bounces):
    """Checkpointed waves against plain ones, with compaction every 2
    waves: the loss and every gradient leaf bit-equal, through the
    max_bounces loop and through the live-count loop (``_run_waves``, wave
    cap 12).  At this size the host's free memory leaves every wave plain;
    with none free, each spp's loop runs its first wave plain and
    checkpoints the rest, which run again in the backward (the reentrant
    checkpoint fails here: it takes no PathState and drops the
    closed-over material gradients)."""
    ts, targets = box
    cfg = wi.RenderConfig.for_scene(ts, W, H, 2, use_defocus=True)._replace(
        compact=True, compact_every=2, max_bounces=bounces, wave_limit=12)
    _, loss, grads, n, n_ckpt = _frame_grads(ts, cfg, targets)
    _, loss_r, grads_r, n_r, n_ckpt_r = _frame_grads(ts, cfg, targets, free=0)
    assert torch.equal(loss, loss_r)
    assert n_ckpt == 0 and n > cfg.spp
    assert n_ckpt_r == n - cfg.spp and n_r == n + n_ckpt_r
    for k, (g, g_r) in enumerate(zip(grads, grads_r)):
        if g is None:
            assert g_r is None, k
        else:
            assert torch.equal(g, g_r), k
    assert grads[0] is not None and grads[0].abs().sum() > 0
    if bounces is not None:
        with mock.patch.object(wi, "_free_bytes", lambda device: 0):
            lr, gr = grad_image_loss(ts, cfg, targets, 0, CPU)
        assert torch.equal(lr, loss_r)
        for g, g_r in zip(tree_flatten(gr)[0], grads_r):
            assert torch.equal(g, torch.zeros_like(g) if g_r is None else g_r)


def test_remat_forward_image_bit_identical(box):
    """The bench's lane knobs (Morton lanes, compaction every 16 waves,
    2048-ray packets) at max_bounces 12: the image with checkpointed waves
    and targets on the tape equals the image without either."""
    ts, targets = box
    cfg = wi.RenderConfig.for_scene(ts, W, H, 2, use_defocus=True)._replace(
        **wi.BENCH_KNOBS)._replace(max_bounces=12)
    img_r, *_, n_ckpt = _frame_grads(ts, cfg, targets, free=0)
    assert n_ckpt == 2 * 11
    with torch.no_grad():
        img = render_image_diff(ts, cfg, targets, 0, CPU)
    assert torch.equal(img, img_r)


def test_remat_threshold(box):
    """The decision: the first wave's tape is counted (nothing under
    no_grad), and a loop checkpoints its later waves exactly when that
    tape times the waves after it exceeds TAPE_SHARE of the free memory."""
    ts, targets = box
    cfg = wi.RenderConfig.for_scene(ts, W, H, 1, use_defocus=True)._replace(max_bounces=4)
    taped, taped_wave = [], wi._taped_wave

    def spy(*args):
        s, n = taped_wave(*args)
        taped.append(n)
        return s, n

    with mock.patch.object(wi, "_taped_wave", spy):
        with torch.no_grad():
            render_image_diff(ts, cfg, targets, 0, CPU)
        assert _frame_grads(ts, cfg, targets)[-1] == 0
    assert taped[0] == 0 and taped[1] > 0
    edge = math.ceil(taped[1] * (cfg.max_bounces - 1) / wi.TAPE_SHARE)
    assert _frame_grads(ts, cfg, targets, free=edge)[-1] == 0
    assert _frame_grads(ts, cfg, targets, free=edge - 1)[-1] == cfg.max_bounces - 1


def _floor_rows(ts):
    o, c = int(ts.inst_tri_offset[0]), int(ts.inst_tri_count[0])
    mask = np.zeros((ts.samp_v0.shape[0], 1), np.float32)
    mask[o:o + c] = 1.0
    return mask


def _jax_box(w, h, bounces):
    host = HostCompiled(jbuiltin.make_diffuse_box_scene())
    cfg = JRenderConfig.for_scene(host.static, w, h, 1, use_defocus=True)._replace(
        max_bounces=bounces)
    return host.render_scene, cfg, JCameraParams.from_camera(jbuiltin.make_indoor_camera(w, h))


def test_vertex_gradient_matches_fd():
    """tests/test_vertex_grads.py:28: the floor slab moved by dy along y.
    AD flows through samp_* only (the traversal's tables do not move):
    within 1e-4 relative of JAX's AD on the same inputs.  The FD scenes
    repack the leaf rows at the moved vertices, so each is a consistent
    world: the best of three step sizes within 0.5 |AD| + 1e-4."""
    w = h = 12
    host = builtin.make_diffuse_box_scene()
    ts = compile_scene(host, CPU)
    cam = CameraParams.from_camera(builtin.make_indoor_camera(w, h), CPU)
    cfg = wi.RenderConfig.for_scene(ts, w, h, 1, use_defocus=True)._replace(max_bounces=6)
    mask = _floor_rows(ts)
    dy_vec = np.asarray([0.0, 1.0, 0.0], np.float32)

    dy = torch.zeros((), requires_grad=True)
    shift = torch.as_tensor(mask) * dy * torch.as_tensor(dy_vec)
    moved = ts._replace(**{f"samp_v{k}": getattr(ts, f"samp_v{k}") + shift for k in range(3)})
    (ad,) = torch.autograd.grad(wi.render_frame(moved, cfg, cam, 0, CPU).mean(), dy)
    ad = float(ad)
    assert np.isfinite(ad) and ad != 0.0

    base, jcfg, jcam = _jax_box(w, h, 6)
    jshift = jnp.asarray(mask) * jnp.asarray(dy_vec)

    def jloss(d):
        return jnp.mean(jrender_frame(base._replace(**{
            f"samp_v{k}": getattr(base, f"samp_v{k}") + d * jshift for k in range(3)}),
            jcfg, jcam, jnp.uint32(0)))

    jad = float(jax.jit(jax.grad(jloss))(jnp.float32(0.0)))
    assert abs(ad - jad) <= 1e-4 * abs(jad), (ad, jad)

    arrays = scene_arrays(host)
    perm = arrays["perm"].astype(np.int64)

    def loss(d):
        a = dict(arrays)
        s = mask * np.float32(d) * dy_vec
        for k in range(3):
            a[f"samp_v{k}"] = arrays[f"samp_v{k}"] + s
        lt = build_leaf_table(*(a[f"samp_v{k}"][perm] for k in range(3)))
        a.update(wide_ltab=lt.table, wide_ltabw=lt.tablew, wide_box_lo=lt.box_lo.T.copy(),
                 wide_box_hi=lt.box_hi.T.copy(), wide_anc=lt.anc)
        with torch.no_grad():
            return float(wi.render_frame(from_render_scene(a, CPU), cfg, cam, 0, CPU).mean())

    assert loss(0.0) == float(wi.render_frame(ts, cfg, cam, 0, CPU).mean())
    fds = [(loss(e) - loss(-e)) / (2 * e) for e in (1e-3, 5e-4, 2e-4)]
    assert min(abs(fd - ad) for fd in fds) < 0.5 * abs(ad) + 1e-4, (fds, ad)


def test_per_vertex_gradient_plumbing():
    """tests/test_vertex_grads.py:76: the gradient of the mean radiance
    with respect to every samp_v0 row is finite and not all zero, and
    within rtol 1e-4 plus 1e-6 of its largest |g| of JAX's on the same
    inputs (the two packages order the rows alike)."""
    w = h = 8
    ts = compile_scene(builtin.make_diffuse_box_scene(), CPU)
    cam = CameraParams.from_camera(builtin.make_indoor_camera(w, h), CPU)
    cfg = wi.RenderConfig.for_scene(ts, w, h, 1, use_defocus=True)._replace(max_bounces=4)
    v0 = ts.samp_v0.clone().requires_grad_(True)
    (g,) = torch.autograd.grad(
        wi.render_frame(ts._replace(samp_v0=v0), cfg, cam, 0, CPU).mean(), v0)
    assert torch.isfinite(g).all() and g.abs().sum() > 0

    base, jcfg, jcam = _jax_box(w, h, 4)
    assert np.array_equal(np.asarray(base.samp_v0), ts.samp_v0.numpy())
    jg = np.asarray(jax.jit(jax.grad(lambda v: jnp.mean(jrender_frame(
        base._replace(samp_v0=v), jcfg, jcam, jnp.uint32(0)))))(base.samp_v0), np.float64)
    np.testing.assert_allclose(g.double().numpy(), jg, rtol=1e-4, atol=1e-6 * np.abs(jg).max())


def test_traversal_sees_no_grad(box):
    """A spy on integrator._traverse during grad_image_loss (closest and
    any-hit calls): no ray input and no traversal table requires grad,
    and no hit comes back on autograd's tape."""
    ts, targets = box
    cfg = wi.RenderConfig.for_scene(ts, W, H, 1, use_defocus=True)._replace(max_bounces=4)
    seen = []
    traverse = wi._traverse

    def spy(scene, cfg, origin, direction, t_max, active, any_hit):
        tables = [x for x in scene.trace if isinstance(x, torch.Tensor)]
        seen.append((any_hit, [x.requires_grad for x in (origin, direction, t_max, active,
                                                         *tables)]))
        hit, inst = traverse(scene, cfg, origin, direction, t_max, active, any_hit)
        assert not any(x.requires_grad for x in hit)
        return hit, inst

    with mock.patch.object(wi, "_traverse", spy):
        _, grads = grad_image_loss(ts, cfg, targets, 0, CPU)
    assert grads.albedo.abs().sum() > 0
    assert {a for a, _ in seen} == {False, True}
    assert not any(any(flags) for _, flags in seen)


def test_targets_from_arrays_and_fd_order(box):
    """JAX's DiffTargets.from_scene leaves as NumPy arrays, keyed by JAX's
    field names, give the port's from_scene exactly; the port's flattening
    order is JAX's; and the port's finite_difference equals JAX's on the
    same tree and function, leaf by leaf, also for a subset by index."""
    ts, targets = box
    host = HostCompiled(jbuiltin.make_diffuse_box_scene())
    jt = JDiffTargets.from_scene(
        host.render_scene, JCameraParams.from_camera(jbuiltin.make_indoor_camera(W, H)))
    arrays = {f: np.asarray(getattr(jt, f)) for f in JDiffTargets._fields if f != "camera"}
    arrays.update({f"camera.{f}": np.asarray(getattr(jt.camera, f))
                   for f in JCameraParams._fields})
    got = targets_from_arrays(arrays, CPU)
    ours, jleaves = tree_flatten(got)[0], jax.tree.leaves(jt)
    assert len(ours) == len(jleaves) == 10
    for a, b, c in zip(ours, tree_flatten(targets)[0], jleaves):
        assert torch.equal(a, b) and np.array_equal(a.numpy(), np.asarray(c))

    def f(t):
        return sum((k + 1) * float((x.double() ** 2).sum())
                   for k, x in enumerate(tree_flatten(t)[0]))

    def jf(t):
        return sum((k + 1) * float((np.asarray(x, np.float64) ** 2).sum())
                   for k, x in enumerate(jax.tree.leaves(t)))

    for idx in (None, [(0, (1, 2)), (3, (0, 0)), (7, ())]):
        fd = tree_flatten(finite_difference(f, targets, 1e-3, idx))[0]
        jfd = jax.tree.leaves(jfinite_difference(jf, jt, 1e-3, idx))
        for k, (a, b, x) in enumerate(zip(fd, jfd, ours)):
            assert a.dtype == np.float64 and a.shape == np.shape(b)
            np.testing.assert_allclose(a, b, rtol=1e-12, atol=1e-12)
            want = 2 * (k + 1) * x.double().numpy()  # d/dx of (k + 1) x^2
            probed = np.zeros(a.shape, bool)
            for e in np.ndindex(a.shape):
                probed[e] = idx is None or (k, e) in idx
            np.testing.assert_allclose(a, np.where(probed, want, 0.0), rtol=1e-3, atol=1e-3)


def test_render_image_diff_needs_max_bounces(box):
    """JAX asserts a static bounce cap; the port raises."""
    ts, targets = box
    cfg = wi.RenderConfig.for_scene(ts, W, H, 1, use_defocus=True)
    with pytest.raises(ValueError, match="max_bounces"):
        render_image_diff(ts, cfg, targets, 0, CPU)
