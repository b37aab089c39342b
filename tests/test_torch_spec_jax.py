"""The emulated decomposition of the speculative window walks' kernel
(tests/test_torch_spec_split.py ``spec_emulation``) against ``surf_tpu``'s
Pallas walks for spec4 and specb8 on the box scene, in interpret mode,
with the gates of tests/test_torch_schedules.py.  Apart from the
emulation's other cases, whose file imports no JAX: JAX's interpret-mode
compile of the two walks takes most of this file's time.
"""

import warnings
from unittest import mock

import jax.numpy as jnp
import numpy as np
import torch

from surf_tpu.accel.pallas_wide import device_wide_trace, traverse_wide
from surf_tpu.scene import builtin as jbuiltin
from surf_tpu.scene.compile import HostCompiled
from surf_tpu_torch.accel import stream
from surf_tpu_torch.accel.bits import nudge
from surf_tpu_torch.accel.stream import pack_rays, traverse_stream
from surf_tpu_torch.accel.stream_walk import stream_walk_plain
from surf_tpu_torch.scene import builtin
from surf_tpu_torch.scene.compile import compile_scene

from test_torch_spec_split import spec_emulation

warnings.filterwarnings("ignore", category=RuntimeWarning)
torch.set_num_threads(1)

CPU = torch.device("cpu")


def test_spec_emulation_matches_jax():
    """Box scene, 2048 rays in 1024-ray packets, closest hit: the emulation
    through traverse_stream against surf_tpu's spec4 and specb8 Pallas walks
    in interpret mode, hits and per-packet visits
    (tests/test_torch_schedules.py test_schedule_matches_jax's rays and
    gates)."""
    host = HostCompiled(jbuiltin.make_diffuse_box_scene())
    wt = device_wide_trace(host._ws)
    ts = compile_scene(builtin.make_diffuse_box_scene(), CPU)
    n = 2048
    rng = np.random.default_rng(7)
    o = rng.uniform(-6, 6, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    d[:3] = [[1, 0, 0], [0, -1, 0], [0, 0, 1]]
    tmax = np.full(n, 1e30, np.float32)
    act = np.ones(n, bool)
    act[::7] = False
    port = [torch.from_numpy(x) for x in (o, d, tmax, act)]
    jax_in = [jnp.asarray(x) for x in (o, d, tmax, act)]
    rays, a = pack_rays(port[0], nudge(port[1]), port[2], port[3], 1024)

    def emulated(stream_t, rays, a, block_rays, algo, any_hit, max_depth):
        return spec_emulation(stream_t, rays, a, block_rays, algo, any_hit)

    for algo in ("spec4", "specb8"):
        kw = dict(block_rays=1024, algo=algo)
        with mock.patch.object(stream, "stream_walk", emulated):
            got = traverse_stream(ts.stream, *port, **kw)
            visits = traverse_stream(ts.stream, *port, return_visits=True, **kw)
        want = traverse_wide(wt, *jax_in, interpret=True, **kw)
        want_visits = traverse_wide(wt, *jax_in, interpret=True, return_visits=True, **kw)
        gp, wp = got.prim.numpy(), np.asarray(want.prim)
        gt, wt_ = got.t.numpy(), np.asarray(want.t)
        assert (gp[~act] == -1).all() and (gp >= 0).any()
        assert np.array_equal(gp >= 0, wp >= 0)
        assert ((gp == wp) | (gt == wt_)).all()
        both = (gp >= 0) & (wp >= 0)
        np.testing.assert_allclose(gt[both], wt_[both], rtol=5e-6)
        assert np.array_equal(visits.numpy(), np.asarray(want_visits))
        # the emulation equals the plain walk bit for bit on the same packets
        for x, y in zip(spec_emulation(ts.stream.stream, rays, a, 1024, algo),
                        stream_walk_plain(ts.stream.stream, rays, a, 1024, algo)):
            assert torch.equal(x, y)
