"""surf_tpu_torch — the PyTorch/CUDA port of the surf_tpu path tracer.

Mirrors ``surf_tpu``'s module names so each counterpart is easy to find:

- ``core``      — bit-exact WangHash/xorshift32 RNG on int64-held uint32
                  seeds, 3-vector math, rejection samplers, host transforms.
- ``scene``     — the NumPy scene-description layer (meshes, materials,
                  instances, built-in scenes, JSON scene files, camera) and
                  the compiler that builds a flattened ``TorchScene`` or a
                  pure two-level ``PureScene`` on a given device.
- ``accel``     — the SAH builder and leaf-table packer, and every
                  traversal a render can reach (the ``bits*`` family, the
                  8-wide stream walks, the binary walk, the pure two-level
                  instanced walk), each through its hand-written Hopper
                  kernels (``csrc/leaf_rows.cu``, ``inst_rows.cu``,
                  ``stream_walk_ilv.cu``, ``stream_walk_spec.cu``,
                  ``stream_walk_stack.cu``, ``bvh_walk_live.cu``; the
                  first designs in ``stream_walk.cu`` and ``bvh_walk.cu``).
- ``wavefront`` — the wavefront integrator: raygen, extend, shade, NEE,
                  compaction and the width ladder, driven from the host;
                  the frame entry points (``render_frame``,
                  ``render_frame_seeded``, cross-frame deferral with
                  ``render_frame_carry``, ``render_frame_instrumented``) and
                  the progressive accumulator.
- ``dist``      — data-parallel distribution over ``torch.distributed``
                  ranks: sharded frames and gradient steps, the process
                  group's start-up, local ranks for tests.
- ``app``       — the progressive renderer facade
                  (``app.renderer.WavefrontRenderer``) and the CLI
                  (``python -m surf_tpu_torch.app.cli``) with its config,
                  metrics, image output and profiling helpers.
- ``micro``     — microbenchmarks of the card's mechanisms, one module per
                  TPU script (``csrc/dep_micro.cu``, ``leaf_micro.cu``,
                  ``visit_micro.cu``, ``shape_micro.cu``, ``mxu_micro.cu``,
                  ``op_micro.cu``).
- ``bench``, ``breakdown`` — ``bench.py``'s configuration on the card, and
                  where a frame's device time goes.

The package imports ``torch``, ``numpy`` and the standard library, and
nothing of ``surf_tpu`` or ``jax``.
"""
