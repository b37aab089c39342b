"""surf_tpu_torch — the PyTorch/CUDA port of the surf_tpu path tracer.

Mirrors ``surf_tpu``'s module names so each counterpart is easy to find:

- ``core``      — bit-exact WangHash/xorshift32 RNG on int64-held uint32
                  seeds, 3-vector math, rejection samplers, host transforms.
- ``scene``     — the NumPy scene-description layer (meshes, materials,
                  instances, built-in scenes, camera) and the compiler that
                  builds a flattened ``TorchScene`` or a pure two-level
                  ``PureScene`` on a given device.
- ``accel``     — the SAH builder and leaf-table packer, the ``bitsru8``
                  traversal and the pure two-level instanced traversal,
                  with their hand-written Hopper kernels
                  (``csrc/leaf_rows.cu``, ``csrc/inst_rows.cu``).
- ``wavefront`` — the wavefront integrator: raygen, extend, shade, NEE,
                  compaction and the width ladder, driven from the host.
- ``micro``     — microbenchmarks of the card's mechanisms (``dep_chain``:
                  the dependent-cursor chain, ``csrc/dep_micro.cu``).

The package imports ``torch``, ``numpy`` and the standard library, and
nothing of ``surf_tpu`` or ``jax``.
"""
