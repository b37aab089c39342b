"""surf_tpu_torch — the PyTorch/CUDA port of the surf_tpu path tracer.

Mirrors ``surf_tpu``'s module names so each counterpart is easy to find:

- ``core``      — bit-exact WangHash/xorshift32 RNG on int64-held uint32
                  seeds, 3-vector math, rejection samplers, host transforms.
- ``scene``     — the NumPy scene-description layer (meshes, materials,
                  instances, built-in scenes, camera) and the compiler that
                  flattens a scene into a ``TorchScene`` on a given device.
- ``accel``     — the ``bitsru8`` traversal (row-box bits, hierarchical
                  AND, exact row lists) and the hand-written Hopper
                  leaf-row intersection kernel (``csrc/leaf_rows.cu``).
- ``wavefront`` — the wavefront integrator: raygen, extend, shade, NEE,
                  compaction and the width ladder, driven from the host.

The package imports ``torch`` and ``numpy`` and never ``jax``; the only
modules it borrows from ``surf_tpu`` are the JAX-free SAH builder and
leaf-table packer (``surf_tpu.accel.builder`` / ``surf_tpu.accel.wide``).
"""
