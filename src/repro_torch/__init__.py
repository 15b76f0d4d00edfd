"""PyTorch/CUDA port of the many-ported shared-memory fabric simulator.

A second package beside the JAX reference ``repro``.  It imports ``torch``
and ``numpy`` only, never ``jax`` or ``repro``, and runs on an NVIDIA Hopper
card; its tests pass ``device="cpu"``.  See ``core.simulator.simulate``.
"""
