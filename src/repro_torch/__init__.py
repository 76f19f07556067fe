"""PyTorch/CUDA port of the online cascade learning system.

A second package beside the JAX reference (``repro``), mirroring its
layout so each module's counterpart is found at the same path:

  core/      Algorithm 1 (``OnlineCascade``), the batched serving engine,
             deferral gates, experts, the per-tick RNG discipline
  data/      synthetic streams + featurizers (numpy)
  optim/     functional Adam / OGD over dict parameter trees
  models/    students (LR, the kernel-path tinytf_flash and ssm levels)
  kernels/   hand-written CUDA kernels for Hopper (flash attention,
             decode attention, SSD scan), each with a plain PyTorch twin
  launch/    ``python -m repro_torch.launch.serve``

The port imports ``torch``, ``numpy`` and the standard library only —
never ``jax`` and nothing of ``repro``.  Entry points run on the CUDA
device unless the caller passes ``device="cpu"`` (``device.py``).
"""
