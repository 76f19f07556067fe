"""Hand-written Hopper (sm_90a) CUDA kernels for the serving hot spots,
ported from the TPU kernels of ``repro.kernels``:

  flash_attention/  — prefill attention, causal + sliding-window + GQA
  decode_attention/ — single-token GQA attention over a (ring) KV cache
  ssd_scan/         — Mamba2 chunked state-space-dual scan

Each package ships three files, as in the reference:
  kernel.py — the ctypes launcher of the CUDA source in ``csrc/`` (with
              its launch counter)
  ops.py    — the public op with the reference's signature: a CUDA
              tensor launches the kernel or raises, a CPU tensor runs the
              plain twin
  ref.py    — the plain PyTorch twin, held against the JAX ``ref.py`` on
              the CPU and against the kernel on the card

``_build.py`` compiles ``csrc/*.cu`` with nvcc at first use.  The TPU
``moe_gmm`` kernel has no consumer on the cascade path and is not ported
yet (ROADMAP).
"""
