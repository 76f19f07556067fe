"""Hand-written Hopper (sm_90a) CUDA kernels for the serving hot spots,
ported from the TPU kernels of ``repro.kernels``:

  flash_attention/  — prefill attention, causal + sliding-window + GQA
  decode_attention/ — single-token GQA attention over a (ring) KV cache
  ssd_scan/         — Mamba2 chunked state-space-dual scan
  moe_gmm/          — grouped expert matmul (E, C, D) x (E, D, F) of the
                      MoE FFN

Each package ships three files, as in the reference:
  kernel.py — the ctypes launcher of the CUDA source in ``csrc/`` (with
              its launch counter)
  ops.py    — the public op with the reference's signature (less
              ``moe_gmm``'s TPU tiling arguments): a CUDA tensor launches
              the kernel or raises, a CPU tensor runs the plain twin, a
              ``meta`` tensor (the dry-run's count) runs the kernel's
              shape function (``*_meta`` in ``kernel.py``: the
              launcher's checks, variant, outputs and scratch, no data
              and no launch; no fall-back, since a ``meta`` tensor holds
              nothing to compute on)
  ref.py    — the plain PyTorch twin, held against the JAX ``ref.py`` on
              the CPU and against the kernel on the card

``moe_gmm`` and ``flash_attention`` each have two variants, picked by
their ``kernel.py`` ``select_variant`` from the operands: ``"tc"`` (bf16
wgmma fed by TMA; Hopper building blocks in ``csrc/sm90.cuh``) and
``"simt"`` (the scalar fp32 kernel: fp32, other head dims, rows TMA
cannot read); flash attention also ``"tiled"`` (fp32 register tiles).
The SSD scan has ``"whole"`` (a chunk of up to 64 tokens) and
``"parallel"`` (four chunk-parallel passes, the zoo's chunk 256).
``_build.py`` compiles ``csrc/*.cu`` with nvcc at first use.  Each
launch, on the card or in a ``meta`` shape function, reports its variant
and its cost (``metrics.roofline``) to the active
``metrics.cost.CostCounter``.  Every TPU
kernel of the reference has its counterpart here: the first three serve
the cascade's kernel ladder, all but the SSD scan the zoo's
Mixtral-8x22B, and the SSD scan the zoo's MAMBA blocks
(``models/transformer.py``).
"""
