"""Public decode-attention op (port of
``repro.kernels.decode_attention.ops``).

Same signature as the reference op.  A CUDA tensor launches the
hand-written kernel (or raises); a CPU tensor runs the plain twin
``ref.decode_attention_ref``.  A ``meta`` tensor (the dry-run's count)
goes the CUDA tensor's way, through the kernel's shape function
``kernel.decode_attention_meta``; it holds no data, so this is no
fall-back.  No training path decodes, so a CUDA or ``meta`` call that
needs a gradient raises rather than return a tensor cut off from the
autograd graph.  A (W,) ``pos`` is broadcast to (B, W) —
as a zero-stride view on the CUDA path, which the kernel reads through
its strides.  ``block_kv`` is accepted for the reference signature; the
CUDA tiles and the split of the cache across blocks are the kernel's own
(``kernel.num_splits``).
"""
from __future__ import annotations

import torch

from repro_torch.kernels.autograd import needs_grad
from repro_torch.kernels.decode_attention.kernel import (
    decode_attention_cuda, decode_attention_meta)
from repro_torch.kernels.decode_attention.ref import decode_attention_ref


def decode_attention(q, k, v, pos, *, block_kv: int = 512) -> torch.Tensor:
    """q: (B, 1, H, hd) one new token; k, v: (B, W, K, hd) ring cache;
    pos: (W,) or (B, W) slot positions (-1 empty).  Returns (B, 1, H, hd).
    """
    del block_kv               # TPU VMEM tiling; the CUDA tiles are fixed
    B, _, H, hd = q.shape
    K = k.shape[2]
    if pos.ndim == 1:
        pos = pos[None].expand(B, pos.shape[0])
    if q.device.type != "cpu":
        if needs_grad(q, k, v):
            raise RuntimeError(
                "decode_attention has no gradient off the CPU: its kernel "
                "is forward-only and no training path decodes; run it "
                "under torch.no_grad() or on detached inputs")
        kernel = decode_attention_meta if q.is_meta else decode_attention_cuda
        return kernel(q, k, v, pos, sm_scale=hd ** -0.5)
    qg = q[:, 0].reshape(B, K, H // K, hd)
    out = decode_attention_ref(qg, k, v, pos, sm_scale=hd ** -0.5)
    return out.reshape(B, 1, H, hd)
