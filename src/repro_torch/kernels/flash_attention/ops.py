"""Public flash-attention op (port of ``repro.kernels.flash_attention.ops``).

Same signature as the reference op, so the tests call both with the same
arguments.  A CUDA tensor launches the hand-written kernel (or raises) in
one of its three variants, which the launcher picks from the operands
(``kernel.select_variant``): ``"tc"`` (bf16 wgmma fed by TMA: the zoo),
``"tiled"`` (fp32 register tiles fed by cp.async: the cascade) or
``"simt"`` (scalar fp32 FMAs: every other case).  A CUDA call that
needs a gradient launches the kernel through ``kernels.autograd``, whose
backward is the twin's.  A CPU tensor runs the plain PyTorch twin
``ref.attention_ref`` — that is how the CPU tests run.  There is no
fall-back from one to the other.  A ``meta`` tensor (the dry-run's
count) goes the CUDA tensor's way, through the kernel's shape function
``kernel.flash_attention_meta``: a ``meta`` tensor holds no data, so
this is no fall-back either, and its backward is the twin's on ``meta``
as on the card.  The model layout (B, S, heads, hd) is read by the
kernel through strides, so there are no transposes and no TPU
pad-to-128 on the CUDA path.
``block_q`` / ``block_kv`` are accepted for the reference signature; the
CUDA tile is the kernel's own and the result does not depend on them.
"""
from __future__ import annotations

import functools
from typing import Optional

import torch

from repro_torch.kernels.autograd import with_twin_grad
from repro_torch.kernels.flash_attention.kernel import (
    flash_attention_cuda, flash_attention_meta)
from repro_torch.kernels.flash_attention.ref import attention_ref


def flash_attention(q, k, v, *, causal: bool = True,
                    window: Optional[int] = None,
                    block_q: int = 512, block_kv: int = 512) -> torch.Tensor:
    """q: (B, Sq, H, hd); k, v: (B, Skv, K, hd) -> (B, Sq, H, hd)."""
    del block_q, block_kv      # TPU VMEM tiling; the CUDA tile is fixed
    sm_scale = q.shape[-1] ** -0.5
    opts = dict(causal=causal, window=window, sm_scale=sm_scale)
    if q.device.type != "cpu":
        kernel = flash_attention_meta if q.is_meta else flash_attention_cuda
        return with_twin_grad(
            functools.partial(kernel, **opts),
            functools.partial(_twin, **opts), q, k, v)
    return _twin(q, k, v, **opts)


def _twin(q, k, v, **opts) -> torch.Tensor:
    """``attention_ref`` in the model layout (B, S, heads, hd)."""
    out = attention_ref(q.transpose(1, 2), k.transpose(1, 2),
                        v.transpose(1, 2), **opts)
    return out.transpose(1, 2)
