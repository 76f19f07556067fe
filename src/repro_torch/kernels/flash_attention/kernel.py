"""Launcher of the CUDA flash-attention kernel
(``csrc/flash_attention.cu``; replaces the TPU kernel
``repro/kernels/flash_attention/kernel.py`` ``_flash_kernel``).

``flash_attention_cuda`` checks its inputs, picks the kernel's variant
from the operands (``select_variant``), allocates the output, and
launches on PyTorch's current stream; ``flash_attention_cuda.launches``
counts its launches (and nothing else), so a run can show that its
serving path went through the kernel; ``launches_by_variant`` splits
that count by variant."""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import _build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_VARIANTS = {"simt": 0, "tc": 1}
MAX_HEAD_DIM = 128
TC_HEAD_DIMS = (64, 128)


def select_variant(q, k, v) -> str:
    """``"tc"`` (bf16 wgmma fed by TMA) or ``"simt"`` (fp32 on the CUDA
    cores), from the operands' dtype, shapes, strides and base alignment
    alone: bf16 with head dim 64 or 128 that TMA can read takes the
    tensor cores; fp32 (the cascade's path: TF32 would miss its 2e-5
    tolerance), other head dims and unreadable strides take ``simt``."""
    if any(t.dtype != torch.bfloat16 for t in (q, k, v)):
        return "simt"
    if q.ndim != 4 or k.ndim != 4 or q.shape[-1] not in TC_HEAD_DIMS \
            or min(*q.shape, *k.shape) < 1:
        return "simt"
    return "tc" if all(map(_build.tma_readable, (q, k, v))) else "simt"


def flash_attention_cuda(q, k, v, *, causal: bool = True,
                         window: Optional[int] = None,
                         sm_scale: Optional[float] = None) -> torch.Tensor:
    """q: (B, Sq, H, hd); k, v: (B, Skv, K, hd) CUDA tensors of one dtype
    (fp32 or bf16), any strides; H % K == 0, hd <= 128.  Returns a
    contiguous (B, Sq, H, hd) tensor of q's dtype."""
    B, Sq, H, hd = q.shape
    Skv, K = k.shape[1], k.shape[2]
    if not (q.is_cuda and k.is_cuda and v.is_cuda):
        raise ValueError("flash_attention_cuda takes CUDA tensors")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention_cuda takes fp32 or bf16 q/k/v of "
                        f"one dtype, got {q.dtype}/{k.dtype}/{v.dtype}")
    if (k.shape != (B, Skv, K, hd) or v.shape != k.shape or K < 1
            or H % K):
        raise ValueError(f"bad shapes q{tuple(q.shape)} k{tuple(k.shape)} "
                         f"v{tuple(v.shape)}")
    if not 1 <= hd <= MAX_HEAD_DIM:
        raise ValueError(f"head dim {hd} outside [1, {MAX_HEAD_DIM}]")
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    sm_scale = sm_scale if sm_scale is not None else hd ** -0.5
    o = torch.empty((B, Sq, H, hd), dtype=q.dtype, device=q.device)
    if o.numel() == 0:
        return o
    variant = select_variant(q, k, v)
    ci = _build.c_int
    fn = _build.entry("repro_flash_attention_fwd", 4, 22, 1)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
             _DTYPES[q.dtype], ci(B), ci(Sq), ci(Skv), ci(H), ci(K), ci(hd),
             *(ci(s) for s in q.stride()), *(ci(s) for s in k.stride()),
             *(ci(s) for s in v.stride()), int(bool(causal)),
             ci(window or 0), _VARIANTS[variant], float(sm_scale),
             torch.cuda.current_stream(q.device).cuda_stream)
    _build.check("flash_attention", err)
    flash_attention_cuda.launches += 1
    flash_attention_cuda.launches_by_variant[variant] += 1
    return o


flash_attention_cuda.launches = 0
flash_attention_cuda.launches_by_variant = {"tc": 0, "simt": 0}
