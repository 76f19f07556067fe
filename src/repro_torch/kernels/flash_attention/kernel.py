"""Launcher of the CUDA flash-attention kernel
(``csrc/flash_attention.cu``; replaces the TPU kernel
``repro/kernels/flash_attention/kernel.py`` ``_flash_kernel``).

``flash_attention_cuda`` checks its inputs, allocates the output, and
launches on PyTorch's current stream; ``flash_attention_cuda.launches``
counts its launches (and nothing else), so a run can show that its
serving path went through the kernel."""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import _build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_HEAD_DIM = 128


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
    ci = _build.c_int
    fn = _build.entry("repro_flash_attention_fwd", 4, 21, 1)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
             _DTYPES[q.dtype], ci(B), ci(Sq), ci(Skv), ci(H), ci(K), ci(hd),
             *(ci(s) for s in q.stride()), *(ci(s) for s in k.stride()),
             *(ci(s) for s in v.stride()), int(bool(causal)),
             ci(window or 0), float(sm_scale),
             torch.cuda.current_stream(q.device).cuda_stream)
    _build.check("flash_attention", err)
    flash_attention_cuda.launches += 1
    return o


flash_attention_cuda.launches = 0
