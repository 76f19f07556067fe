"""Launcher of the CUDA flash-attention kernel
(``csrc/flash_attention.cu``; replaces the TPU kernel
``repro/kernels/flash_attention/kernel.py`` ``_flash_kernel``).

``flash_attention_cuda`` checks its inputs, picks the kernel's variant
from the operands (``select_variant``: ``"tc"``, ``"tiled"`` or
``"simt"``), allocates the output, and launches on PyTorch's current
stream; ``flash_attention_cuda.launches`` counts its launches (one a
call, and nothing else), so a run can show that its serving path went
through the kernel; ``launches_by_variant`` splits that count by
variant.  ``flash_attention_meta`` is the same call on the ``meta``
device: checks, variant and output shape, no launch.  Both report each
launch, its variant and its cost (``metrics.roofline.flash_cost``) to
the active ``metrics.cost.CostCounter``."""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.metrics.cost import report_kernel
from repro_torch.metrics.roofline import flash_cost

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_VARIANTS = {"simt": 0, "tc": 1, "tiled": 2}
MAX_HEAD_DIM = 128
# hd 120 (h2o-danube-3-4b) runs the 128-wide instance: TMA zero-fills the
# columns past the real head dim (csrc/flash_attention.cu)
TC_HEAD_DIMS = (64, 120, 128)
TILED_HEAD_DIMS = (16, 32, 64, 128)


def _tc_ok(q, k, v) -> bool:
    """bf16 with a head dim in ``TC_HEAD_DIMS`` that TMA can read."""
    return (all(t.dtype == torch.bfloat16 for t in (q, k, v))
            and q.ndim == 4 and k.ndim == 4
            and q.shape[-1] in TC_HEAD_DIMS and min(*q.shape, *k.shape) >= 1
            and all(map(_build.tma_readable, (q, k, v))))


def _tiled_ok(q, k, v) -> bool:
    """fp32 with head dim 16 / 32 / 64 / 128 whose rows cp.async can copy
    16 bytes at a time: head dims contiguous, every other stride a
    multiple of 4 elements, 16-byte-aligned bases."""
    return (all(t.dtype == torch.float32 for t in (q, k, v))
            and q.ndim == 4 and k.ndim == 4
            and q.shape[-1] in TILED_HEAD_DIMS
            and min(*q.shape, *k.shape) >= 1
            and all(map(_build.rows16, (q, k, v))))


def select_variant(q, k, v) -> str:
    """``"tc"`` (bf16 wgmma fed by TMA), ``"tiled"`` (fp32 register tiles
    fed by cp.async) or ``"simt"`` (the scalar kernel), from the
    operands' dtype, shapes, strides and base alignment alone: bf16 with
    head dim 64, 120 or 128 that TMA can read takes the tensor cores; fp32
    (the cascade's path: TF32 would miss its 2e-5 tolerance) with head
    dim 16 / 32 / 64 / 128 and 16-byte rows takes ``tiled``; other head
    dims and unreadable strides or bases take ``simt``."""
    if _tc_ok(q, k, v):
        return "tc"
    return "tiled" if _tiled_ok(q, k, v) else "simt"


def launch_choice(q, k, v, variant: Optional[str] = None) -> str:
    """The variant a launch takes: ``select_variant``'s unless forced.  A
    forced variant the operands do not allow raises."""
    if variant is None:
        return select_variant(q, k, v)
    if variant not in _VARIANTS or (
            variant == "tc" and not _tc_ok(q, k, v)) or (
            variant == "tiled" and not _tiled_ok(q, k, v)):
        raise ValueError(f"variant {variant!r} cannot take these operands")
    return variant


def _plan(q, k, v, causal, window, variant):
    """The checks, the variant and the output of one call: what the
    launcher and the ``meta`` shape function share."""
    B, Sq, H, hd = q.shape
    Skv, K = k.shape[1], k.shape[2]
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
    variant = launch_choice(q, k, v, variant)
    o = torch.empty((B, Sq, H, hd), dtype=q.dtype, device=q.device)
    return variant, o


def _report(q, k, variant, causal, window):
    report_kernel("flash_attention", variant,
                  flash_cost(q.shape, k.shape, q.dtype, causal, window))


def flash_attention_cuda(q, k, v, *, causal: bool = True,
                         window: Optional[int] = None,
                         sm_scale: Optional[float] = None,
                         variant: Optional[str] = None) -> torch.Tensor:
    """q: (B, Sq, H, hd); k, v: (B, Skv, K, hd) CUDA tensors of one dtype
    (fp32 or bf16), any strides; H % K == 0, hd <= 128.  Returns a
    contiguous (B, Sq, H, hd) tensor of q's dtype.  ``variant`` forces a
    variant, for measuring and testing the alternatives; one the operands
    do not allow raises, and nothing falls back."""
    if not (q.is_cuda and k.is_cuda and v.is_cuda):
        raise ValueError("flash_attention_cuda takes CUDA tensors")
    variant, o = _plan(q, k, v, causal, window, variant)
    if o.numel() == 0:
        return o
    B, Sq, H, hd = q.shape
    Skv, K = k.shape[1], k.shape[2]
    sm_scale = sm_scale if sm_scale is not None else hd ** -0.5
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
    _report(q, k, variant, causal, window)
    return o


def flash_attention_meta(q, k, v, *, causal: bool = True,
                         window: Optional[int] = None,
                         sm_scale: Optional[float] = None,
                         variant: Optional[str] = None) -> torch.Tensor:
    """The kernel's shape function on the ``meta`` device: the launcher's
    checks, variant and (empty) output, and one launch of that variant
    reported to the active ``CostCounter``; no data, no device."""
    del sm_scale
    if not (q.is_meta and k.is_meta and v.is_meta):
        raise ValueError("flash_attention_meta takes meta tensors")
    variant, o = _plan(q, k, v, causal, window, variant)
    if o.numel():
        _report(q, k, variant, causal, window)
    return o


flash_attention_cuda.launches = 0
flash_attention_cuda.launches_by_variant = {"tc": 0, "simt": 0, "tiled": 0}
