"""Launcher of the CUDA grouped-matmul kernel (``csrc/moe_gmm.cu``;
replaces the TPU kernel ``repro/kernels/moe_gmm/kernel.py``
``_gmm_kernel``).

``moe_gmm_cuda`` checks its inputs, picks the kernel's variant from the
operands (``select_variant``), allocates the output, and launches on
PyTorch's current stream; ``moe_gmm_cuda.launches`` counts its launches
(and nothing else), so a run can show that its MoE layers went through
the kernel, and ``moe_gmm_cuda.launches_by_variant`` splits that count
by variant.  ``moe_gmm_meta`` is the same call on the ``meta`` device
(checks, variant and output shape, no launch).  Both report each launch,
its variant and its cost (``metrics.roofline.gmm_cost``) to the active
``metrics.cost.CostCounter``."""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.metrics.cost import report_kernel
from repro_torch.metrics.roofline import gmm_cost

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_VARIANTS = {"simt": 0, "tc": 1}


def select_variant(x, w) -> str:
    """``"tc"`` (bf16 wgmma fed by TMA) or ``"simt"`` (fp32 FMAs on the
    CUDA cores), from the operands' dtype, shapes, strides and base
    alignment alone: bf16 that TMA can read takes the tensor cores; fp32
    (whose wgmma would be TF32, outside the fp32 tolerance), bf16 with a
    row TMA cannot read (e.g. D = 777) and empty shapes take ``simt``."""
    if x.dtype != torch.bfloat16 or w.dtype != torch.bfloat16:
        return "simt"
    if x.ndim != 3 or w.ndim != 3 or min(*x.shape, w.shape[2]) < 1:
        return "simt"
    readable = _build.tma_readable(x) and _build.tma_readable(w)
    return "tc" if readable else "simt"


def _plan(x, w):
    """The checks, the output and the variant of one call: what the
    launcher and the ``meta`` shape function share."""
    if x.dtype not in _DTYPES or w.dtype != x.dtype:
        raise TypeError(f"moe_gmm_cuda takes fp32 or bf16 x/w of one dtype, "
                        f"got {x.dtype}/{w.dtype}")
    if x.ndim != 3 or w.ndim != 3 or w.shape[:2] != (x.shape[0], x.shape[2]):
        raise ValueError(f"bad shapes x{tuple(x.shape)} w{tuple(w.shape)}")
    E, C, _ = x.shape
    o = torch.empty((E, C, w.shape[2]), dtype=x.dtype, device=x.device)
    return select_variant(x, w), o


def _report(x, w, variant):
    report_kernel("moe_gmm", variant, gmm_cost(x.shape, w.shape, x.dtype))


def moe_gmm_cuda(x, w) -> torch.Tensor:
    """x: (E, C, D); w: (E, D, F) CUDA tensors of one dtype (fp32 or
    bf16), any strides, any C / D / F.  Returns a contiguous (E, C, F)
    tensor of x's dtype (fp32 accumulation)."""
    if not (x.is_cuda and w.is_cuda):
        raise ValueError("moe_gmm_cuda takes CUDA tensors")
    variant, o = _plan(x, w)
    if o.numel() == 0:
        return o
    E, C, D = x.shape
    F = w.shape[2]
    ci = _build.c_int
    fn = _build.entry("repro_moe_gmm_fwd", 3, 12)
    err = fn(x.data_ptr(), w.data_ptr(), o.data_ptr(), _DTYPES[x.dtype],
             ci(E), ci(C), ci(D), ci(F), *(ci(s) for s in x.stride()),
             *(ci(s) for s in w.stride()), _VARIANTS[variant],
             torch.cuda.current_stream(x.device).cuda_stream)
    _build.check("moe_gmm", err)
    moe_gmm_cuda.launches += 1
    moe_gmm_cuda.launches_by_variant[variant] += 1
    _report(x, w, variant)
    return o


def moe_gmm_meta(x, w) -> torch.Tensor:
    """The kernel's shape function on the ``meta`` device: the launcher's
    checks, variant and (empty) output, and one launch of that variant
    reported to the active ``CostCounter``; no data, no device."""
    if not (x.is_meta and w.is_meta):
        raise ValueError("moe_gmm_meta takes meta tensors")
    variant, o = _plan(x, w)
    if o.numel():
        _report(x, w, variant)
    return o


moe_gmm_cuda.launches = 0
moe_gmm_cuda.launches_by_variant = {"tc": 0, "simt": 0}
