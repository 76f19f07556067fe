"""Launcher of the CUDA SSD chunked-scan kernel (``csrc/ssd_scan.cu``;
replaces the TPU kernel ``repro/kernels/ssd_scan/kernel.py``
``_ssd_kernel``).

``ssd_scan_cuda.launches`` counts the kernel's launches and nothing
else."""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

MAX_SMEM_BYTES = 232_448   # Hopper's per-block dynamic shared memory


def _pad4(n: int) -> int:
    return -(-n // 4) * 4


def smem_bytes(hp: int, N: int, L: int) -> int:
    """Shared memory one block of the scan needs (mirrors the C side):
    x, B^T, C^T, the (L x L) scores, h^T and four L vectors, each
    dimension padded to a multiple of 4."""
    L4, P4, N4 = _pad4(L), _pad4(hp), _pad4(N)
    return 4 * (L4 * P4 + 2 * N4 * L4 + L4 * L4 + N4 * P4 + 4 * L4)


def ssd_scan_cuda(x, adt, dt, B, C, *, chunk: int) -> torch.Tensor:
    """x: (Bsz, S, H, hp); adt, dt: (Bsz, S, H); B, C: (Bsz, S, N); fp32
    CUDA tensors, any strides; S % chunk == 0.  Returns a contiguous
    (Bsz, S, H, hp) fp32 tensor."""
    Bsz, S, H, hp = x.shape
    N = B.shape[-1]
    if not all(t.is_cuda for t in (x, adt, dt, B, C)):
        raise ValueError("ssd_scan_cuda takes CUDA tensors")
    if any(t.dtype != torch.float32 for t in (x, adt, dt, B, C)):
        raise TypeError("ssd_scan_cuda takes fp32 inputs")
    if (adt.shape != (Bsz, S, H) or dt.shape != adt.shape
            or B.shape != (Bsz, S, N) or C.shape != B.shape):
        raise ValueError("bad SSD input shapes")
    if chunk < 1 or S % chunk:
        raise ValueError(f"sequence {S} is not a multiple of chunk {chunk}")
    need = smem_bytes(hp, N, chunk)
    if need > MAX_SMEM_BYTES:
        raise ValueError(f"chunk {chunk} x head dim {hp} x state {N} needs "
                         f"{need} B of shared memory (> {MAX_SMEM_BYTES})")
    y = torch.empty((Bsz, S, H, hp), dtype=torch.float32, device=x.device)
    if y.numel() == 0:
        return y
    ci = _build.c_int
    fn = _build.entry("repro_ssd_scan_fwd", 6, 24)
    err = fn(x.data_ptr(), adt.data_ptr(), dt.data_ptr(), B.data_ptr(),
             C.data_ptr(), y.data_ptr(), ci(Bsz), ci(S), ci(H), ci(hp),
             ci(N), ci(chunk), *(ci(s) for s in x.stride()),
             *(ci(s) for s in adt.stride()), *(ci(s) for s in dt.stride()),
             *(ci(s) for s in B.stride()), *(ci(s) for s in C.stride()),
             int(_build.rows16(x)),
             int(_build.rows16(B) and _build.rows16(C)),
             torch.cuda.current_stream(x.device).cuda_stream)
    _build.check("ssd_scan", err)
    ssd_scan_cuda.launches += 1
    return y


ssd_scan_cuda.launches = 0

