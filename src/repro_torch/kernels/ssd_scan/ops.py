"""Public SSD chunked-scan op (port of ``repro.kernels.ssd_scan.ops``).

Same signature as the reference op.  A CUDA tensor launches the
hand-written kernel (or raises); a CPU tensor runs the plain twin
``ref.ssd_scan_chunked_ref``.  As in the reference, ``chunk`` is min'd
to the sequence length, which must be a multiple of it.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.ssd_scan.kernel import ssd_scan_cuda
from repro_torch.kernels.ssd_scan.ref import ssd_scan_chunked_ref


def ssd_scan(x, adt, dt, B, C, *, chunk: int = 256) -> torch.Tensor:
    """Mamba2 SSD: x (Bsz,S,H,hp); adt/dt (Bsz,S,H); B/C (Bsz,S,N)."""
    S = x.shape[1]
    chunk = min(chunk, S)
    if S % chunk:
        raise ValueError(f"sequence {S} is not a multiple of chunk {chunk}")
    if x.device.type != "cpu":
        return ssd_scan_cuda(x, adt, dt, B, C, chunk=chunk)
    return ssd_scan_chunked_ref(x, adt, dt, B, C, chunk)
