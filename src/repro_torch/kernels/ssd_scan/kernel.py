"""Launcher of the CUDA SSD chunked-scan kernel (``csrc/ssd_scan.cu``;
replaces the TPU kernel ``repro/kernels/ssd_scan/kernel.py``
``_ssd_kernel``).

Two variants, picked by ``select_variant`` from the shapes alone:
``"whole"`` keeps a chunk of up to ``TILE`` tokens whole in shared
memory (the cascade's chunk 64), ``"subtile"`` walks a longer chunk in
sub-tiles of ``TILE`` tokens (the zoo's chunk 256 at state 128).  Both
run the chunk asked for; neither re-chunks.  ``ssd_scan_cuda.launches``
counts the kernel's launches and nothing else,
``ssd_scan_cuda.launches_by_variant`` splits that count."""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import _build

MAX_SMEM_BYTES = 232_448   # Hopper's per-block dynamic shared memory
THREADS = 256              # a block's threads (csrc/ssd_scan.cu)
TILE = 64                  # tokens of a sub-tile, and "whole"'s longest chunk
_VARIANTS = {"whole": 0, "subtile": 1}


def _pad(n: int, m: int) -> int:
    return -(-n // m) * m


def smem_bytes(hp: int, N: int, L: int, variant: str = "whole") -> int:
    """Shared memory one block of the scan needs (mirrors the C side).
    ``"whole"``: x, B^T, C^T, the (L x L) scores, h^T and four L vectors,
    each dimension padded to a multiple of 4; ``"subtile"``: h^T, four
    chunk vectors (L padded to whole sub-tiles), C_I^T, B_J^T, x_J and
    S_IJ^T, the state padded to a multiple of 8."""
    P4 = _pad(hp, 4)
    if variant == "subtile":
        N8, LT = _pad(N, 8), _pad(L, TILE)
        return 4 * (N8 * P4 + 4 * LT + 2 * N8 * TILE + TILE * P4
                    + TILE * TILE)
    L4, N4 = _pad(L, 4), _pad(N, 4)
    return 4 * (L4 * P4 + 2 * N4 * L4 + L4 * L4 + N4 * P4 + 4 * L4)


def _takes(variant: str, hp: int, N: int, L: int) -> bool:
    """Whether ``variant`` can run the shape: ``"whole"`` within shared
    memory, ``"subtile"`` also with head dims up to ``TILE`` and one
    (8 states x 4 head dims) tile of the state per thread."""
    if smem_bytes(hp, N, L, variant) > MAX_SMEM_BYTES:
        return False
    return variant == "whole" or (
        _pad(hp, 4) <= TILE and _pad(N, 8) // 8 * _pad(hp, 4) // 4 <= THREADS)


def select_variant(hp: int, N: int, L: int) -> str:
    """``"whole"`` for a chunk of at most ``TILE`` tokens whose block fits
    in shared memory, else ``"subtile"``; raises when neither can take
    the shape."""
    if L <= TILE and _takes("whole", hp, N, L):
        return "whole"
    if not _takes("subtile", hp, N, L):
        raise ValueError(f"chunk {L} x head dim {hp} x state {N}: no "
                         f"variant of the SSD kernel takes this shape "
                         f"(sub-tiled: {smem_bytes(hp, N, L, 'subtile')} B "
                         f"of shared memory)")
    return "subtile"


def ssd_scan_cuda(x, adt, dt, B, C, *, chunk: int,
                  init_state: Optional[torch.Tensor] = None,
                  return_state: bool = False,
                  variant: Optional[str] = None):
    """x: (Bsz, S, H, hp); adt, dt: (Bsz, S, H); B, C: (Bsz, S, N); fp32
    CUDA tensors, any strides; S % chunk == 0; ``init_state`` (Bsz, H,
    hp, N) fp32 or None (zeros).  Returns a contiguous (Bsz, S, H, hp)
    fp32 tensor, or with ``return_state`` (y, the state after the last
    chunk, (Bsz, H, hp, N) fp32).  ``variant`` forces a variant, for
    measuring and testing the other one; one the shape does not allow
    raises."""
    Bsz, S, H, hp = x.shape
    N = B.shape[-1]
    ins = (x, adt, dt, B, C) + ((init_state,) if init_state is not None
                                else ())
    if not all(t.is_cuda for t in ins):
        raise ValueError("ssd_scan_cuda takes CUDA tensors")
    if any(t.dtype != torch.float32 for t in ins):
        raise TypeError("ssd_scan_cuda takes fp32 inputs")
    if (adt.shape != (Bsz, S, H) or dt.shape != adt.shape
            or B.shape != (Bsz, S, N) or C.shape != B.shape):
        raise ValueError("bad SSD input shapes")
    if init_state is not None:
        if init_state.shape != (Bsz, H, hp, N):
            raise ValueError(f"init_state must be {(Bsz, H, hp, N)}, got "
                             f"{tuple(init_state.shape)}")
        init_state = init_state.contiguous()
    if chunk < 1 or S % chunk:
        raise ValueError(f"sequence {S} is not a multiple of chunk {chunk}")
    if variant is None:
        variant = select_variant(hp, N, chunk)
    elif variant not in _VARIANTS or not _takes(variant, hp, N, chunk):
        raise ValueError(f"variant {variant!r} cannot take chunk {chunk} x "
                         f"head dim {hp} x state {N}")
    y = torch.empty((Bsz, S, H, hp), dtype=torch.float32, device=x.device)
    h_final = (torch.empty((Bsz, H, hp, N), dtype=torch.float32,
                           device=x.device) if return_state else None)
    if y.numel() == 0:          # no token: the state stays the initial one
        if return_state:
            h_final.zero_()
            if init_state is not None:
                h_final.copy_(init_state)
        return (y, h_final) if return_state else y
    ci = _build.c_int
    fn = _build.entry("repro_ssd_scan_fwd", 8, 25)
    err = fn(x.data_ptr(), adt.data_ptr(), dt.data_ptr(), B.data_ptr(),
             C.data_ptr(), y.data_ptr(),
             None if init_state is None else init_state.data_ptr(),
             None if h_final is None else h_final.data_ptr(),
             ci(Bsz), ci(S), ci(H), ci(hp), ci(N), ci(chunk),
             *(ci(s) for s in x.stride()),
             *(ci(s) for s in adt.stride()), *(ci(s) for s in dt.stride()),
             *(ci(s) for s in B.stride()), *(ci(s) for s in C.stride()),
             int(_build.rows16(x)),
             int(_build.rows16(B) and _build.rows16(C)),
             _VARIANTS[variant],
             torch.cuda.current_stream(x.device).cuda_stream)
    _build.check("ssd_scan", err)
    ssd_scan_cuda.launches += 1
    ssd_scan_cuda.launches_by_variant[variant] += 1
    return (y, h_final) if return_state else y


ssd_scan_cuda.launches = 0
ssd_scan_cuda.launches_by_variant = {"whole": 0, "subtile": 0}
