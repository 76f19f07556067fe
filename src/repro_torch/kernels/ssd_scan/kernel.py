"""Launcher of the CUDA SSD chunked-scan kernels (``csrc/ssd_scan.cu``;
replaces the TPU kernel ``repro/kernels/ssd_scan/kernel.py``
``_ssd_kernel``).

Two variants, picked by ``select_variant`` from the shapes alone:
``"whole"`` keeps a chunk of up to ``TILE`` tokens whole in shared
memory (the cascade's chunk 64), one block per (batch, head) walking the
chunks in order; ``"parallel"`` runs a longer chunk (the zoo's chunk 256
at state 128) as four chunk-parallel passes: C·Bᵀ once per (batch,
chunk), each chunk's own state, the state passing across chunks, and
the chunk scan, in scratch this wrapper allocates.  Both run the chunk
asked for; neither re-chunks.  ``ssd_scan_cuda.launches`` counts the
op's launches (one a call, whatever the number of passes) and nothing
else, ``ssd_scan_cuda.launches_by_variant`` splits that count.
``ssd_scan_meta`` is the same call on the ``meta`` device (checks,
outputs and scratch, no launch).  Both report each launch, its variant
and its cost (``metrics.roofline.ssd_cost``) to the active
``metrics.cost.CostCounter``.
``ssd_passes_cuda`` launches chosen passes alone, uncounted, so that
each pass can be held against its plain twin (``ref.py``)."""
from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch

from repro_torch.kernels import _build
from repro_torch.metrics.cost import report_kernel
from repro_torch.metrics.roofline import ssd_cost

MAX_SMEM_BYTES = 232_448   # Hopper's per-block dynamic shared memory
TILE = 64                  # "whole"'s longest chunk; the passes' token tile
MAX_HEAD_DIM = 64          # "parallel"'s head dims
MAX_STATE = 128            # "parallel"'s states
_VARIANTS = {"whole": 0, "parallel": 1}
# the passes of "parallel", in launch order, and their bits in the C mask
PASSES = {"cb": 1, "chunk_state": 2, "state_pass": 4, "chunk_scan": 8}


def _pad(n: int, m: int) -> int:
    return -(-n // m) * m


def _stride_g_t(cols: int) -> int:
    return _pad(cols, 8) + 4


def _stride_t_g(cols: int) -> int:
    return _pad(cols, 32) + 8


def pass_smem_bytes(hp: int, N: int, L: int) -> Dict[str, int]:
    """Shared memory of each pass of ``"parallel"`` that uses it (mirrors
    ``pass_smem`` on the C side): C·Bᵀ stages a 64-token tile of C and of
    B; the chunk state the chunk's cumsum and weights and a two-stage ring
    of x and B tiles; the chunk scan the cumsum and dt, then C_I and the
    entering state, whose memory a two-stage ring of C·Bᵀ and x tiles
    reuses.  The cumsum is fp64 (8 bytes a token).  Row strides are padded
    for conflict-free fragment loads."""
    LT, HP8 = _pad(L, TILE), _pad(hp, 8)
    init = (TILE + HP8) * _stride_g_t(N)
    ring = 2 * TILE * (_stride_g_t(TILE) + _stride_t_g(hp))
    return {"cb": 4 * 2 * TILE * _stride_g_t(N),
            "chunk_state": 4 * (3 * LT + 2 * TILE * (_stride_t_g(hp)
                                                     + _stride_t_g(N))),
            "chunk_scan": 4 * (3 * LT + max(init, ring))}


def smem_bytes(hp: int, N: int, L: int, variant: str = "whole") -> int:
    """Shared memory one block of the scan needs (mirrors the C side).
    ``"whole"``: x, B^T, C^T, the (L x L) scores, h^T and four L vectors,
    each dimension padded to a multiple of 4; ``"parallel"``: the largest
    of its passes' (``pass_smem_bytes``)."""
    if variant == "parallel":
        return max(pass_smem_bytes(hp, N, L).values())
    P4, L4, N4 = _pad(hp, 4), _pad(L, 4), _pad(N, 4)
    return 4 * (L4 * P4 + 2 * N4 * L4 + L4 * L4 + N4 * P4 + 4 * L4)


def _takes(variant: str, hp: int, N: int, L: int) -> bool:
    """Whether ``variant`` can run the shape: ``"whole"`` within shared
    memory, ``"parallel"`` also with head dims up to ``MAX_HEAD_DIM`` and
    states up to ``MAX_STATE``."""
    if smem_bytes(hp, N, L, variant) > MAX_SMEM_BYTES:
        return False
    return variant == "whole" or (hp <= MAX_HEAD_DIM and N <= MAX_STATE)


def select_variant(hp: int, N: int, L: int) -> str:
    """``"whole"`` for a chunk of at most ``TILE`` tokens whose block fits
    in shared memory, else ``"parallel"``; raises when neither can take
    the shape."""
    if L <= TILE and _takes("whole", hp, N, L):
        return "whole"
    if not _takes("parallel", hp, N, L):
        raise ValueError(f"chunk {L} x head dim {hp} x state {N}: no "
                         f"variant of the SSD kernel takes this shape "
                         f"(the passes take head dims up to {MAX_HEAD_DIM} "
                         f"and states up to {MAX_STATE}; "
                         f"{smem_bytes(hp, N, L, 'parallel')} B of shared "
                         f"memory)")
    return "parallel"


def ssd_scratch(Bsz: int, S: int, H: int, hp: int, N: int, chunk: int,
                device) -> Dict[str, torch.Tensor]:
    """The scratch of ``"parallel"``, uninitialised (each pass writes what
    a later one reads): ``cb`` (Bsz, nc, LT, LT) C·Bᵀ per chunk, ``st``
    (Bsz, nc, H, hp, N) each chunk's own state, then the state entering
    it, both fp32; ``cum`` (Bsz, nc, H, LT) the cumsum of A·dt per chunk
    in fp64 (rows past the chunk repeat its last); LT is the chunk padded
    to ``TILE``."""
    nc, LT = S // chunk, _pad(chunk, TILE)
    f32 = dict(dtype=torch.float32, device=device)
    return {"cb": torch.empty((Bsz, nc, LT, LT), **f32),
            "st": torch.empty((Bsz, nc, H, hp, N), **f32),
            "cum": torch.empty((Bsz, nc, H, LT), dtype=torch.float64,
                               device=device)}


def _check(x, adt, dt, B, C, chunk, init_state, device_type="cuda"):
    Bsz, S, H, hp = x.shape
    N = B.shape[-1]
    ins = (x, adt, dt, B, C) + ((init_state,) if init_state is not None
                                else ())
    if not all(t.device.type == device_type for t in ins):
        raise ValueError(f"ssd_scan_{device_type} takes "
                         f"{'CUDA' if device_type == 'cuda' else 'meta'} "
                         f"tensors")
    if any(t.dtype != torch.float32 for t in ins):
        raise TypeError("ssd_scan_cuda takes fp32 inputs")
    if (adt.shape != (Bsz, S, H) or dt.shape != adt.shape
            or B.shape != (Bsz, S, N) or C.shape != B.shape):
        raise ValueError("bad SSD input shapes")
    if init_state is not None and init_state.shape != (Bsz, H, hp, N):
        raise ValueError(f"init_state must be {(Bsz, H, hp, N)}, got "
                         f"{tuple(init_state.shape)}")
    if chunk < 1 or S % chunk:
        raise ValueError(f"sequence {S} is not a multiple of chunk {chunk}")


def _launch(x, adt, dt, B, C, y, h0, hout, chunk, variant, passes=15,
            scratch=None):
    Bsz, S, H, hp = x.shape
    N = B.shape[-1]
    scratch = scratch or {}
    ci = _build.c_int
    ptr = (lambda t: None if t is None else t.data_ptr())
    fn = _build.entry("repro_ssd_scan_fwd", 11, 26)
    err = fn(x.data_ptr(), adt.data_ptr(), dt.data_ptr(), B.data_ptr(),
             C.data_ptr(), ptr(y), ptr(h0), ptr(hout),
             *(ptr(scratch.get(k)) for k in ("cb", "st", "cum")),
             ci(Bsz), ci(S), ci(H), ci(hp), ci(N), ci(chunk),
             *(ci(s) for s in x.stride()),
             *(ci(s) for s in adt.stride()), *(ci(s) for s in dt.stride()),
             *(ci(s) for s in B.stride()), *(ci(s) for s in C.stride()),
             int(_build.rows16(x)),
             int(_build.rows16(B) and _build.rows16(C)),
             _VARIANTS[variant], passes,
             torch.cuda.current_stream(x.device).cuda_stream)
    _build.check("ssd_scan", err)


def _plan(x, adt, dt, B, C, chunk, init_state, return_state, variant):
    """The variant, the outputs and the scratch of one (checked) call:
    what the launcher and the ``meta`` shape function share.  Returns
    (variant, init_state, y, h_final, scratch), variant None when there
    is no token (the state stays the initial one; nothing is
    launched)."""
    Bsz, S, H, hp = x.shape
    N = B.shape[-1]
    if init_state is not None:
        init_state = init_state.contiguous()
    if variant is None:
        variant = select_variant(hp, N, chunk)
    elif variant not in _VARIANTS or not _takes(variant, hp, N, chunk):
        raise ValueError(f"variant {variant!r} cannot take chunk {chunk} x "
                         f"head dim {hp} x state {N}")
    y = torch.empty((Bsz, S, H, hp), dtype=torch.float32, device=x.device)
    h_final = (torch.empty((Bsz, H, hp, N), dtype=torch.float32,
                           device=x.device) if return_state else None)
    if y.numel() == 0:
        if return_state:
            h_final.zero_()
            if init_state is not None:
                h_final.copy_(init_state)
        return None, init_state, y, h_final, None
    scratch = (ssd_scratch(Bsz, S, H, hp, N, chunk, x.device)
               if variant == "parallel" else None)
    return variant, init_state, y, h_final, scratch


def _report(x, N, chunk, init_state, return_state, variant):
    report_kernel("ssd_scan", variant,
                  ssd_cost(x.shape, N, chunk, init_state is not None,
                           return_state))


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
    _check(x, adt, dt, B, C, chunk, init_state)
    variant, init_state, y, h_final, scratch = _plan(
        x, adt, dt, B, C, chunk, init_state, return_state, variant)
    if variant is not None:
        _launch(x, adt, dt, B, C, y, init_state, h_final, chunk, variant,
                scratch=scratch)
        ssd_scan_cuda.launches += 1
        ssd_scan_cuda.launches_by_variant[variant] += 1
        _report(x, B.shape[-1], chunk, init_state, return_state, variant)
    return (y, h_final) if return_state else y


def ssd_scan_meta(x, adt, dt, B, C, *, chunk: int,
                  init_state: Optional[torch.Tensor] = None,
                  return_state: bool = False,
                  variant: Optional[str] = None):
    """The kernel's shape function on the ``meta`` device: the launcher's
    checks, variant, (empty) outputs and ``"parallel"``'s scratch, and one
    launch of that variant reported to the active ``CostCounter``; no
    data, no device."""
    _check(x, adt, dt, B, C, chunk, init_state, "meta")
    variant, init_state, y, h_final, _ = _plan(
        x, adt, dt, B, C, chunk, init_state, return_state, variant)
    if variant is not None:
        _report(x, B.shape[-1], chunk, init_state, return_state, variant)
    return (y, h_final) if return_state else y


ssd_scan_cuda.launches = 0
ssd_scan_cuda.launches_by_variant = {"whole": 0, "parallel": 0}


def ssd_passes_cuda(x, adt, dt, B, C, *, chunk: int,
                    passes: Sequence[str], scratch: Dict[str, torch.Tensor],
                    y: Optional[torch.Tensor] = None,
                    init_state: Optional[torch.Tensor] = None,
                    h_final: Optional[torch.Tensor] = None) -> None:
    """Launch the named passes of ``"parallel"`` (``PASSES``), in launch
    order, on ``scratch`` (``ssd_scratch``'s layout): a pass alone reads
    what the earlier passes would have written there, so that each is
    held against its plain twin on the same inputs.  ``y`` (contiguous
    (Bsz, S, H, hp)) receives the chunk scan's output, ``h_final`` the
    state passing's last state.  Not counted in ``ssd_scan_cuda``'s
    launches: no served path calls it."""
    Bsz, S, H, hp = x.shape
    N = B.shape[-1]
    _check(x, adt, dt, B, C, chunk, init_state)
    if not _takes("parallel", hp, N, chunk):
        raise ValueError(f"the passes cannot take chunk {chunk} x head dim "
                         f"{hp} x state {N}")
    want = ssd_scratch(Bsz, S, H, hp, N, chunk, "meta")
    for k, t in want.items():
        s = scratch[k]
        if (s.shape != t.shape or s.dtype != t.dtype or not s.is_cuda
                or not s.is_contiguous()):
            raise ValueError(f"scratch {k!r} must be a contiguous {t.dtype} "
                             f"CUDA tensor of shape {tuple(t.shape)}")
    for t in (y, h_final, init_state):
        if t is not None and not (t.is_cuda and t.is_contiguous()):
            raise ValueError("y, init_state and h_final must be contiguous "
                             "CUDA tensors")
    if "chunk_scan" in passes and y is None:
        raise ValueError("the chunk scan needs y")
    mask = 0
    for p in passes:
        mask |= PASSES[p]
    _launch(x, adt, dt, B, C, y, init_state, h_final, chunk, "parallel",
            mask, scratch)
