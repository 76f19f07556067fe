"""Public SSD chunked-scan op (port of ``repro.kernels.ssd_scan.ops``).

The reference op's signature, plus ``init_state`` / ``return_state``
(``models.ssm.ssd_chunked``'s contract, which the zoo's prefill needs
from the kernel that replaces it).  A CUDA tensor launches the
hand-written kernel (or raises), through ``kernels.autograd`` when the
call needs a gradient: the backward is the twin's, to x, adt, dt, B, C
and ``init_state``, through y and the final state alike.  A CPU tensor
runs the plain twin ``ref.ssd_scan_chunked_ref``.  A ``meta`` tensor
(the dry-run's count) goes the CUDA tensor's way, through the kernel's
shape function ``kernel.ssd_scan_meta``: it holds no data, so this is no
fall-back, and its backward is the twin's on ``meta`` as on the card.
As in the reference,
``chunk`` is min'd to the sequence length, which must be a multiple of
it.
"""
from __future__ import annotations

import functools

from repro_torch.kernels.autograd import with_twin_grad
from repro_torch.kernels.ssd_scan.kernel import ssd_scan_cuda, ssd_scan_meta
from repro_torch.kernels.ssd_scan.ref import ssd_scan_chunked_ref


def ssd_scan(x, adt, dt, B, C, *, chunk: int = 256, init_state=None,
             return_state: bool = False):
    """Mamba2 SSD: x (Bsz,S,H,hp); adt/dt (Bsz,S,H); B/C (Bsz,S,N);
    ``init_state`` (Bsz,H,hp,N) or None.  Returns y (Bsz,S,H,hp), or with
    ``return_state`` (y, final state (Bsz,H,hp,N) fp32)."""
    S = x.shape[1]
    chunk = min(chunk, S)
    if S % chunk:
        raise ValueError(f"sequence {S} is not a multiple of chunk {chunk}")
    if x.device.type != "cpu":
        return with_twin_grad(
            functools.partial(_kernel, chunk=chunk,
                              return_state=return_state),
            functools.partial(_twin, chunk=chunk,
                              return_state=return_state),
            x, adt, dt, B, C, init_state)
    return _twin(x, adt, dt, B, C, init_state, chunk=chunk,
                 return_state=return_state)


def _kernel(x, adt, dt, B, C, init_state, *, chunk, return_state):
    kernel = ssd_scan_meta if x.is_meta else ssd_scan_cuda
    return kernel(x, adt, dt, B, C, chunk=chunk, init_state=init_state,
                  return_state=return_state)


def _twin(x, adt, dt, B, C, init_state, *, chunk, return_state):
    return ssd_scan_chunked_ref(x, adt, dt, B, C, chunk,
                                init_state=init_state,
                                return_state=return_state)
