"""Plain PyTorch SSD twins (written from ``repro.kernels.ssd_scan``).

* ``ssd_scan_chunked_ref`` — the chunk loop the CUDA kernel runs (and the
  Pallas kernel body computes): per chunk, the intra-chunk
  ((C B^T) * decay)(x dt) term, the inter-chunk read of the carried
  state, and the state update; optionally from an initial state, and
  returning the final one (``models.ssm.ssd_chunked``'s contract).  The
  CPU path of ``ops.ssd_scan``, the backward of its CUDA path
  (``kernels.autograd``) and the version ``chip_smoke.py`` holds the
  kernel against.
* ``ssd_scan_ref`` — the sequential per-token recurrence, the
  ground-truth semantics both are tested against.
* one twin per pass of the CUDA kernel's ``"parallel"`` variant —
  ``ssd_cb_ref`` (C·Bᵀ per chunk), ``ssd_chunk_state_ref`` (each chunk's
  cumsum of A·dt and its own state), ``ssd_state_pass_ref`` (the states
  entering the chunks, and the final one) and ``ssd_chunk_scan_ref`` (y)
  — and ``ssd_scan_passes_ref``, their composition, which computes
  ``ssd_scan_chunked_ref``'s function.
"""
from __future__ import annotations

import torch


def ssd_scan_chunked_ref(x, adt, dt, B, C, chunk: int, *,
                         init_state=None, return_state: bool = False):
    """x: (Bsz, S, H, hp); adt, dt: (Bsz, S, H); B, C: (Bsz, S, N);
    S % chunk == 0; ``init_state``: (Bsz, H, hp, N) or None (zeros).
    Returns y: (Bsz, S, H, hp) in x's dtype, or with ``return_state``
    (y, the state after the last chunk (Bsz, H, hp, N) in fp32)."""
    Bsz, S, H, hp = x.shape
    N = B.shape[-1]
    L = chunk
    xf, af, df = x.float(), adt.float(), dt.float()
    Bf, Cf = B.float(), C.float()
    tri = torch.tril(torch.ones((L, L), dtype=torch.bool, device=x.device))
    h = (torch.zeros((Bsz, H, hp, N), dtype=torch.float32, device=x.device)
         if init_state is None else init_state.float())
    ys = []
    for c0 in range(0, S, L):
        xc = xf[:, c0:c0 + L]                          # (Bsz, L, H, hp)
        ac = af[:, c0:c0 + L].transpose(1, 2)          # (Bsz, H, L)
        dc = df[:, c0:c0 + L].transpose(1, 2)
        Bc, Cc = Bf[:, c0:c0 + L], Cf[:, c0:c0 + L]    # (Bsz, L, N)
        cum = torch.cumsum(ac, dim=-1)                 # (Bsz, H, L)
        diff = cum[..., :, None] - cum[..., None, :]
        # exp only where i >= j: the upper triangle may overflow
        decay = torch.exp(torch.where(tri, diff, torch.full_like(diff,
                                                                 -torch.inf)))
        cb = torch.einsum("bln,bsn->bls", Cc, Bc)      # (Bsz, L, L)
        xdt = xc * dc.transpose(1, 2)[..., None]       # (Bsz, L, H, hp)
        y = torch.einsum("bhls,bshp->blhp", cb[:, None] * decay, xdt)
        y = y + torch.einsum("bln,bhpn->blhp", Cc, h) \
            * torch.exp(cum).transpose(1, 2)[..., None]
        ys.append(y)
        decay_out = torch.exp(cum[..., -1:] - cum) * dc   # (Bsz, H, L)
        h = h * torch.exp(cum[..., -1])[..., None, None] + torch.einsum(
            "bhl,blhp,bln->bhpn", decay_out, xc, Bc)
    y = torch.cat(ys, dim=1).to(x.dtype)
    return (y, h) if return_state else y


def ssd_scan_ref(x, adt, dt, B, C) -> torch.Tensor:
    """Sequential recurrence, the ground-truth semantics:

    h_t = h_{t-1} * exp(adt_t) + dt_t * B_t (x) x_t
    y_t = C_t . h_t

    x: (Bsz, S, H, hp); adt, dt: (Bsz, S, H); B, C: (Bsz, S, N).
    """
    Bsz, S, H, hp = x.shape
    N = B.shape[-1]
    h = torch.zeros((Bsz, H, hp, N), dtype=torch.float32, device=x.device)
    ys = []
    for t in range(S):
        dA = torch.exp(adt[:, t].float())
        upd = torch.einsum("bh,bn,bhp->bhpn", dt[:, t].float(),
                           B[:, t].float(), x[:, t].float())
        h = h * dA[:, :, None, None] + upd
        ys.append(torch.einsum("bn,bhpn->bhp", C[:, t].float(), h))
    return torch.stack(ys, dim=1).to(x.dtype)


def _chunks(t, chunk: int):
    """(Bsz, S, ...) -> (Bsz, S // chunk, chunk, ...) in fp32."""
    return t.float().reshape(t.shape[0], t.shape[1] // chunk, chunk,
                             *t.shape[2:])


def ssd_cb_ref(B, C, chunk: int):
    """Pass 1: (C B^T)[i][j] = C_i . B_j within each chunk, for j <= i
    (zeros above the diagonal); (Bsz, nc, L, L) fp32.  B and C are shared
    by the heads, so this does not depend on the head."""
    cb = torch.einsum("bcin,bcjn->bcij", _chunks(C, chunk), _chunks(B, chunk))
    return torch.tril(cb)


def ssd_chunk_state_ref(x, adt, dt, B, chunk: int):
    """Pass 2: per chunk, cum = cumsum(A dt) (Bsz, nc, H, L) and the
    chunk's own state from zero, s = sum_j exp(cum_{L-1} - cum_j) dt_j
    x_j^T B_j, (Bsz, nc, H, hp, N).  Returns (s, cum)."""
    cum = torch.cumsum(_chunks(adt, chunk), dim=2).transpose(2, 3)
    w = torch.exp(cum[..., -1:] - cum) * _chunks(dt, chunk).transpose(2, 3)
    s = torch.einsum("bchl,bclhp,bcln->bchpn", w, _chunks(x, chunk),
                     _chunks(B, chunk))
    return s, cum


def ssd_state_pass_ref(states, cum, init_state=None):
    """Pass 3: h_c = h_{c-1} exp(cum_{L-1} of chunk c) + s_c from
    ``init_state`` (zeros when None).  Returns (the state entering each
    chunk, (Bsz, nc, H, hp, N); the state after the last, (Bsz, H, hp,
    N))."""
    h = (torch.zeros_like(states[:, 0]) if init_state is None
         else init_state.float())
    entering = []
    for c in range(states.shape[1]):
        entering.append(h)
        h = h * torch.exp(cum[:, c, :, -1])[..., None, None] + states[:, c]
    return torch.stack(entering, dim=1), h


def ssd_chunk_scan_ref(x, dt, C, cb, cum, entering, chunk: int):
    """Pass 4: y_i = sum_{j<=i} CB_ij exp(cum_i - cum_j) dt_j x_j +
    exp(cum_i) C_i . h_{c-1}, from the three passes' outputs; y (Bsz, S,
    H, hp) in x's dtype."""
    L = chunk
    tri = torch.tril(torch.ones((L, L), dtype=torch.bool, device=x.device))
    diff = cum[..., :, None] - cum[..., None, :]        # (Bsz, nc, H, L, L)
    # exp only where i >= j: the upper triangle may overflow
    decay = torch.exp(torch.where(tri, diff, torch.full_like(diff,
                                                             -torch.inf)))
    scores = (torch.where(tri, cb, torch.zeros_like(cb))[:, :, None] * decay
              * _chunks(dt, L).transpose(2, 3)[..., None, :])
    y = torch.einsum("bchij,bcjhp->bcihp", scores, _chunks(x, L))
    y = y + torch.einsum("bcin,bchpn->bcihp", _chunks(C, L), entering) \
        * torch.exp(cum).transpose(2, 3)[..., None]
    return y.reshape(x.shape).to(x.dtype)


def ssd_scan_passes_ref(x, adt, dt, B, C, chunk: int, *, init_state=None,
                        return_state: bool = False):
    """The four passes composed: ``ssd_scan_chunked_ref``'s function and
    contract."""
    states, cum = ssd_chunk_state_ref(x, adt, dt, B, chunk)
    entering, h = ssd_state_pass_ref(states, cum, init_state)
    y = ssd_chunk_scan_ref(x, dt, C, ssd_cb_ref(B, C, chunk), cum, entering,
                           chunk)
    return (y, h) if return_state else y
