"""Plain PyTorch SSD twins (written from ``repro.kernels.ssd_scan``).

* ``ssd_scan_chunked_ref`` — the chunk loop the CUDA kernel runs (and the
  Pallas kernel body computes): per chunk, the intra-chunk
  ((C B^T) * decay)(x dt) term, the inter-chunk read of the carried
  state, and the state update; optionally from an initial state, and
  returning the final one (``models.ssm.ssd_chunked``'s contract).  The
  CPU path of ``ops.ssd_scan`` and the version ``chip_smoke.py`` holds
  the kernel against.
* ``ssd_scan_ref`` — the sequential per-token recurrence, the
  ground-truth semantics both are tested against.
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
