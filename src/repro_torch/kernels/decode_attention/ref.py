"""Plain PyTorch decode-attention twin (written from
``repro.kernels.decode_attention.ref.decode_attention_ref``).

The CPU path of ``ops.decode_attention``, the differentiable pooled
readout of the ``tinytf_flash`` loss, and the version ``chip_smoke.py``
holds the CUDA kernel against."""
from __future__ import annotations

import torch


def decode_attention_ref(q, k, v, pos, sm_scale=None) -> torch.Tensor:
    """q: (B, K, G, hd); k, v: (B, W, K, hd); pos: (B, W) with -1 = empty."""
    hd = q.shape[-1]
    sm_scale = sm_scale if sm_scale is not None else hd ** -0.5
    s = torch.einsum("bkgd,bwkd->bkgw", q.float(), k.float()) * sm_scale
    valid = (pos >= 0)[:, None, None, :]
    s = torch.where(valid, s, torch.full_like(s, -1e30))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgw,bwkd->bkgd", p, v.float())
    return out.to(q.dtype)


def decode_attention_split_ref(q, k, v, pos, n_split: int,
                               sm_scale=None) -> torch.Tensor:
    """The split-and-combine arithmetic of the CUDA kernel's ``"split"``
    variant, in plain torch (used by the tests): each split of the cache
    (``kernel.split_bounds``) yields its max m, sum l and unnormalised
    p.v over its own slots; the combine takes M = max m_s, L = sum l_s
    e^(m_s - M) and o = sum acc_s e^(m_s - M) / max(L, 1e-30).  Masked
    slots score -1e30, so an all-empty split weighs 0 beside a valid one,
    and a cache with no valid slot averages its values.

    q: (B, K, G, hd); k, v: (B, W, K, hd); pos: (B, W) with -1 = empty."""
    from repro_torch.kernels.decode_attention.kernel import split_bounds
    hd = q.shape[-1]
    sm_scale = sm_scale if sm_scale is not None else hd ** -0.5
    s = torch.einsum("bkgd,bwkd->bkgw", q.float() * sm_scale, k.float())
    s = torch.where((pos >= 0)[:, None, None, :], s,
                    torch.full_like(s, -1e30))
    ms, ls, accs = [], [], []
    for lo, hi in split_bounds(k.shape[1], n_split):
        m = s[..., lo:hi].amax(-1, keepdim=True)           # (B, K, G, 1)
        p = torch.exp(s[..., lo:hi] - m)
        ms.append(m)
        ls.append(p.sum(-1, keepdim=True))
        accs.append(torch.einsum("bkgw,bwkd->bkgd", p, v[:, lo:hi].float()))
    M = torch.stack(ms).amax(0)
    w = [torch.exp(m - M) for m in ms]
    L = sum(li * wi for li, wi in zip(ls, w))
    acc = sum(ai * wi for ai, wi in zip(accs, w))
    return (acc / L.clamp_min(1e-30)).to(q.dtype)
