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


def decode_attention_partial_ref(q, k, v, pos, sm_scale=None):
    """The unnormalised softmax state of one query over the given slots,
    the ``"partial"`` variant's output: the max score m, the sum l of
    e^(s - m) and the unnormalised p.v acc, in fp32.  Masked slots
    score -1e30, as in the kernel, so a range whose every slot is empty
    has m = -1e30 and weighs 0 beside a range that holds a valid slot
    (``combine_partials``).  No slot at all gives m = -inf, l = 0 and
    acc = 0, which weighs 0 beside any other range.

    q: (B, K, G, hd); k, v: (B, W, K, hd); pos: (B, W) with -1 = empty.
    Returns m, l (B, K, G) and acc (B, K, G, hd)."""
    hd = q.shape[-1]
    sm_scale = sm_scale if sm_scale is not None else hd ** -0.5
    B, K, G, _ = q.shape
    if k.shape[1] == 0:
        z = torch.zeros((B, K, G), dtype=torch.float32, device=q.device)
        return (torch.full_like(z, float("-inf")), z,
                torch.zeros((B, K, G, hd), dtype=torch.float32,
                            device=q.device))
    s = torch.einsum("bkgd,bwkd->bkgw", q.float() * sm_scale, k.float())
    s = torch.where((pos >= 0)[:, None, None, :], s,
                    torch.full_like(s, -1e30))
    m = s.amax(-1)
    p = torch.exp(s - m[..., None])
    return m, p.sum(-1), torch.einsum("bkgw,bwkd->bkgd", p, v.float())


def combine_partials(parts, dtype) -> torch.Tensor:
    """Merge ``decode_attention_partial_ref``'s (m, l, acc) of disjoint
    slot ranges, the arithmetic of the kernel's combine: M = max m_s,
    L = sum l_s e^(m_s - M), o = sum acc_s e^(m_s - M) / max(L, 1e-30),
    cast to ``dtype``."""
    M = torch.stack([m for m, _, _ in parts]).amax(0)
    w = [torch.exp(m - M) for m, _, _ in parts]
    L = sum(l * wi for (_, l, _), wi in zip(parts, w))
    acc = sum(a * wi[..., None] for (_, _, a), wi in zip(parts, w))
    return (acc / L.clamp_min(1e-30)[..., None]).to(dtype)


def decode_attention_split_ref(q, k, v, pos, n_split: int,
                               sm_scale=None) -> torch.Tensor:
    """The split-and-combine arithmetic of the CUDA kernel's ``"split"``
    variant, in plain torch (used by the tests): each split of the cache
    (``kernel.split_bounds``) yields its partial
    (``decode_attention_partial_ref``) and ``combine_partials`` merges
    them.  A cache with no valid slot averages its values.

    q: (B, K, G, hd); k, v: (B, W, K, hd); pos: (B, W) with -1 = empty."""
    from repro_torch.kernels.decode_attention.kernel import split_bounds
    return combine_partials(
        [decode_attention_partial_ref(q, k[:, lo:hi], v[:, lo:hi],
                                      pos[:, lo:hi], sm_scale)
         for lo, hi in split_bounds(k.shape[1], n_split)], q.dtype)
