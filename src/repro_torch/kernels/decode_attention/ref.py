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
