"""Plain PyTorch flash-attention twin: naive O(S^2) attention with explicit
masks (written from ``repro.kernels.flash_attention.ref.attention_ref``).

It is the CPU path of ``ops.flash_attention``, the backward of its CUDA
path (``kernels.autograd``), the differentiable attention of the
``tinytf_flash`` loss, and what ``chip_smoke.py`` holds the CUDA kernel
against on the card."""
from __future__ import annotations

from typing import Optional

import torch


def attention_ref(q, k, v, *, causal: bool = True,
                  window: Optional[int] = None,
                  sm_scale: Optional[float] = None) -> torch.Tensor:
    """q: (B, H, Sq, hd); k, v: (B, K, Skv, hd).  Returns (B, H, Sq, hd)."""
    B, H, Sq, hd = q.shape
    K, Skv = k.shape[1], k.shape[2]
    group = H // K
    sm_scale = sm_scale if sm_scale is not None else hd ** -0.5
    kk = torch.repeat_interleave(k, group, dim=1)
    vv = torch.repeat_interleave(v, group, dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), kk.float()) * sm_scale
    q_pos = torch.arange(Sq, device=q.device)[:, None]
    k_pos = torch.arange(Skv, device=q.device)[None, :]
    mask = torch.ones((Sq, Skv), dtype=torch.bool, device=q.device)
    if causal:
        mask &= k_pos <= q_pos
    if window is not None:
        mask &= k_pos > q_pos - window
    s = torch.where(mask[None, None], s,
                    torch.full_like(s, -1e30))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhqk,bhkd->bhqd", p, vv.float())
    return out.to(q.dtype)
