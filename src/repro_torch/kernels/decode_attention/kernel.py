"""Launcher of the CUDA decode-attention kernel
(``csrc/decode_attention.cu``; replaces the TPU kernel
``repro/kernels/decode_attention/kernel.py`` ``_decode_kernel``).

``decode_attention_cuda.launches`` counts the kernel's launches and
nothing else."""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import _build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_GROUP_DIMS = 1024      # (H / K) * hd: the kernel's per-block outputs


def decode_attention_cuda(q, k, v, pos, *,
                          sm_scale: Optional[float] = None) -> torch.Tensor:
    """q: (B, 1, H, hd); k, v: (B, W, K, hd); pos: (B, W) int32 (-1 =
    empty slot; a zero batch stride from ``expand`` is fine).  CUDA
    tensors, fp32 or bf16 of one dtype, any strides.  Returns a contiguous
    (B, 1, H, hd) tensor of q's dtype."""
    B, _, H, hd = q.shape
    W, K = k.shape[1], k.shape[2]
    if not all(t.is_cuda for t in (q, k, v, pos)):
        raise ValueError("decode_attention_cuda takes CUDA tensors")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"decode_attention_cuda takes fp32 or bf16 q/k/v of "
                        f"one dtype, got {q.dtype}/{k.dtype}/{v.dtype}")
    if pos.dtype != torch.int32 or pos.shape != (B, W):
        raise ValueError(f"pos must be int32 of shape {(B, W)}, got "
                         f"{pos.dtype} {tuple(pos.shape)}")
    if (q.shape[1] != 1 or k.shape != (B, W, K, hd) or v.shape != k.shape
            or K < 1 or H % K):
        raise ValueError(f"bad shapes q{tuple(q.shape)} k{tuple(k.shape)} "
                         f"v{tuple(v.shape)}")
    if (H // K) * hd > MAX_GROUP_DIMS:
        raise ValueError(f"(H/K)*hd = {(H // K) * hd} > {MAX_GROUP_DIMS}")
    sm_scale = sm_scale if sm_scale is not None else hd ** -0.5
    o = torch.empty((B, 1, H, hd), dtype=q.dtype, device=q.device)
    if o.numel() == 0:
        return o
    ci = _build.c_int
    qs, ks, vs, ps = q.stride(), k.stride(), v.stride(), pos.stride()
    fn = _build.entry("repro_decode_attention_fwd", 5, 19, 1)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), pos.data_ptr(),
             o.data_ptr(), _DTYPES[q.dtype], ci(B), ci(W), ci(H), ci(K),
             ci(hd), ci(qs[0]), ci(qs[2]), ci(qs[3]),
             *(ci(s) for s in ks), *(ci(s) for s in vs),
             ci(ps[0]), ci(ps[1]), float(sm_scale),
             torch.cuda.current_stream(q.device).cuda_stream)
    _build.check("decode_attention", err)
    decode_attention_cuda.launches += 1
    return o


decode_attention_cuda.launches = 0
