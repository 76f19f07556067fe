"""Launcher of the CUDA decode-attention kernel
(``csrc/decode_attention.cu``; replaces the TPU kernel
``repro/kernels/decode_attention/kernel.py`` ``_decode_kernel``).

The cache is split across blocks along its slots (flash-decoding):
``num_splits`` picks the split count from the shapes alone.  One split
is the ``"single"`` variant (one launch that writes the output); more
are ``"split"`` (partials, then a combine kernel).
``decode_attention_cuda.launches`` counts calls of the op (one per decode
attention, whatever the variant) and nothing else;
``decode_attention_cuda.launches_by_variant`` splits that count.
``decode_attention_meta`` is the same call on the ``meta`` device
(checks, split, output and scratch, no launch).  Both report each launch,
its variant and its cost (``metrics.roofline.decode_cost``, every slot
counted: the count cannot read the positions) to the active
``metrics.cost.CostCounter``."""
from __future__ import annotations

from typing import List, Optional, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.metrics.cost import report_kernel
from repro_torch.metrics.roofline import decode_cost

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_GROUP_DIMS = 2048      # (H / K) * hd: the kernel's per-block outputs
H100_SMS = 132
# A split's least length: at W = 128 (the cascade's readout at bucket 8)
# two splits of 64 slots took the device as long as one block over all
# 128 (PERF.md §6) and add the combine's launch.
MIN_SPLIT_SLOTS = 128


def num_splits(B: int, K: int, W: int, n_sm: int = H100_SMS) -> int:
    """Blocks along the cache for B x K (batch, kv head) pairs over W
    slots: enough for about two blocks an SM, each over at least
    ``MIN_SPLIT_SLOTS`` slots (the last one may be shorter), and no split
    left empty."""
    want = max(1, min(2 * n_sm // max(1, B * K), W // MIN_SPLIT_SLOTS))
    return -(-W // -(-W // want)) if W > 0 else 1


def split_bounds(W: int, n_split: int) -> List[Tuple[int, int]]:
    """The slot range [lo, hi) of each split: equal lengths
    ceil(W / n_split), the last one ragged."""
    length = -(-W // n_split)
    return [(lo, min(W, lo + length)) for lo in range(0, W, length)]


def select_variant(B: int, K: int, W: int, n_sm: int = H100_SMS) -> str:
    """``"single"`` (one block per (b, kv head), one launch) or
    ``"split"`` (partials and a combine), from the shapes alone."""
    return "split" if num_splits(B, K, W, n_sm) > 1 else "single"


def _plan(q, k, v, pos, n_split):
    """The checks, the split, the variant, the output and the scratch of
    one call: what the launcher and the ``meta`` shape function share.
    Returns (variant, n_split, split_len, o, scratch), variant None when
    nothing is launched (no query or no slot)."""
    B, _, H, hd = q.shape
    W, K = k.shape[1], k.shape[2]
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
    G = H // K
    if G * hd > MAX_GROUP_DIMS:
        raise ValueError(f"(H/K)*hd = {G * hd} > {MAX_GROUP_DIMS}")
    o = torch.empty((B, 1, H, hd), dtype=q.dtype, device=q.device)
    if o.numel() == 0 or W == 0:
        return None, 0, 0, (o.zero_() if W == 0 else o), None
    if n_split is None:
        n_split = num_splits(B, K, W)
    if not 1 <= n_split <= W:
        raise ValueError(f"n_split {n_split} outside [1, {W}]")
    split_len = -(-W // n_split)
    n_split = -(-W // split_len)        # no split left empty
    variant = "split" if n_split > 1 else "single"
    # one fp32 scratch for the splits' (m, l) and accumulators: (B, K,
    # n_split, G) twice, then (B, K, n_split, G, hd)
    rows = B * K * n_split * G if n_split > 1 else 0
    scratch = torch.empty(rows * (hd + 2), dtype=torch.float32,
                          device=q.device)
    return variant, n_split, split_len, o, scratch


def _report(q, k, variant):
    report_kernel("decode_attention", variant,
                  decode_cost(q.shape, k.shape, q.dtype))


def decode_attention_cuda(q, k, v, pos, *, sm_scale: Optional[float] = None,
                          n_split: Optional[int] = None) -> torch.Tensor:
    """q: (B, 1, H, hd); k, v: (B, W, K, hd); pos: (B, W) int32 (-1 =
    empty slot; a zero batch stride from ``expand`` is fine).  CUDA
    tensors, fp32 or bf16 of one dtype, any strides.  ``n_split``: blocks
    along the cache, ``num_splits``'s choice when None (a count is for
    measuring the split's trade-off).  Returns a contiguous (B, 1, H, hd)
    tensor of q's dtype."""
    if not all(t.is_cuda for t in (q, k, v, pos)):
        raise ValueError("decode_attention_cuda takes CUDA tensors")
    variant, n_split, split_len, o, scratch = _plan(q, k, v, pos, n_split)
    if variant is None:
        return o
    B, _, H, hd = q.shape
    W, K = k.shape[1], k.shape[2]
    sm_scale = sm_scale if sm_scale is not None else hd ** -0.5
    rows = scratch.numel() // (hd + 2)
    part_m = scratch.data_ptr()
    vec = _build.rows16(k) and _build.rows16(v)
    ci = _build.c_int
    qs, ks, vs, ps = q.stride(), k.stride(), v.stride(), pos.stride()
    fn = _build.entry("repro_decode_attention_fwd", 8, 22, 1)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), pos.data_ptr(),
             o.data_ptr(), part_m, part_m + 4 * rows, part_m + 8 * rows,
             _DTYPES[q.dtype], ci(B), ci(W), ci(H),
             ci(K), ci(hd), ci(n_split), ci(split_len), int(vec),
             ci(qs[0]), ci(qs[2]), ci(qs[3]),
             *(ci(s) for s in ks), *(ci(s) for s in vs),
             ci(ps[0]), ci(ps[1]), float(sm_scale),
             torch.cuda.current_stream(q.device).cuda_stream)
    _build.check("decode_attention", err)
    decode_attention_cuda.launches += 1
    decode_attention_cuda.launches_by_variant[variant] += 1
    _report(q, k, variant)
    return o


def decode_attention_meta(q, k, v, pos, *, sm_scale: Optional[float] = None,
                          n_split: Optional[int] = None) -> torch.Tensor:
    """The kernel's shape function on the ``meta`` device: the launcher's
    checks, split, variant, (empty) output and scratch, and one launch of
    that variant reported to the active ``CostCounter``; no data, no
    device."""
    del sm_scale
    if not all(t.is_meta for t in (q, k, v, pos)):
        raise ValueError("decode_attention_meta takes meta tensors")
    variant, _, _, o, _ = _plan(q, k, v, pos, n_split)
    if variant is not None:
        _report(q, k, variant)
    return o


decode_attention_cuda.launches = 0
decode_attention_cuda.launches_by_variant = {"single": 0, "split": 0}
