"""Public decode-attention op (port of
``repro.kernels.decode_attention.ops``).

Same signature as the reference op.  A CUDA tensor launches the
hand-written kernel (or raises); a CPU tensor runs the plain twin
``ref.decode_attention_ref``.  A ``meta`` tensor (the dry-run's count)
goes the CUDA tensor's way, through the kernel's shape function
``kernel.decode_attention_meta``; it holds no data, so this is no
fall-back.  No training path decodes, so a CUDA or ``meta`` call that
needs a gradient raises rather than return a tensor cut off from the
autograd graph.  A (W,) ``pos`` is broadcast to (B, W) —
as a zero-stride view on the CUDA path, which the kernel reads through
its strides.  ``block_kv`` is accepted for the reference signature; the
CUDA tiles and the split of the cache across blocks are the kernel's own
(``kernel.num_splits``).

``decode_attention_partial`` is the same call returning the unnormalised
softmax state of the given slots (the kernel's ``"partial"`` variant, or
the twin ``ref.decode_attention_partial_ref`` on a CPU tensor), for a
decode step that merges the states of a cache split over ranks.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.autograd import needs_grad
from repro_torch.kernels.decode_attention.kernel import (
    decode_attention_cuda, decode_attention_meta,
    decode_attention_partial_cuda, decode_attention_partial_meta)
from repro_torch.kernels.decode_attention.ref import (
    decode_attention_partial_ref, decode_attention_ref)


def decode_attention(q, k, v, pos, *, block_kv: int = 512) -> torch.Tensor:
    """q: (B, 1, H, hd) one new token; k, v: (B, W, K, hd) ring cache;
    pos: (W,) or (B, W) slot positions (-1 empty).  Returns (B, 1, H, hd).
    """
    del block_kv               # TPU VMEM tiling; the CUDA tiles are fixed
    B, _, H, hd = q.shape
    K = k.shape[2]
    pos = _pos(q, pos)
    if q.device.type != "cpu":
        _no_grad("decode_attention", q, k, v)
        kernel = decode_attention_meta if q.is_meta else decode_attention_cuda
        return kernel(q, k, v, pos, sm_scale=hd ** -0.5)
    qg = q[:, 0].reshape(B, K, H // K, hd)
    out = decode_attention_ref(qg, k, v, pos, sm_scale=hd ** -0.5)
    return out.reshape(B, 1, H, hd)


def decode_attention_partial(q, k, v, pos):
    """``decode_attention``'s arguments; returns the unnormalised softmax
    state of the given slots: the max score M and the sum L of
    e^(s - M), (B, H), and acc = sum e^(s - M) v, (B, H, hd), all fp32.
    acc / max(L, 1e-30) is ``decode_attention``'s output over these
    slots, and states of disjoint slot ranges merge as
    ``ref.combine_partials`` does."""
    B, _, H, hd = q.shape
    K = k.shape[2]
    pos = _pos(q, pos)
    if q.device.type != "cpu":
        _no_grad("decode_attention_partial", q, k, v)
        kernel = decode_attention_partial_meta if q.is_meta \
            else decode_attention_partial_cuda
        return kernel(q, k, v, pos, sm_scale=hd ** -0.5)
    m, l, acc = decode_attention_partial_ref(
        q[:, 0].reshape(B, K, H // K, hd), k, v, pos, sm_scale=hd ** -0.5)
    return m.reshape(B, H), l.reshape(B, H), acc.reshape(B, H, hd)


def _pos(q, pos):
    return pos[None].expand(q.shape[0], pos.shape[0]) if pos.ndim == 1 \
        else pos


def _no_grad(name, q, k, v):
    if needs_grad(q, k, v):
        raise RuntimeError(
            f"{name} has no gradient off the CPU: its kernel is "
            f"forward-only and no training path decodes; run it under "
            f"torch.no_grad() or on detached inputs")
