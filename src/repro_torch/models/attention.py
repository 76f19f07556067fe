"""Attention for the zoo's serving path (port of ``repro.models.attention``):
RoPE, prefill attention and the one-token decode attention over a ring
cache, each on the port's CUDA kernels.

The reference's chunked jnp paths (``causal_prefill_blocked``, the banded
``swa_prefill_attention``, ``chunked_attention``) are XLA schedules of one
function, the masked softmax attention below; its Pallas kernels
"implement the same schedules for TPU".  Here prefill is one call of the
flash-attention kernel (which skips the kv tiles above the diagonal and
left of the window itself) and decode one call of the decode-attention
kernel.  Cross-attention and the non-causal encoder path wait (ROADMAP
Queue 1 item 10).

Position conventions (as in the reference):
* ``q_positions`` (Sq,) and ``kv_positions`` (Skv,) are absolute token
  positions; kv slots holding no token carry position -1 (ring buffers).
* causal mask: kv_pos <= q_pos;  window mask: kv_pos > q_pos - window;
  validity: kv_pos >= 0.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.decode_attention import decode_attention
from repro_torch.kernels.flash_attention import flash_attention


def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float) -> torch.Tensor:
    """x: (B, S, H, hd) with hd even; positions: (S,) int."""
    hd = x.shape[-1]
    half = hd // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                    device=x.device) / half)
    angles = positions.to(x.device, torch.float32)[:, None] * freqs[None, :]
    cos = torch.cos(angles)[None, :, None, :]
    sin = torch.sin(angles)[None, :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def _mask(q_pos, kv_pos, causal: bool, window: Optional[int]):
    """(Sq, Skv) boolean mask."""
    m = kv_pos[None, :] >= 0
    if causal:
        m = m & (kv_pos[None, :] <= q_pos[:, None])
    if window is not None:
        m = m & (kv_pos[None, :] > (q_pos[:, None] - window))
    return m


def prefill_attention(q, k, v, *, window: Optional[int], q_offset: int = 0,
                      chunk: int = 1024) -> torch.Tensor:
    """Causal self-attention for prefill: q (B, S, H, hd), k/v (B, S, K,
    hd) -> (B, S, H, hd).  ``q_offset`` shifts q and kv positions alike,
    so the mask does not depend on it; ``chunk`` is the reference's XLA
    schedule.  Both are accepted for the reference signature."""
    del q_offset, chunk
    return flash_attention(q, k, v, causal=True, window=window)


def ring_decode_attention(q, k, v, *, kv_positions, q_position: int,
                          window: Optional[int]) -> torch.Tensor:
    """One new token against the ring cache (the reference's
    ``chunked_attention`` at Sq == 1): q (B, 1, H, hd) at absolute
    position ``q_position``; k/v (B, W, K, hd); kv_positions (W,) int32,
    -1 for empty slots.

    The kernel masks only slots whose position is negative, so the causal
    and window masks are folded into the positions first: a slot after
    the query, or at or before ``q_position - window``, is passed as -1.
    A ring longer than the window thus attends to the window alone."""
    pos = kv_positions
    drop = pos > q_position
    if window is not None:
        drop = drop | (pos <= q_position - window)
    return decode_attention(q, k, v, torch.where(drop, -1, pos).to(pos.dtype))
