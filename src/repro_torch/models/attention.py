"""Attention for the zoo's serving path (port of ``repro.models.attention``):
RoPE, causal prefill attention, the encoder's non-causal self-attention,
cross-attention over encoder or image memory, and the one-token decode
attention over a ring cache, each on the port's CUDA kernels.

The reference's chunked jnp paths (``causal_prefill_blocked``, the banded
``swa_prefill_attention``, ``chunked_attention``, the q blocks of
``cross_attention``) are XLA schedules of one function, the masked
softmax attention below; its Pallas kernels "implement the same
schedules for TPU".  Here every attention over more than one query is
one call of the flash-attention kernel (which skips the kv tiles above
the diagonal and left of the window itself) and every one-query
attention one call of the decode-attention kernel.  Both are called
through this module's globals ``flash_attention`` / ``decode_attention``.

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


def encoder_attention(q, k, v) -> torch.Tensor:
    """Non-causal self-attention (the encoder's; the reference's
    ``chunked_attention(..., causal=False)`` over positions arange(S)):
    q (B, S, H, hd), k/v (B, S, K, hd) -> (B, S, H, hd)."""
    return flash_attention(q, k, v, causal=False, window=None)


def cross_attention(q, k, v, *, kv_valid_len: Optional[int] = None,
                    chunk: int = 1024, chunk_q: int = 2048) -> torch.Tensor:
    """Non-causal attention over encoder / image memory: q (B, Sq, H, hd),
    k/v (B, Skv, K, hd) -> (B, Sq, H, hd); only the first
    ``kv_valid_len`` memory slots count when it is given.

    Sq > 1 is one non-causal flash call over the valid slots (a masked
    slot adds nothing, so slicing k/v to them is the same function; the
    reference's q blocks and ``chunk`` are its XLA schedule, accepted for
    its signature).  Sq == 1 (decode) is one decode-attention call with
    slot positions arange(Skv), -1 past ``kv_valid_len``: the
    reference's ``direct_attention`` at Sq == 1 with ``causal=False``."""
    del chunk, chunk_q
    Skv = k.shape[1]
    if q.shape[1] == 1:
        pos = torch.arange(Skv, dtype=torch.int32, device=k.device)
        if kv_valid_len is not None:
            pos = torch.where(pos < kv_valid_len, pos, -1).to(torch.int32)
        return decode_attention(q, k, v, pos)
    if kv_valid_len is not None:
        k, v = k[:, :kv_valid_len], v[:, :kv_valid_len]
    return flash_attention(q, k, v, causal=False, window=None)
