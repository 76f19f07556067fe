"""Roofline math for one NVIDIA H100 and the kernels' cost formulas (port
of ``repro.metrics.roofline``).

The three roofline terms of a step are its counted work over the card's
published rates:

  compute    = bf16 FLOPs / bf16 peak + the other FLOPs / fp32 peak
  memory     = bytes accessed / HBM rate
  collective = collective bytes / link rate

The counts come from ``metrics.cost.CostCounter`` (``launch/dryrun.py``).
One card runs no collective, so the one-card dry-run passes 0.  Over a
mesh the zoo moves bytes between ranks with the port's own collectives
(``sharding/collectives.py``: all-reduce, all-gather and reduce-scatter
over a mesh's ranks, from one process; no ``torch.distributed``); the
counter records each one's result bytes on each rank, forward and
backward, the reference's convention, and the dry-run's mesh records
pass one device's total here, over ``link_bw``.  The cascade's lane
sharding runs no collective.  The reference's
``parse_collective_bytes`` reads XLA's HLO text, which the port never
produces, so it has no counterpart here.

The kernel cost functions (``flash_cost``, ``decode_cost``, ``ssd_cost``,
``gmm_cost``) take shapes and dtypes and count what a kernel must do:
each input read once, each output written once, and the products the
algorithm needs.  The kernel ops report them to the active counter, and
``chip_smoke.py`` prints their ``bound_ms`` beside each kernel's time,
so the dry-run's count and the kernels' bounds are one code.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Mapping, NamedTuple, Optional, Sequence, Tuple, Union

import torch

from repro_torch.configs.base import ModelConfig


@dataclass(frozen=True)
class HW:
    """Per-chip hardware envelope used by the roofline terms."""

    name: str
    peak_flops: float       # bf16 (and fp16) dense FLOP/s per chip
    peak_fp32_flops: float  # fp32 FLOP/s per chip, outside the tensor cores
    hbm_bw: float           # bytes/s per chip
    link_bw: float          # bytes/s of the chip's links
    hbm_bytes: float        # capacity per chip


# NVIDIA H100 SXM data sheet, dense rates without sparsity, at the full
# 700 W power limit; link_bw is the data sheet's NVLink rate per GPU.
H100 = HW(name="h100-sxm", peak_flops=989e12, peak_fp32_flops=67e12,
          hbm_bw=3.35e12, link_bw=900e9, hbm_bytes=80e9)

# dtypes whose products run at ``peak_flops``; every other at fp32's
TENSOR_CORE_DTYPES = ("bfloat16", "float16")

FlopsLike = Union[float, Mapping[str, float]]


def dtype_name(dtype) -> str:
    """``torch.bfloat16`` or ``"bfloat16"`` -> ``"bfloat16"``."""
    return str(dtype).replace("torch.", "")


def compute_seconds(flops: FlopsLike, hw: HW = H100) -> float:
    """FLOPs over the peak of their dtype: a mapping {dtype name: FLOPs}
    puts bf16 / fp16 at ``peak_flops`` and the rest at
    ``peak_fp32_flops``; a bare number is bf16 work, as in the
    reference."""
    if not isinstance(flops, Mapping):
        return float(flops) / hw.peak_flops
    return sum(float(f) / (hw.peak_flops if d in TENSOR_CORE_DTYPES
                           else hw.peak_fp32_flops)
               for d, f in flops.items())


def roofline_terms(flops_per_dev: FlopsLike, bytes_per_dev: float,
                   coll_bytes_per_dev: float, hw: HW = H100) -> Dict:
    """Per-device seconds for each roofline term + the dominant one."""
    t_compute = compute_seconds(flops_per_dev, hw)
    t_memory = bytes_per_dev / hw.hbm_bw
    t_coll = coll_bytes_per_dev / hw.link_bw
    terms = {"compute_s": t_compute, "memory_s": t_memory,
             "collective_s": t_coll}
    dominant = max(terms, key=terms.get)
    bound = max(t_compute, t_memory, t_coll)
    terms.update({
        "dominant": dominant.replace("_s", ""),
        "bound_s": bound,
        # fraction of the bound that is useful compute (1.0 = at roofline)
        "compute_fraction": t_compute / bound if bound > 0 else 0.0,
    })
    return terms


def model_flops_6nd(cfg: ModelConfig, n_tokens: int) -> float:
    """MODEL_FLOPS = 6 * N_active * D for training; callers use 2*N*D for a
    forward pass."""
    return 6.0 * cfg.active_param_count() * n_tokens


# ---------------------------------------------------------------------------
# kernel costs
# ---------------------------------------------------------------------------
class KernelCost(NamedTuple):
    """What one kernel call must do: ``flops`` products of ``dtype`` and
    ``nbytes`` of HBM traffic (inputs read once, outputs written once)."""

    flops: float
    nbytes: int
    dtype: str

    def bound_ms(self, hw: HW = H100) -> Tuple[float, str]:
        """(max(bytes / HBM rate, FLOPs / the dtype's peak) in ms, "bytes"
        or "operations", whichever is larger)."""
        return kernel_bound(self.nbytes, self.flops, self.dtype, hw)


def kernel_bound(nbytes: float, flops: float, dtype,
                 hw: HW = H100) -> Tuple[float, str]:
    """max(bytes / HBM rate, FLOPs / the peak rate of ``dtype``), in ms,
    and which of the two it is."""
    tb = nbytes / hw.hbm_bw * 1e3
    tf = compute_seconds({dtype_name(dtype): flops}, hw) * 1e3
    return (tb, "bytes") if tb >= tf else (tf, "operations")


def _elsize(dtype) -> int:
    return getattr(torch, dtype_name(dtype)).itemsize


def flash_pairs(Sq: int, Skv: int, causal: bool = True,
                window: Optional[int] = None) -> int:
    """The (query, key) pairs the masks keep, query i and key j from
    position 0: causal j <= i, window j > i - window."""
    if Sq <= 0 or Skv <= 0:
        return 0
    c = Skv - 1                     # last key
    w = window
    # rows past the last key plus the window keep no key
    n = Sq if w is None else min(Sq, c + w)
    if causal:                      # sum over i < n of min(i, c)
        hi = n * (n - 1) // 2 if n <= c + 1 else \
            c * (c + 1) // 2 + (n - c - 1) * c
    else:
        hi = n * c
    t = 0 if w is None else max(0, n - w)
    return hi + n - t * (t + 1) // 2     # minus sum of max(0, i - w + 1)


def flash_flops(q_shape: Sequence[int], Skv: int, causal: bool = True,
                window: Optional[int] = None) -> int:
    """q·kᵀ and p·v over the kept pairs: 4·hd FLOPs a pair and head."""
    B, Sq, H, hd = q_shape
    return B * H * flash_pairs(Sq, Skv, causal, window) * 4 * hd


def flash_cost(q_shape, k_shape, dtype, causal: bool = True,
               window: Optional[int] = None) -> KernelCost:
    """Flash attention: q, k, v read, o (q's shape) written."""
    el = _elsize(dtype)
    nbytes = (2 * math.prod(q_shape) + 2 * math.prod(k_shape)) * el
    return KernelCost(flash_flops(q_shape, k_shape[1], causal, window),
                      nbytes, dtype_name(dtype))


def decode_cost(q_shape, k_shape, dtype, valid: Optional[int] = None,
                partial: bool = False) -> KernelCost:
    """One-token attention over a (B, W) cache: q and the (B, W) int32
    positions read, o written, and K / V read at the ``valid`` (batch,
    slot) pairs only (every slot when None: a count that cannot read the
    positions).  ``partial``: the ``"partial"`` variant, which writes
    fp32 (M, L, acc), (B, H, hd + 2), in o's stead."""
    B, _, H, hd = q_shape
    W, K = k_shape[1], k_shape[2]
    valid = B * W if valid is None else valid
    el = _elsize(dtype)
    out = B * H * (hd + 2) * 4 if partial else math.prod(q_shape) * el
    nbytes = (math.prod(q_shape) * el + out + B * W * 4
              + 2 * valid * K * hd * el)
    return KernelCost(valid * H * 4 * hd, nbytes, dtype_name(dtype))


def ssd_cost(x_shape, N: int, chunk: int, init_state: bool = False,
             final_state: bool = False) -> KernelCost:
    """The SSD chunked scan in fp32: C·Bᵀ once per (batch, chunk) (B and C
    are shared by the heads); per head the decay-masked scores times x,
    the inter-chunk read and the state update.  x, A·dt, dt, B, C read
    and y written; the initial and final states where the call has
    them."""
    Bsz, S, H, hp = x_shape
    L = chunk
    tri = L * (L + 1) // 2
    per_head = 2 * tri * hp + 2 * L * hp * N + 2 * hp * N * L
    flops = Bsz * (S // L) * (2 * tri * N + H * per_head)
    n = 2 * Bsz * S * H * hp + 2 * Bsz * S * H + 2 * Bsz * S * N
    n += (int(init_state) + int(final_state)) * Bsz * H * hp * N
    return KernelCost(flops, 4 * n, "float32")


def gmm_cost(x_shape, w_shape, dtype) -> KernelCost:
    """Dense grouped product (E, C, D) x (E, D, F): every capacity row
    is computed; x and w read, (E, C, F) written."""
    E, C, D = x_shape
    F = w_shape[2]
    nbytes = (E * C * D + E * D * F + E * C * F) * _elsize(dtype)
    return KernelCost(2 * E * C * D * F, nbytes, dtype_name(dtype))
