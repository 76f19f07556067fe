"""Initializers (port of ``repro.models.layers``: ``trunc_normal`` and
``dense_init``), drawn from an explicit ``torch.Generator``.

Parameters are drawn on the CPU from the generator, so a seed gives the
same numbers whatever device the model then moves to.  They cannot
reproduce ``jax.random`` bits; the parity tests install the reference's
own initial state instead (``repro_torch.bridge``).
"""
from __future__ import annotations

import math

import torch


def trunc_normal(gen: torch.Generator, shape, std: float,
                 dtype=torch.float32) -> torch.Tensor:
    """Truncated-normal (+-2 sigma) init at the given std, by inverse CDF."""
    lo = 0.5 * (1.0 + math.erf(-2.0 / math.sqrt(2.0)))
    hi = 0.5 * (1.0 + math.erf(2.0 / math.sqrt(2.0)))
    u = lo + (hi - lo) * torch.rand(shape, generator=gen, dtype=torch.float64)
    x = math.sqrt(2.0) * torch.erfinv(2.0 * u - 1.0)
    return (x.clamp(-2.0, 2.0) * std).to(dtype)


def dense_init(gen: torch.Generator, d_in: int, d_out: int,
               dtype=torch.float32, std=None) -> torch.Tensor:
    """Dense weight init; std defaults to the fan-in rule 1/sqrt(d_in)."""
    std = std if std is not None else d_in ** -0.5
    return trunc_normal(gen, (d_in, d_out), std, dtype)
