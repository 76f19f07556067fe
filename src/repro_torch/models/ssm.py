"""Mamba2 block (state-space duality / SSD) in PyTorch (port of
``repro.models.ssm``: ``dims``, ``init_mamba``, ``_causal_conv``,
``ssd_chunked`` and ``mamba_forward``).

Layout (n_groups = 1):
  in_proj : (D, 2*d_in + 2*d_state + n_heads) -> [z, x, B, C, dt]
  conv    : depthwise causal conv over [x, B, C]  (kernel d_conv)
  SSD     : h_t = h_{t-1} * exp(A dt_t) + dt_t * B_t (x) x_t ;  y_t = C_t h_t
  gate    : y = RMSNorm(y * silu(z)) @ out_proj   (+ D skip)

``ssd_chunked`` is the differentiable plain path (the kernels' plain
chunk loop, ``kernels.ssd_scan.ref``, behind a ragged-tail pad);
``mamba_forward(ssd_impl=)``
swaps in the CUDA ``kernels.ssd_scan`` for serving forwards
(``models/kernel_students.py``).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.ssd_scan.ref import ssd_scan_chunked_ref
from repro_torch.models.layers import dense_init, trunc_normal


def dims(cfg: ModelConfig):
    """Derived mamba dims for ``cfg.ssm``: (d_inner, n_heads, d_xbc)."""
    s = cfg.ssm
    d_in = s.expand * cfg.d_model
    n_heads = d_in // s.head_dim
    d_xbc = d_in + 2 * s.d_state
    return d_in, n_heads, d_xbc


def init_mamba(gen: torch.Generator, cfg: ModelConfig):
    """Initialize one Mamba2 block's params (reference distributions,
    drawn on the CPU from ``gen``)."""
    s = cfg.ssm
    d = cfg.d_model
    d_in, n_heads, d_xbc = dims(cfg)
    dtype = cfg.torch_dtype
    proj_out = 2 * d_in + 2 * s.d_state + n_heads
    in_proj = dense_init(gen, d, proj_out, dtype)
    conv_w = trunc_normal(gen, (s.d_conv, d_xbc), d_xbc ** -0.5, dtype)
    # dt bias initialized so softplus(dt_bias) spans [1e-3, 1e-1]
    u = torch.rand((n_heads,), generator=gen, dtype=torch.float32)
    dt_init = torch.exp(u * (math.log(0.1) - math.log(1e-3))
                        + math.log(1e-3))
    dt_bias = dt_init + torch.log(-torch.expm1(-dt_init))   # inv softplus
    out_proj = dense_init(gen, d_in, d, dtype)
    return {
        "in_proj": in_proj,
        "conv_w": conv_w,
        "conv_b": torch.zeros((d_xbc,), dtype=torch.float32),
        "dt_bias": dt_bias,
        "A_log": torch.log(torch.arange(1, n_heads + 1,
                                        dtype=torch.float32)),
        "D": torch.ones((n_heads,), dtype=torch.float32),
        "gate_norm": torch.ones((d_in,), dtype=torch.float32),
        "out_proj": out_proj,
    }


def _causal_conv(xbc, conv_w, conv_b):
    """Depthwise causal conv from a zero left context.
    xbc: (B, S, C); conv_w: (K, C).  Returns (B, S, C)."""
    B, S, C = xbc.shape
    K = conv_w.shape[0]
    full = torch.cat([xbc.new_zeros((B, K - 1, C)), xbc], dim=1)
    out = torch.zeros((B, S, C), dtype=torch.float32, device=xbc.device)
    for i in range(K):
        out = out + full[:, i:i + S, :].float() * conv_w[i]
    out = out + conv_b
    return out.to(xbc.dtype)


def ssd_chunked(x, adt, dt, Bmat, Cmat, chunk: int):
    """SSD over a sequence, chunked (the differentiable plain path).

    x:    (B, S, H, P)  head inputs
    adt:  (B, S, H)     A * dt  (negative)
    dt:   (B, S, H)
    Bmat: (B, S, N)     input projections (shared across heads, n_groups=1)
    Cmat: (B, S, N)
    Returns y (B, S, H, P) in float32.  The chunk loop is the kernels'
    plain twin ``ssd_scan_chunked_ref``; this adds the ragged-tail pad.
    """
    S = x.shape[1]
    L = min(chunk, S)
    pad = -S % L
    if pad:
        # ragged tail: pad with dt=0 tokens (decay 1, no state update —
        # provably inert) and drop their outputs at the end
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        adt = F.pad(adt, (0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        Bmat = F.pad(Bmat, (0, 0, 0, pad))
        Cmat = F.pad(Cmat, (0, 0, 0, pad))
    y = ssd_scan_chunked_ref(x.float(), adt, dt, Bmat, Cmat, L)
    return y[:, :S]


def mamba_forward(params, x, cfg: ModelConfig, ssd_impl=None):
    """Full-sequence Mamba2 block.  x: (B, S, D) -> (B, S, D).

    ``ssd_impl(x, adt, dt, B, C, chunk) -> y`` swaps the inner SSD scan;
    the default is the differentiable ``ssd_chunked``."""
    s = cfg.ssm
    d_in, n_heads, d_xbc = dims(cfg)
    B, S, D = x.shape
    proj = x @ params["in_proj"]                            # (B, S, ...)
    z, xi, Bm, Cm, dt = torch.split(
        proj, [d_in, d_in, s.d_state, s.d_state, n_heads], dim=-1)
    xbc = torch.cat([xi, Bm, Cm], dim=-1)
    xbc = _causal_conv(xbc, params["conv_w"], params["conv_b"])
    xbc = F.silu(xbc)
    xi, Bm, Cm = torch.split(xbc, [d_in, s.d_state, s.d_state], dim=-1)

    dt = F.softplus(dt.float() + params["dt_bias"])
    A = -torch.exp(params["A_log"])                         # (H,)
    adt = A * dt                                            # (B, S, H)
    xh = xi.reshape(B, S, n_heads, s.head_dim)
    impl = ssd_impl if ssd_impl is not None else ssd_chunked
    y = impl(xh, adt, dt, Bm, Cm, s.chunk)
    y = y + params["D"][None, None, :, None] * xh.float()
    y = y.reshape(B, S, d_in)

    # gated RMSNorm (Mamba2)
    y = y * F.silu(z.float())
    ms = torch.mean(torch.square(y), dim=-1, keepdim=True)
    y = y * torch.rsqrt(ms + 1e-6) * params["gate_norm"]
    return y.to(cfg.torch_dtype) @ params["out_proj"]
