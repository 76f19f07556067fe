"""Mamba2 block (state-space duality / SSD) in PyTorch (port of
``repro.models.ssm``: ``dims``, ``init_mamba``, ``_causal_conv``,
``ssd_chunked``, ``mamba_forward`` and ``mamba_decode_step``).

Layout (n_groups = 1):
  in_proj : (D, 2*d_in + 2*d_state + n_heads) -> [z, x, B, C, dt]
  conv    : depthwise causal conv over [x, B, C]  (kernel d_conv)
  SSD     : h_t = h_{t-1} * exp(A dt_t) + dt_t * B_t (x) x_t ;  y_t = C_t h_t
  gate    : y = RMSNorm(y * silu(z)) @ out_proj   (+ D skip)

``ssd_chunked`` is the differentiable plain path (the kernels' plain
chunk loop, ``kernels.ssd_scan.ref``, behind a ragged-tail pad);
``ssd_kernel`` is the same contract on the CUDA ``kernels.ssd_scan``
(the zoo's prefill: it returns the final state the MAMBA cache is built
from).  ``mamba_forward(ssd_impl=)`` swaps either in; the cascade's
``ssm`` student passes a y-only adapter of its own
(``models/kernel_students.py``).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.ssd_scan import ssd_scan
from repro_torch.kernels.ssd_scan.ref import ssd_scan_chunked_ref
from repro_torch.models.layers import dense_init, param_device, trunc_normal


def dims(cfg: ModelConfig):
    """Derived mamba dims for ``cfg.ssm``: (d_inner, n_heads, d_xbc)."""
    s = cfg.ssm
    d_in = s.expand * cfg.d_model
    n_heads = d_in // s.head_dim
    d_xbc = d_in + 2 * s.d_state
    return d_in, n_heads, d_xbc


def init_mamba(gen, cfg: ModelConfig):
    """Initialize one Mamba2 block's params (reference distributions,
    drawn from ``gen`` on its device; ``gen=None`` builds the tree on the
    ``meta`` device)."""
    s = cfg.ssm
    d = cfg.d_model
    d_in, n_heads, d_xbc = dims(cfg)
    dtype = cfg.torch_dtype
    dev = param_device(gen)
    proj_out = 2 * d_in + 2 * s.d_state + n_heads
    in_proj = dense_init(gen, d, proj_out, dtype)
    conv_w = trunc_normal(gen, (s.d_conv, d_xbc), d_xbc ** -0.5, dtype)
    if gen is None:
        dt_bias = torch.empty((n_heads,), dtype=torch.float32, device=dev)
    else:
        # dt bias initialized so softplus(dt_bias) spans [1e-3, 1e-1]
        u = torch.rand((n_heads,), generator=gen, dtype=torch.float32,
                       device=dev)
        dt_init = torch.exp(u * (math.log(0.1) - math.log(1e-3))
                            + math.log(1e-3))
        dt_bias = dt_init + torch.log(-torch.expm1(-dt_init))  # inv softplus
    out_proj = dense_init(gen, d_in, d, dtype)
    return {
        "in_proj": in_proj,
        "conv_w": conv_w,
        "conv_b": torch.zeros((d_xbc,), dtype=torch.float32, device=dev),
        "dt_bias": dt_bias,
        "A_log": torch.log(torch.arange(1, n_heads + 1, dtype=torch.float32,
                                        device=dev)),
        "D": torch.ones((n_heads,), dtype=torch.float32, device=dev),
        "gate_norm": torch.ones((d_in,), dtype=torch.float32, device=dev),
        "out_proj": out_proj,
    }


def _causal_conv(xbc, conv_w, conv_b, prev=None):
    """Depthwise causal conv.  xbc: (B, S, C); conv_w: (K, C).

    ``prev``: (B, K-1, C) left context (decode), zeros if None.  Returns
    (out (B, S, C), new_prev (B, K-1, C)): the last K-1 rows of
    ``[prev, xbc]``."""
    B, S, C = xbc.shape
    K = conv_w.shape[0]
    if prev is None:
        prev = xbc.new_zeros((B, K - 1, C))
    full = torch.cat([prev, xbc], dim=1)                   # (B, S+K-1, C)
    out = torch.zeros((B, S, C), dtype=torch.float32, device=xbc.device)
    for i in range(K):
        out = out + full[:, i:i + S, :].float() * conv_w[i]
    out = out + conv_b
    new_prev = full[:, -(K - 1):, :] if K > 1 else prev
    return out.to(xbc.dtype), new_prev


def _ssd_padded(scan, x, adt, dt, Bmat, Cmat, chunk: int, init_state=None):
    """Run ``scan`` over a sequence whose length need not divide by the
    chunk: a ragged tail is padded with dt=0 tokens (decay 1, no state
    update — provably inert) whose outputs are dropped.  x, B and C go in
    as fp32.  Returns (y (B, S, H, P) fp32, final state (B, H, P, N))."""
    S = x.shape[1]
    L = min(chunk, S)
    pad = -S % L
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        adt = F.pad(adt, (0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        Bmat = F.pad(Bmat, (0, 0, 0, pad))
        Cmat = F.pad(Cmat, (0, 0, 0, pad))
    y, h = scan(x.float(), adt.float(), dt.float(), Bmat.float(),
                Cmat.float(), L, init_state)
    return y[:, :S], h


def _plain_scan(x, adt, dt, Bmat, Cmat, L, init_state):
    return ssd_scan_chunked_ref(x, adt, dt, Bmat, Cmat, L,
                                init_state=init_state, return_state=True)


def _kernel_scan(x, adt, dt, Bmat, Cmat, L, init_state):
    return ssd_scan(x, adt, dt, Bmat, Cmat, chunk=L, init_state=init_state,
                    return_state=True)


def ssd_chunked(x, adt, dt, Bmat, Cmat, chunk: int, init_state=None):
    """SSD over a sequence, chunked (the differentiable plain path).

    x:    (B, S, H, P)  head inputs
    adt:  (B, S, H)     A * dt  (negative)
    dt:   (B, S, H)
    Bmat: (B, S, N)     input projections (shared across heads, n_groups=1)
    Cmat: (B, S, N)
    init_state: (B, H, P, N) or None (zeros).
    Returns (y (B, S, H, P) float32, final_state (B, H, P, N) float32).
    The chunk loop is the kernels' plain twin ``ssd_scan_chunked_ref``."""
    return _ssd_padded(_plain_scan, x, adt, dt, Bmat, Cmat, chunk,
                       init_state)


def ssd_kernel(x, adt, dt, Bmat, Cmat, chunk: int, init_state=None):
    """``ssd_chunked``'s contract on ``kernels.ssd_scan``: the CUDA kernel
    on a CUDA tensor (differentiated through its plain twin,
    ``kernels.autograd``), the plain twin on a CPU one."""
    return _ssd_padded(_kernel_scan, x, adt, dt, Bmat, Cmat, chunk,
                       init_state)


def _split_proj(proj, d_in: int, n_heads: int, cfg: ModelConfig):
    s = cfg.ssm
    return torch.split(proj, [d_in, d_in, s.d_state, s.d_state, n_heads],
                       dim=-1)


def _block_dims(params):
    """(d_inner, n_heads) of a block's params: the config's, or one model
    rank's share of them (``models.sharded``)."""
    return params["gate_norm"].shape[0], params["A_log"].shape[0]


def gate_out(params, y, ms, cfg: ModelConfig):
    """The gated RMSNorm's scaling of ``y`` (y * silu(z), fp32) by the
    mean square ``ms`` over d_inner, and the output projection."""
    y = y * torch.rsqrt(ms + 1e-6) * params["gate_norm"]
    return y.to(cfg.torch_dtype) @ params["out_proj"]


def _gate_out(params, y, cfg: ModelConfig):
    """Gated RMSNorm (Mamba2) and the output projection; ``y`` is
    already gated."""
    ms = torch.mean(torch.square(y), dim=-1, keepdim=True)
    return gate_out(params, y, ms, cfg)


def mamba_scan(params, x, cfg: ModelConfig, conv_prev=None, ssm_state=None,
               ssd_impl=None):
    """The block up to its gated norm: (y * silu(z) (B, S, d_in) fp32,
    (conv_state, the scan's final state)).  ``mamba_forward`` is this
    and ``_gate_out``."""
    s = cfg.ssm
    d_in, n_heads = _block_dims(params)
    B, S, D = x.shape
    proj = x @ params["in_proj"]                            # (B, S, ...)
    z, xi, Bm, Cm, dt = _split_proj(proj, d_in, n_heads, cfg)
    xbc = torch.cat([xi, Bm, Cm], dim=-1)
    xbc, conv_new = _causal_conv(xbc, params["conv_w"], params["conv_b"],
                                 conv_prev)
    xbc = F.silu(xbc)
    xi, Bm, Cm = torch.split(xbc, [d_in, s.d_state, s.d_state], dim=-1)

    dt = F.softplus(dt.float() + params["dt_bias"])
    A = -torch.exp(params["A_log"])                         # (H,)
    adt = A * dt                                            # (B, S, H)
    xh = xi.reshape(B, S, n_heads, s.head_dim)
    impl = ssd_impl if ssd_impl is not None else ssd_chunked
    y, h_final = impl(xh, adt, dt, Bm, Cm, s.chunk, init_state=ssm_state)
    y = y + params["D"][None, None, :, None] * xh.float()
    y = y.reshape(B, S, d_in) * F.silu(z.float())
    return y, (conv_new, h_final)


def mamba_forward(params, x, cfg: ModelConfig, conv_prev=None,
                  ssm_state=None, return_state=False, ssd_impl=None):
    """Full-sequence Mamba2 block.  x: (B, S, D) -> (B, S, D), or with
    ``return_state`` (out, (conv_state (B, K-1, d_xbc), ssm_state (B, H,
    P, N) fp32)).

    ``ssd_impl(x, adt, dt, B, C, chunk, init_state=) -> (y, final_state)``
    swaps the inner SSD scan; the default is the differentiable
    ``ssd_chunked``."""
    y, (conv_new, h_final) = mamba_scan(params, x, cfg, conv_prev,
                                        ssm_state, ssd_impl)
    out = _gate_out(params, y, cfg)
    if return_state:
        return out, (conv_new, h_final.float())
    return out


def mamba_decode_scan(params, x, cfg: ModelConfig, conv_prev, ssm_state):
    """``mamba_decode_step`` up to its gated norm: (y * silu(z) (B, 1,
    d_in) fp32, (conv_state, ssm_state))."""
    s = cfg.ssm
    d_in, n_heads = _block_dims(params)
    proj = x @ params["in_proj"]
    z, xi, Bm, Cm, dt = _split_proj(proj, d_in, n_heads, cfg)
    xbc = torch.cat([xi, Bm, Cm], dim=-1)                   # (B, 1, d_xbc)
    xbc, conv_new = _causal_conv(xbc, params["conv_w"], params["conv_b"],
                                 conv_prev)
    xbc = F.silu(xbc)
    xi, Bm, Cm = torch.split(xbc, [d_in, s.d_state, s.d_state], dim=-1)
    y, h_new = decode_ssd(params, z, xi, Bm, Cm, dt, cfg, ssm_state)
    return y, (conv_new, h_new)


def decode_ssd(params, z, xi, Bm, Cm, dt, cfg: ModelConfig, ssm_state):
    """``mamba_decode_scan`` after its conv: one token's SSD step of the
    heads ``params`` hold (their z, x and dt columns; B and C whole, after
    the SiLU) on ``ssm_state`` (B, H, P, N) fp32, gated by silu(z).
    Returns (y * silu(z) (B, 1, d_in) fp32, the new state)."""
    s = cfg.ssm
    d_in, n_heads = _block_dims(params)
    B = xi.shape[0]
    dt = F.softplus(dt.float() + params["dt_bias"])[:, 0]  # (B, H)
    A = -torch.exp(params["A_log"])
    dA = torch.exp(A * dt)                                  # (B, H)
    xh = xi[:, 0].reshape(B, n_heads, s.head_dim).float()
    Bv = Bm[:, 0].float()                                   # (B, N)
    Cv = Cm[:, 0].float()
    # state update: h = h * dA + dt * B (x) x
    upd = torch.einsum("bh,bn,bhp->bhpn", dt, Bv, xh)
    h_new = ssm_state * dA[:, :, None, None] + upd
    y = torch.einsum("bn,bhpn->bhp", Cv, h_new)
    y = y + params["D"][None, :, None] * xh
    return y.reshape(B, 1, d_in) * F.silu(z.float()), h_new


def mamba_decode_step(params, x, cfg: ModelConfig, conv_prev, ssm_state):
    """Single-token step.  x: (B, 1, D); states threaded explicitly.

    conv_prev: (B, d_conv-1, d_xbc); ssm_state: (B, H, P, N) fp32.
    Returns (out (B, 1, D), (conv_state, ssm_state))."""
    y, state = mamba_decode_scan(params, x, cfg, conv_prev, ssm_state)
    return _gate_out(params, y, cfg), state
