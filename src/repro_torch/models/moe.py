"""Top-k MoE with GShard-style capacity dispatch (port of
``repro.models.moe``, the local path).

Tokens are routed top-k over the experts, dispatched into per-expert
capacity buffers with one-hot einsums (earlier top-k slots claim queue
positions first; tokens past an expert's capacity are dropped), run
through each expert's SwiGLU FFN — three grouped matmuls on the port's
CUDA ``moe_gmm`` kernel — and combined back with their gate weights.

The reference's ``shard_map`` path (tokens over the data axes, experts
over 'model') waits for the zoo's model sharding (ROADMAP Queue 1 item
14); without a mesh the reference takes this local path too.  Aux losses
(load-balance + router-z) are returned as in the reference.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.moe_gmm import moe_gmm
from repro_torch.models.layers import dense_init, trunc_normal

MOE_GROUP = 2048  # tokens per dispatch group (GShard 'group size')


def init_moe(gen, cfg: ModelConfig):
    """Router + per-expert SwiGLU weights, stacked on a leading E axis."""
    m = cfg.moe
    d, f, e = cfg.d_model, m.d_ff_expert, m.num_experts
    return {
        "router": dense_init(gen, d, e, torch.float32),
        "w_in": trunc_normal(gen, (e, d, f), d ** -0.5, cfg.torch_dtype),
        "w_gate": trunc_normal(gen, (e, d, f), d ** -0.5, cfg.torch_dtype),
        "w_out": trunc_normal(gen, (e, f, d), f ** -0.5, cfg.torch_dtype),
    }


def capacity_for(n_tokens: int, cfg: ModelConfig) -> int:
    """Per-expert token capacity (top_k * T / E * factor, rounded to 4)."""
    m = cfg.moe
    c = math.ceil(m.top_k * n_tokens / m.num_experts * m.capacity_factor)
    return max(4, ((c + 3) // 4) * 4)


def one_hot(idx, n: int, dtype=torch.float32):
    """``jax.nn.one_hot(idx, n)`` as a comparison with ``arange(n)`` (a
    zero row for an index outside [0, n)).  ``F.one_hot`` scatters on the
    card and compares on ``meta``, so its bytes would differ between a
    step and its dry-run count; this is one decomposition everywhere."""
    return (idx.unsqueeze(-1) == torch.arange(n, device=idx.device)).to(dtype)


def route(x2d, router_w, cfg: ModelConfig):
    """x2d: (T, D) -> top-k indices/weights + aux losses (fp32)."""
    m = cfg.moe
    logits = x2d.float() @ router_w                          # (T, E)
    probs = torch.softmax(logits, dim=-1)
    top_w, top_idx = torch.topk(probs, m.top_k, dim=-1)      # (T, k)
    top_w = top_w / torch.clamp(top_w.sum(-1, keepdim=True), min=1e-9)
    # load-balance loss (Switch): E * sum_e f_e * p_e
    assign = one_hot(top_idx, m.num_experts)
    frac_tokens = assign.sum(1).mean(0)                      # (E,)
    frac_probs = probs.mean(0)
    lb = m.num_experts * (frac_tokens * frac_probs).sum() \
        * m.load_balance_weight
    zl = (torch.logsumexp(logits, dim=-1) ** 2).mean() * m.router_z_weight
    return top_idx, top_w, lb + zl


def _dispatch_combine(top_idx, top_w, n_tokens: int, capacity: int,
                      cfg: ModelConfig):
    """Build (T, E, C) dispatch (0/1) and combine (gated) tensors."""
    m = cfg.moe
    E, k = m.num_experts, m.top_k
    dev = top_idx.device
    # Sequential slot priority: earlier top-k slots claim queue positions
    # first (GShard §3.2).
    dispatch = torch.zeros((n_tokens, E, capacity), device=dev)
    combine = torch.zeros((n_tokens, E, capacity), device=dev)
    used = torch.zeros((E,), dtype=torch.int64, device=dev)
    for slot in range(k):
        mask = one_hot(top_idx[:, slot], E, torch.int64)        # (T, E)
        pos = torch.cumsum(mask, dim=0) - 1 + used[None, :]     # (T, E)
        keep = (pos < capacity) & (mask > 0)
        # a token past the capacity has a zero row, as in the reference
        pos_oh = one_hot(pos, capacity)
        sel = keep.float()[..., None] * pos_oh
        dispatch = dispatch + sel
        combine = combine + sel * top_w[:, slot][:, None, None]
        used = used + mask.sum(0)
    return dispatch, combine


def _expert_ffn(inp, params, cfg: ModelConfig):
    """inp: (E, C, D) -> (E, C, D) through each expert's SwiGLU; the three
    grouped products run on the ``moe_gmm`` kernel, SiLU * h in the model
    dtype as in the reference."""
    h = moe_gmm(inp, params["w_in"])
    g = moe_gmm(inp, params["w_gate"])
    h = F.silu(g) * h
    return moe_gmm(h, params["w_out"])


def _moe_group(x2d, params, cfg: ModelConfig, capacity: int):
    top_idx, top_w, aux = route(x2d, params["router"], cfg)
    dispatch, combine = _dispatch_combine(top_idx, top_w, x2d.shape[0],
                                          capacity, cfg)
    inp = torch.einsum("tec,td->ecd", dispatch,
                       x2d.float()).to(cfg.torch_dtype)
    out = _expert_ffn(inp, params, cfg)
    y = torch.einsum("tec,ecd->td", combine, out.float())
    return y.to(x2d.dtype), aux


def moe_ffn_local(x2d, params, cfg: ModelConfig, capacity: int = None):
    """Single-shard GShard MoE: x2d (T, D) -> (y (T, D), aux loss).

    Tokens are processed in groups of MOE_GROUP (the reference's
    ``lax.scan`` over groups is a loop here): capacity, and with it the
    (T, E, C) dispatch one-hot, scales with the group, not the shard."""
    T = x2d.shape[0]
    if T <= MOE_GROUP or T % MOE_GROUP != 0:
        capacity = capacity or capacity_for(T, cfg)
        return _moe_group(x2d, params, cfg, capacity)
    cap = capacity or capacity_for(MOE_GROUP, cfg)
    ys, auxs = [], []
    for g0 in range(0, T, MOE_GROUP):
        y, aux = _moe_group(x2d[g0:g0 + MOE_GROUP], params, cfg, cap)
        ys.append(y)
        auxs.append(aux)
    return torch.cat(ys, dim=0), torch.stack(auxs).mean()


def moe_ffn(x, params, cfg: ModelConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, D) -> (y, aux) on the local path (no mesh)."""
    B, S, D = x.shape
    y, aux = moe_ffn_local(x.reshape(B * S, D), params, cfg)
    return y.reshape(B, S, D), aux
