"""Top-k MoE with GShard-style capacity dispatch (port of
``repro.models.moe``, the local path).

Tokens are routed top-k over the experts, dispatched into per-expert
capacity buffers with one-hot einsums (earlier top-k slots claim queue
positions first; tokens past an expert's capacity are dropped), run
through each expert's SwiGLU FFN — three grouped matmuls on the port's
CUDA ``moe_gmm`` kernel — and combined back with their gate weights.

Over a mesh (``moe_ffn_sharded``, the reference's ``shard_map`` path)
the tokens split over the data axes and the weights over 'model': in
tensor mode every rank holds all experts with a slice of the expert ff
dim, in expert mode a slice of the experts.  Without a mesh, or without
a data axis to split the tokens over, the local path runs (over a
'model' axis its weights are the rank's slice and the ranks' outputs
are added).  Aux losses (load-balance + router-z) are returned as in the
reference.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.moe_gmm import moe_gmm
from repro_torch.models.layers import dense_init, trunc_normal
from repro_torch.sharding import collectives as col
from repro_torch.sharding.specs import _axis_size, batch_axes, get_mesh

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


def _moe_experts(x2d, params, cfg: ModelConfig, capacity: int, e0: int):
    """``_moe_group`` on one model rank in expert mode: routing and
    dispatch over all E experts, computed redundantly on every rank,
    then only the rank's experts [e0, e0 + E_loc) run and are combined.
    Returns the rank's fp32 addend of y (the ranks' sum is y) and aux."""
    top_idx, top_w, aux = route(x2d, params["router"], cfg)
    dispatch, combine = _dispatch_combine(top_idx, top_w, x2d.shape[0],
                                          capacity, cfg)
    e1 = e0 + params["w_in"].shape[0]
    inp = torch.einsum("tec,td->ecd", dispatch[:, e0:e1],
                       x2d.float()).to(cfg.torch_dtype)
    out = _expert_ffn(inp, params, cfg)
    return torch.einsum("tec,ecd->td", combine[:, e0:e1], out.float()), aux


def moe_ffn_local(x2d, params, cfg: ModelConfig, capacity: int = None,
                  expert0: int = None):
    """Single-shard GShard MoE: x2d (T, D) -> (y (T, D), aux loss).

    Tokens are processed in groups of MOE_GROUP (the reference's
    ``lax.scan`` over groups is a loop here): capacity, and with it the
    (T, E, C) dispatch one-hot, scales with the group, not the shard.
    With ``expert0``, ``params`` hold experts [expert0, expert0 + E_loc)
    and y is their fp32 addend (``_moe_experts``)."""
    def group(xg, cap):
        if expert0 is None:
            return _moe_group(xg, params, cfg, cap)
        return _moe_experts(xg, params, cfg, cap, expert0)

    T = x2d.shape[0]
    if T <= MOE_GROUP or T % MOE_GROUP != 0:
        return group(x2d, capacity or capacity_for(T, cfg))
    cap = capacity or capacity_for(MOE_GROUP, cfg)
    ys, auxs = [], []
    for g0 in range(0, T, MOE_GROUP):
        y, aux = group(x2d[g0:g0 + MOE_GROUP], cap)
        ys.append(y)
        auxs.append(aux)
    return torch.cat(ys, dim=0), torch.stack(auxs).mean()


def moe_ffn(x, params, cfg: ModelConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, D) -> (y, aux) on the local path (no mesh)."""
    B, S, D = x.shape
    y, aux = moe_ffn_local(x.reshape(B * S, D), params, cfg)
    return y.reshape(B, S, D), aux


def _tokens_shardable(n_tokens: int) -> bool:
    mesh = get_mesh()
    if mesh is None:
        return False
    baxes = batch_axes(mesh)
    if not baxes:
        return False
    dp = _axis_size(mesh, baxes)
    return n_tokens % dp == 0 and n_tokens // dp >= 1


def moe_ffn_sharded(x: "col.Sharded", params, cfg: ModelConfig):
    """The MoE over the installed mesh.  ``x``: each rank's (B_loc, S, D)
    tokens, the batch split over the data axes or whole (a
    ``Sharded`` of spec (batch, (), ())); ``params``: each rank's MoE
    params (``sharding.place``).  Returns (y in ``x``'s layout, each
    rank's aux).

    Where the tokens split over the data axes (``_tokens_shardable``),
    data rank i takes rows [i, i+1) x T/dp of the flattened (B*S, D)
    tokens, the reference's ``shard_map`` blocks:
      * tensor mode: ``moe_ffn_local(x_loc, capacity=None)`` (grouped)
        on the rank's ff slice, the ranks' y all-reduced over 'model';
      * expert mode: ungrouped routing and dispatch at
        ``capacity_for(T/dp)``, the rank's experts only, all-reduced.
    aux is then the mean over the data slices and over 'model' (the
    reference's ``pmean``s).  Otherwise the local path runs on every
    token, on each rank's weight slice, and y is all-reduced."""
    mesh = get_mesh()
    baxes = batch_axes(mesh)
    B, S, D = x.shape
    T = B * S
    expert = cfg.moe.sharding_mode == "expert" and \
        "model" in mesh.axis_names
    e_loc = params[0]["w_in"].shape[0]

    def e0(r):
        return col.axis_rank(r, "model") * e_loc if expert else None

    if not _tokens_shardable(T):
        outs = col.rank_map(lambda r, p, xr: moe_ffn_local(
            xr.reshape(-1, D), p, cfg, expert0=e0(r)), params, x.parts)
        ys = col.all_reduce([y for y, _ in outs], "model")
        ys = [y.to(x.parts[0].dtype).reshape(xr.shape)
              for y, xr in zip(ys, x.parts)]
        return col.Sharded(ys, x.spec), [a for _, a in outs]

    dp = _axis_size(mesh, baxes)
    t_loc = T // dp
    cap = capacity_for(t_loc, cfg)
    local_rows = x.spec[0] == baxes

    def one(r, p, xr):
        x2d = xr.reshape(-1, D)
        if not local_rows:
            i = col.axis_rank(r, baxes)
            x2d = x2d[i * t_loc:(i + 1) * t_loc]
        if expert:
            return _moe_experts(x2d, p, cfg, cap, e0(r))
        return moe_ffn_local(x2d, p, cfg, capacity=None)

    outs = col.rank_map(one, params, x.parts)
    ys = [y.to(x.parts[0].dtype) for y in
          col.all_reduce([y for y, _ in outs], "model")]
    if not local_rows:
        ys = col.all_gather(ys, baxes, dim=0)
    ys = [y.reshape(xr.shape) for y, xr in zip(ys, x.parts)]
    aux = [a / dp for a in col.all_reduce([a for _, a in outs], baxes)]
    m = col.axis_size("model")
    aux = [a / m for a in col.all_reduce(aux, "model")]
    return col.Sharded(ys, x.spec), aux
