"""Shared layers (port of ``repro.models.layers``): initializers, norms,
embeddings, the LM head, the softmax cross-entropy and the dense MLP.

Parameters are drawn from an explicit ``torch.Generator`` on the
generator's own device, so a seed gives the same numbers on every call
(a CPU generator gives the same numbers whatever device the model then
moves to; a CUDA generator draws full-width weights on the card).  They
cannot reproduce ``jax.random`` bits; the parity tests install the
reference's own initial state instead (``repro_torch.bridge``).  A
``gen`` of ``None`` builds the same tree on the ``meta`` device: shapes
and dtypes with no storage, which is what ``bridge.load_zoo_params``
checks a reference tree against.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig

VOCAB_PAD = 512  # pad vocab so the lm-head dim divides the model axis


def param_device(gen: Optional[torch.Generator]) -> torch.device:
    """Where parameters drawn from ``gen`` live (``meta`` for None)."""
    return torch.device("meta") if gen is None else gen.device


def padded_vocab(cfg: ModelConfig) -> int:
    """Vocab rounded up to the next VOCAB_PAD multiple (lm-head dim)."""
    return ((cfg.vocab + VOCAB_PAD - 1) // VOCAB_PAD) * VOCAB_PAD


def trunc_normal(gen: Optional[torch.Generator], shape, std: float,
                 dtype=torch.float32) -> torch.Tensor:
    """Truncated-normal (+-2 sigma) init at the given std, by inverse CDF
    in float64 (in place, so a full-width expert weight needs one float64
    buffer)."""
    if gen is None:
        return torch.empty(shape, dtype=dtype, device="meta")
    lo = 0.5 * (1.0 + math.erf(-2.0 / math.sqrt(2.0)))
    hi = 0.5 * (1.0 + math.erf(2.0 / math.sqrt(2.0)))
    u = torch.rand(shape, generator=gen, dtype=torch.float64,
                   device=gen.device)
    u.mul_(hi - lo).add_(lo).mul_(2.0).sub_(1.0).erfinv_()
    u.mul_(math.sqrt(2.0)).clamp_(-2.0, 2.0).mul_(std)
    return u.to(dtype)


def dense_init(gen: Optional[torch.Generator], d_in: int, d_out: int,
               dtype=torch.float32, std=None) -> torch.Tensor:
    """Dense weight init; std defaults to the fan-in rule 1/sqrt(d_in)."""
    std = std if std is not None else d_in ** -0.5
    return trunc_normal(gen, (d_in, d_out), std, dtype)


# ---------------------------------------------------------------------------
# Norms.  Scales kept in fp32; compute in fp32, cast back.
# ---------------------------------------------------------------------------
def init_norm(cfg: ModelConfig, d=None, device=None):
    """Norm params for cfg.norm (layernorm: scale+bias; rmsnorm: scale)."""
    d = d or cfg.d_model
    if cfg.norm == "layernorm":
        return {"scale": torch.ones((d,), device=device),
                "bias": torch.zeros((d,), device=device)}
    return {"scale": torch.ones((d,), device=device)}


def apply_norm(params, x, cfg: ModelConfig, eps=1e-6):
    """Layer/RMS norm per cfg.norm; fp32 compute, cast back to x.dtype."""
    xf = x.float()
    if cfg.norm == "layernorm":
        mu = xf.mean(-1, keepdim=True)
        var = (xf - mu).square().mean(-1, keepdim=True)
        y = (xf - mu) * torch.rsqrt(var + eps) * params["scale"] \
            + params["bias"]
    else:
        ms = xf.square().mean(-1, keepdim=True)
        y = xf * torch.rsqrt(ms + eps) * params["scale"]
    return y.to(x.dtype)


def rms_norm_headwise(x, scale, eps=1e-6):
    """Per-head RMSNorm over the last dim (qk-norm, Qwen3)."""
    xf = x.float()
    ms = xf.square().mean(-1, keepdim=True)
    return (xf * torch.rsqrt(ms + eps) * scale).to(x.dtype)


# ---------------------------------------------------------------------------
# Embedding / LM head
# ---------------------------------------------------------------------------
def init_embed(gen, cfg: ModelConfig):
    """Token embedding table at the padded vocab size."""
    v = padded_vocab(cfg)
    return {"table": trunc_normal(gen, (v, cfg.d_model), cfg.d_model ** -0.5,
                                  cfg.torch_dtype)}


def embed(params, tokens, cfg: ModelConfig):
    """Gather token embeddings: (...,) ids -> (..., d_model)."""
    return params["table"][tokens]


def embed_shard(params, tokens, v0: int):
    """One model rank's part of a vocab-parallel lookup: its table holds
    rows [v0, v0 + rows); an id outside them gives a zero row, so the
    ranks' parts add up to ``embed`` (an all-reduce over 'model')."""
    table = params["table"]
    local = tokens - v0
    ok = (local >= 0) & (local < table.shape[0])
    rows = table[local.clamp(0, table.shape[0] - 1)]
    return rows * ok[..., None].to(rows.dtype)


def init_lm_head(gen, cfg: ModelConfig):
    """LM head weights; empty when cfg ties them to the embedding."""
    if cfg.tie_embeddings:
        return {}
    v = padded_vocab(cfg)
    return {"w": dense_init(gen, cfg.d_model, v, cfg.torch_dtype)}


def lm_logits(params, embed_params, x, cfg: ModelConfig):
    """x: (..., d_model) -> logits (..., padded_vocab); pad cols masked."""
    if cfg.tie_embeddings:
        w = embed_params["table"].T
    else:
        w = params["w"]
    logits = torch.einsum("...d,dv->...v", x, w).float()
    v = padded_vocab(cfg)
    if v != cfg.vocab:
        pad_mask = (torch.arange(v, device=x.device) >= cfg.vocab).float()
        logits = logits - 1e9 * pad_mask
    return logits


def lm_logits_shard(params, embed_params, x, cfg: ModelConfig, v0: int):
    """One model rank's vocab columns [v0, v0 + cols) of ``lm_logits``:
    its shard of ``lm_head/w`` (or of the tied table), pad columns
    masked as there."""
    if cfg.tie_embeddings:
        w = embed_params["table"].T
    else:
        w = params["w"]
    logits = torch.einsum("...d,dv->...v", x, w).float()
    cols = torch.arange(v0, v0 + w.shape[1], device=x.device)
    return logits - 1e9 * (cols >= cfg.vocab).float()


def softmax_xent(logits, targets, mask=None):
    """logits (..., V) fp32, targets (...) int; mean over ``mask`` (all
    positions when None)."""
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, targets[..., None].long())[..., 0]
    losses = logz - gold
    if mask is None:
        return losses.mean()
    mask = mask.float()
    return (losses * mask).sum() / torch.clamp(mask.sum(), min=1.0)


# ---------------------------------------------------------------------------
# Dense MLP
# ---------------------------------------------------------------------------
def init_mlp(gen, cfg: ModelConfig):
    """Dense-MLP weights (in/out, plus gate for swiglu)."""
    d, f = cfg.d_model, cfg.d_ff
    p = {"w_in": dense_init(gen, d, f, cfg.torch_dtype),
         "w_out": dense_init(gen, f, d, cfg.torch_dtype)}
    if cfg.act == "swiglu":
        p["w_gate"] = dense_init(gen, d, f, cfg.torch_dtype)
    return p


def apply_mlp(params, x, cfg: ModelConfig):
    """Position-wise MLP: gelu (tanh form, as ``jax.nn.gelu``) or swiglu
    per cfg.act."""
    h = x @ params["w_in"]
    if cfg.act == "swiglu":
        h = F.silu(x @ params["w_gate"]) * h
    else:
        h = F.gelu(h, approximate="tanh")
    return h @ params["w_out"]
