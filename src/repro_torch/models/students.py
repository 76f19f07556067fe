"""Cascade student models (port of ``repro.models.students``).

* ``LogisticRegression`` over hashed bag-of-words features — the paper's
  level-1 model (cost 1 in its units).
* ``MLP`` — a deep tanh classifier over the same hashed bag-of-words.
* ``TinyTransformer`` — a small bidirectional encoder classifier standing
  in for BERT-base/large; the paper's default ladder is ``lr -> tinytf``.

Every student is plain PyTorch (the reference's are plain ``jnp``: no
Pallas kernel), with the reference's functional interface:
  init(gen, spec, device)    -> params (the reference's tree layout)
  predict(params, feats)     -> probability vector (batch, n_classes)
  loss(params, feats, label) -> scalar xent (for the online updates)

The kernel ladder's upper levels live in ``models/kernel_students.py``.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F

from repro_torch.models.layers import dense_init


@dataclass(frozen=True)
class LRSpec:
    """Logistic-regression student over hashed bag-of-words."""

    n_features: int = 2048
    n_classes: int = 2


@dataclass(frozen=True)
class TinyTFSpec:
    """Bidirectional tiny-transformer encoder classifier."""

    vocab: int = 4096          # hashed token ids
    max_len: int = 128
    d_model: int = 128
    n_heads: int = 4
    n_layers: int = 2
    d_ff: int = 256
    n_classes: int = 2


@dataclass(frozen=True)
class MLPSpec:
    """Deep tanh MLP over hashed bag-of-words."""

    n_features: int = 2048
    hidden: int = 1024
    n_layers: int = 4          # hidden layers (tanh)
    n_classes: int = 2


def _to(tree, device):
    """A float32 parameter tree moved to ``device``."""
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, device) for v in tree]
    return tree.to(device=device, dtype=torch.float32)


def _ln(x, scale):
    """The reference's bias-free layer norm: population variance, 1e-6
    inside the rsqrt."""
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.var(x, dim=-1, keepdim=True, unbiased=False)
    return (x - mu) * torch.rsqrt(var + 1e-6) * scale


def _xent(logits, labels):
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.long()[:, None])[:, 0]
    return logz - gold


def _weighted_xent(logits, labels, w):
    return torch.sum(_xent(logits, labels) * w) / torch.clamp(torch.sum(w),
                                                              min=1.0)


# ---------------------------------------------------------------------------
# Logistic regression
# ---------------------------------------------------------------------------
def lr_init(spec: LRSpec, device: torch.device):
    """Zero-initialized weights/bias (convex objective; OGD from 0)."""
    return {"w": torch.zeros((spec.n_features, spec.n_classes),
                             dtype=torch.float32, device=device),
            "b": torch.zeros((spec.n_classes,), dtype=torch.float32,
                             device=device)}


def lr_logits(params, feats):
    """(B, n_features) -> (B, n_classes) affine logits."""
    return feats @ params["w"] + params["b"]


def lr_predict(params, feats):
    """Class probabilities (softmax over the LR logits)."""
    return torch.softmax(lr_logits(params, feats), dim=-1)


def lr_loss(params, feats, labels):
    """Mean xent (the unweighted sequential-reference objective)."""
    return torch.mean(_xent(lr_logits(params, feats), labels))


def lr_loss_weighted(params, feats, labels, w):
    """Per-item-weighted xent — the OGD imitation objective shared by the
    sequential cascade and the batched engine."""
    return _weighted_xent(lr_logits(params, feats), labels, w)


# ---------------------------------------------------------------------------
# Deep MLP over hashed bag-of-words
# ---------------------------------------------------------------------------
def mlp_init(gen: torch.Generator, spec: MLPSpec, device: torch.device):
    """Fan-in-init hidden layers; zero-init classifier head."""
    dims = [spec.n_features] + [spec.hidden] * spec.n_layers
    params = {
        "layers": [{"w": dense_init(gen, d_in, d_out),
                    "b": torch.zeros((d_out,))}
                   for d_in, d_out in zip(dims[:-1], dims[1:])],
        "cls_w": torch.zeros((dims[-1], spec.n_classes)),
        "cls_b": torch.zeros((spec.n_classes,)),
    }
    return _to(params, device)


def mlp_logits(params, feats):
    """Tanh MLP chain -> (B, n_classes) logits."""
    h = feats
    for lp in params["layers"]:
        h = torch.tanh(h @ lp["w"] + lp["b"])
    return h @ params["cls_w"] + params["cls_b"]


def mlp_predict(params, feats):
    """Class probabilities (softmax over the MLP logits)."""
    return torch.softmax(mlp_logits(params, feats), dim=-1)


def mlp_loss_weighted(params, feats, labels, w):
    """Per-item-weighted xent on MLP logits."""
    return _weighted_xent(mlp_logits(params, feats), labels, w)


# ---------------------------------------------------------------------------
# Tiny transformer encoder classifier
# ---------------------------------------------------------------------------
def tinytf_init(gen: torch.Generator, spec: TinyTFSpec,
                device: torch.device):
    """Embed/pos tables + per-layer attn/MLP weights; zero-init head."""
    d, f = spec.d_model, spec.d_ff
    params = {
        "embed": torch.randn((spec.vocab, d), generator=gen) * 0.02,
        "pos": torch.randn((spec.max_len, d), generator=gen) * 0.02,
        "layers": [{
            "wq": dense_init(gen, d, d),
            "wk": dense_init(gen, d, d),
            "wv": dense_init(gen, d, d),
            "wo": dense_init(gen, d, d),
            "w1": dense_init(gen, d, f),
            "w2": dense_init(gen, f, d),
            "ln1": torch.ones((d,)),
            "ln2": torch.ones((d,)),
        } for _ in range(spec.n_layers)],
        "cls_w": torch.zeros((d, spec.n_classes)),
        "cls_b": torch.zeros((spec.n_classes,)),
    }
    return _to(params, device)


def tinytf_logits(params, tokens, spec: TinyTFSpec):
    """tokens: (B, L) int32 hashed ids; 0 = pad (still embedded, masked
    as a key and out of the pool)."""
    B, L = tokens.shape
    mask = tokens > 0
    h = params["embed"][tokens.long()] + params["pos"][None, :L]
    H = spec.n_heads
    hd = spec.d_model // H
    neg = torch.where(mask, 0.0, -1e30)[:, None, None, :]   # (B,1,1,L)
    for lp in params["layers"]:
        x = _ln(h, lp["ln1"])
        q = (x @ lp["wq"]).reshape(B, L, H, hd).transpose(1, 2)
        k = (x @ lp["wk"]).reshape(B, L, H, hd).transpose(1, 2)
        v = (x @ lp["wv"]).reshape(B, L, H, hd).transpose(1, 2)
        # the scale multiplies the dot, as in the reference
        s = q @ k.transpose(-1, -2) * hd ** -0.5 + neg
        att = torch.softmax(s, dim=-1) @ v                  # (B,H,L,hd)
        att = att.transpose(1, 2).reshape(B, L, spec.d_model)
        h = h + att @ lp["wo"]
        x = _ln(h, lp["ln2"])
        h = h + F.gelu(x @ lp["w1"], approximate="tanh") @ lp["w2"]
    # masked mean pool
    m = mask.to(torch.float32)[..., None]
    pooled = (torch.sum(h * m, dim=1)
              / torch.clamp(torch.sum(m, dim=1), min=1.0))
    return pooled @ params["cls_w"] + params["cls_b"]


def tinytf_predict(params, tokens, spec: TinyTFSpec):
    """Class probabilities (softmax over the transformer logits)."""
    return torch.softmax(tinytf_logits(params, tokens, spec), dim=-1)


def tinytf_loss(params, tokens, labels, spec: TinyTFSpec):
    """Mean xent (the unweighted sequential-reference objective)."""
    return torch.mean(_xent(tinytf_logits(params, tokens, spec), labels))


def tinytf_loss_weighted(params, tokens, labels, w, spec: TinyTFSpec):
    """Per-item-weighted xent on tiny-transformer logits."""
    return _weighted_xent(tinytf_logits(params, tokens, spec), labels, w)
