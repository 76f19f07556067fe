"""Logistic-regression student and the weighted imitation loss (port of
``repro.models.students``: ``lr_*`` and ``_weighted_xent``).

The dense ``tinytf`` and ``mlp`` students are not ported yet (ROADMAP);
the kernel ladder's upper levels live in ``models/kernel_students.py``.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch


@dataclass(frozen=True)
class LRSpec:
    """Logistic-regression student over hashed bag-of-words."""

    n_features: int = 2048
    n_classes: int = 2


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


def _weighted_xent(logits, labels, w):
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.long()[:, None])[:, 0]
    return torch.sum((logz - gold) * w) / torch.clamp(torch.sum(w), min=1.0)


def lr_loss_weighted(params, feats, labels, w):
    """Per-item-weighted xent — the OGD imitation objective shared by the
    sequential cascade and the batched engine."""
    return _weighted_xent(lr_logits(params, feats), labels, w)
