"""Learned deferral functions f_i (port of ``repro.core.deferral``).

Each f_i is a small MLP over the level's predictive distribution: the
descending-sorted probabilities, their max and the entropy normalised by
log C, through tanh to one logit; the final bias starts positive so the
gates start open.  The update combines the calibration MSE against
z = 1[argmax != y*] with the MDP cost gradient p_reach * (mu c_{i+1} - L),
blended by the level's calibration factor (paper Eq. 1 / Eq. 5).  The
gradients come from autograd (``deferral_grads_weighted``).

``reexploration_floor`` keeps the DAgger jump probability above
``beta_floor / sqrt(t)`` so an unbiased trickle of annotations keeps
calibrating every gate (see the reference module's docstring).
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch


@dataclass(frozen=True)
class DeferralSpec:
    """Deferral-MLP shape: input class count, hidden width, init."""

    n_classes: int
    hidden: int = 32
    init_open: float = 2.0       # initial logit -> sigmoid(2.0) ~ 0.88


def reexploration_floor(beta_floor: float, t: int) -> float:
    """Minimum DAgger jump probability after ``t`` consumed items."""
    return beta_floor / math.sqrt(max(t, 1))


def _features(probs: torch.Tensor) -> torch.Tensor:
    """probs: (..., C) -> permutation-robust features (..., C+2)."""
    p = torch.clamp(probs, 1e-9, 1.0)
    sorted_p = torch.sort(p, dim=-1, descending=True).values
    ent = -torch.sum(p * torch.log(p), dim=-1, keepdim=True) \
        / math.log(p.shape[-1])
    mx = torch.amax(p, dim=-1, keepdim=True)
    return torch.cat([sorted_p, mx, ent], dim=-1)


def deferral_init(gen: torch.Generator, spec: DeferralSpec,
                  device: torch.device):
    """Initialize f_i's MLP params from ``gen`` (reference distributions;
    the final bias starts the gate open)."""
    d_in = spec.n_classes + 2
    w1 = torch.randn((d_in, spec.hidden), generator=gen) * (d_in ** -0.5)
    w2 = torch.randn((spec.hidden, 1), generator=gen) * (spec.hidden ** -0.5)
    params = {
        "w1": w1,
        "b1": torch.zeros((spec.hidden,)),
        "w2": w2,
        "b2": torch.full((1,), spec.init_open),
    }
    return {k: v.to(device) for k, v in params.items()}


def deferral_logit(params, probs):
    """Pre-sigmoid deferral score for a (..., C) batch of probs."""
    h = torch.tanh(_features(probs) @ params["w1"] + params["b1"])
    return (h @ params["w2"] + params["b2"])[..., 0]


def deferral_prob(params, probs):
    """Deferral probability f_i(probs) in (0, 1), batched."""
    return torch.sigmoid(deferral_logit(params, probs))


def deferral_update_terms(probs, y, mu_defer_cost: float):
    """(z, mu*c_{i+1} - L_i) for the deferral update, in float32.

    probs: (B, C); y: (B,) int expert labels.  z is the error indicator
    1[argmax(probs) != y]; L_i = -log p_i(y) with p clamped at 1e-9."""
    pred = torch.argmax(probs, dim=-1)
    z = (pred != y).to(torch.float32)
    p_y = torch.gather(probs, -1, y.long()[:, None])[:, 0]
    mcl = mu_defer_cost - (-torch.log(torch.clamp(p_y, min=1e-9)))
    return z, mcl


def deferral_loss_weighted(params, probs, z, reach, mu_cost_minus_loss, w,
                           calibration_factor: float):
    """Combined per-sample objective (Eq. 5 + Eq. 1), per-item weighted."""
    f = deferral_prob(params, probs)
    denom = torch.clamp(torch.sum(w), min=1.0)
    mse = torch.sum(w * torch.square(f - z)) / denom
    cost = torch.sum(w * reach * f * mu_cost_minus_loss) / denom
    cf = calibration_factor
    return cf * mse + (1.0 - cf) * cost


def deferral_grads_weighted(params, probs, z, reach, mu_cost_minus_loss, w,
                            calibration_factor: float):
    """Gradient of ``deferral_loss_weighted`` w.r.t. ``params`` (same
    dict layout)."""
    keys = sorted(params)
    leaves = [params[k].detach().requires_grad_(True) for k in keys]
    with torch.enable_grad():
        loss = deferral_loss_weighted(
            dict(zip(keys, leaves)), probs, z, reach, mu_cost_minus_loss, w,
            calibration_factor)
        grads = torch.autograd.grad(loss, leaves)
    return dict(zip(keys, grads))
