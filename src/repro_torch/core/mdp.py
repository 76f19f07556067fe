"""The paper's episodic MDP (§2): states <x_t, i>, actions Y + defer
(port of ``repro.core.mdp``).

``episode_cost`` evaluates Eq. (1)'s inner sum for one episode given the
per-level deferral probabilities and prediction losses:

  J_t(pi) = sum_i p_pi^{s_{t,i}} * C_pi(s_{t,i})
  C_pi(s_i) = f_i * mu * c_{i+1} + (1 - f_i) * L(pred_i | y_t)

with p_pi^{s_i} = prod_{j<i} f_j (probability of reaching level i).
The final level (the expert) never defers: f_N = 0 by construction.
"""
from __future__ import annotations

import torch


def episode_cost(defer_probs: torch.Tensor, pred_losses: torch.Tensor,
                 defer_costs: torch.Tensor, mu: float):
    """Eq. (1) inner term for one episode; returns (cost, reach).

    defer_probs: (N,) with defer_probs[-1] == 0 (expert outputs).
    pred_losses: (N,) prediction loss L(a_i | y_t) at each level.
    defer_costs: (N,) penalty c_{i+1} paid when deferring *from* level i
                 (last entry unused).
    """
    reach = torch.cat([torch.ones((1,), dtype=defer_probs.dtype,
                                  device=defer_probs.device),
                       torch.cumprod(defer_probs[:-1], dim=0)])
    immediate = (defer_probs * mu * defer_costs
                 + (1.0 - defer_probs) * pred_losses)
    return torch.sum(reach * immediate), reach


def policy_value(defer_probs_seq: torch.Tensor,
                 pred_losses_seq: torch.Tensor,
                 defer_costs: torch.Tensor, mu: float) -> torch.Tensor:
    """J(pi, T): Eq. (1) summed over T episodes ((T, N) inputs)."""
    return torch.sum(torch.stack([
        episode_cost(fs, ls, defer_costs, mu)[0]
        for fs, ls in zip(defer_probs_seq, pred_losses_seq)]))
