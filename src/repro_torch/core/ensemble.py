"""Online ensemble learning — the paper's ablation baseline (§4) (port of
``repro.core.ensemble``).

All models run as a linear ensemble with *input-independent* operating
probabilities w_i = softmax(theta)_i (learned online, but no per-input
deferral policy).  Students are continuously updated from expert
annotations, exactly as in the cascade; the expert is consulted at a
decaying probability (the annotation budget knob).  This isolates the
value of the learned deferral policy.

The levels are the cascade's (``build_levels``), so a reference level's
state installs with ``repro_torch.bridge.load_level_state``; every draw
comes from one ``np.random.default_rng(seed + 2)`` in the reference's
order (the expert coin, then each level's cache mini-batch).
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.core.cascade import CascadeConfig, build_levels
from repro_torch.device import DeviceLike, resolve_device


def _f32(theta: np.ndarray) -> np.ndarray:
    # theta is computed in numpy (float64 after an update, as in the
    # reference); its mixture weights are float32, as JAX computes them
    return np.asarray(theta, np.float32)


def _theta_grad(theta: np.ndarray, probs: np.ndarray, y: int) -> np.ndarray:
    """d/dtheta of -log(max(mix[y], 1e-9)), mix = softmax(theta) @ probs
    (float32, on the host)."""
    th = torch.from_numpy(_f32(theta)).requires_grad_(True)
    with torch.enable_grad():
        mix = torch.softmax(th, dim=0) @ torch.from_numpy(probs)
        loss = -torch.log(torch.clamp(mix[y], min=1e-9))
        (g,) = torch.autograd.grad(loss, th)
    return g.numpy()


class OnlineEnsemble:
    """Paper §4 baseline: weighted-majority ensemble, no cascade.  Runs
    on ``device`` (CUDA unless ``device="cpu"``)."""

    def __init__(self, config: CascadeConfig, expert,
                 expert_prob_decay: float = 0.9995,
                 min_expert_prob: float = 0.0,
                 device: DeviceLike = None):
        self.cfg = config
        self.expert = expert
        self.device = resolve_device(device)
        self.levels = build_levels(config, self.device)
        self.rng = np.random.default_rng(config.seed + 2)
        self.theta = np.zeros(len(self.levels), np.float32)
        self.expert_prob = 1.0
        self.decay = expert_prob_decay
        self.min_expert_prob = min_expert_prob
        self.expert_calls = 0
        self.total_cost = 0.0
        self.t = 0

    def _budget_left(self, hard_budget: Optional[int]) -> bool:
        return hard_budget is None or self.expert_calls < hard_budget

    def process(self, idx: int, doc: np.ndarray,
                hard_budget: Optional[int] = None) -> dict:
        """Serve one item: expert w.p. p_t, else weighted majority."""
        self.t += 1
        feats = [lvl.featurize(doc) for lvl in self.levels]
        probs = np.stack([
            lvl._predict(lvl, lvl.params,
                         torch.from_numpy(x).to(self.device)).cpu().numpy()
            for lvl, x in zip(self.levels, feats)])
        w = torch.softmax(torch.from_numpy(_f32(self.theta)), dim=0).numpy()
        mix = w @ probs
        # every ensemble member runs on every input (no deferral)
        cost = sum(lvl.spec.cost for lvl in self.levels)
        expert_called = (self.rng.random() < self.expert_prob
                         and self._budget_left(hard_budget))
        if expert_called:
            y = self.expert.label(idx, doc)
            prediction = y
            self.expert_calls += 1
            cost += self.cfg.expert_cost
            for lvl, x in zip(self.levels, feats):
                lvl.cache_add(x, y)
                lvl.student_update(self.rng)
            eta = 0.5 / np.sqrt(self.t)
            self.theta = self.theta - eta * _theta_grad(self.theta, probs, y)
        else:
            prediction = int(np.argmax(mix))
        self.expert_prob = max(self.expert_prob * self.decay,
                               self.min_expert_prob)
        self.total_cost += cost
        return {"prediction": prediction, "expert_called": expert_called}

    def run(self, stream, hard_budget: Optional[int] = None) -> dict:
        """Serve a whole stream; returns accuracy + expert-call count."""
        preds = np.zeros(len(stream), np.int32)
        for i, doc in enumerate(stream.docs):
            preds[i] = self.process(i, doc, hard_budget)["prediction"]
        labels = stream.labels
        acc = float(np.mean(preds == labels))
        out = {"accuracy": acc, "expert_calls": self.expert_calls,
               "total_cost_units": self.total_cost, "predictions": preds}
        if stream.spec.n_classes == 2:
            pos = labels == 1
            tp = float(np.sum((preds == 1) & pos))
            out["recall"] = tp / max(float(np.sum(pos)), 1.0)
        return out
