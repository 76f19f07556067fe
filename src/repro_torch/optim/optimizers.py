"""Functional optimizers over dict parameter trees (port of
``repro.optim.optimizers``: ``adam`` and ``ogd_sqrt_t``).

Interface, as in the reference:
  opt = adam(lr=1e-3)
  state = opt.init(params)
  params, state = opt.step(params, grads, state)
  params, state = opt.step_k(params, grads, state, k)

States keep the reference's layout — ``{"count": int32, "m": tree,
"v": tree}`` for Adam, ``{"count": int32}`` for OGD — so a reference
state tree exported as numpy installs directly (``repro_torch.bridge``).
``count`` is a 0-d int32 tensor on the parameters' device, and the bias
corrections ``b ** t`` are computed in float32 from it, so a step never
syncs with the host.  ``torch.optim`` is deliberately not used: its Adam
orders the operations differently and has no ``step_k``.  Updates are
applied in float32 and cast back to each parameter's dtype.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Optional

import torch

from repro_torch.tree import tree_map


@dataclass(frozen=True)
class Optimizer:
    """A first-order optimizer as an (init, step, step_k) triple.

    ``step_k(params, grads, state, k)`` collapses k sequential steps on
    the same gradient into one application (EMA decays raised to k,
    schedule counters advanced by k); ``k`` is a 0-d float32 tensor.
    The batched engine's ``updates_per_tick="scaled"`` mode uses it."""

    init: Callable[[Any], Any]
    step: Callable[[Any, Any, Any], tuple]
    name: str = "opt"
    step_k: Optional[Callable] = None


def _apply(params, updates):
    return tree_map(lambda p, u: (p.float() + u).to(p.dtype),
                    params, updates)


def _count0(params) -> torch.Tensor:
    leaf = params
    while isinstance(leaf, (dict, list, tuple)):
        leaf = next(iter(leaf.values())) if isinstance(leaf, dict) else leaf[0]
    return torch.zeros((), dtype=torch.int32, device=leaf.device)


def adam(lr: float, b1: float = 0.9, b2: float = 0.999,
         eps: float = 1e-8) -> Optimizer:
    """Adam (no weight decay, float32 moments); ``step_k`` composes the
    EMAs exactly and scales the parameter step by k."""
    def init(params):
        def z(p):
            return torch.zeros(p.shape, dtype=torch.float32, device=p.device)
        return {"count": _count0(params),
                "m": tree_map(z, params), "v": tree_map(z, params)}

    def _update(params, m, v, t, scale):
        tf = t.float()
        bc1 = 1 - torch.pow(torch.tensor(b1, dtype=torch.float32,
                                         device=tf.device), tf)
        bc2 = 1 - torch.pow(torch.tensor(b2, dtype=torch.float32,
                                         device=tf.device), tf)

        def upd(p, m_, v_):
            mh = m_ / bc1
            vh = v_ / bc2
            if scale is None:
                return -lr * mh / (torch.sqrt(vh) + eps)
            return -lr * scale * mh / (torch.sqrt(vh) + eps)

        return _apply(params, tree_map(upd, params, m, v))

    def step(params, grads, state):
        t = state["count"] + 1
        m = tree_map(lambda m0, g: b1 * m0 + (1 - b1) * g.float(),
                     state["m"], grads)
        v = tree_map(lambda v0, g: b2 * v0 + (1 - b2) * torch.square(g.float()),
                     state["v"], grads)
        return _update(params, m, v, t, None), {"count": t, "m": m, "v": v}

    def step_k(params, grads, state, k):
        t = state["count"] + k.to(torch.int32)
        b1k = torch.pow(torch.tensor(b1, dtype=torch.float32,
                                     device=k.device), k)
        b2k = torch.pow(torch.tensor(b2, dtype=torch.float32,
                                     device=k.device), k)
        m = tree_map(lambda m0, g: b1k * m0 + (1 - b1k) * g.float(),
                     state["m"], grads)
        v = tree_map(lambda v0, g: b2k * v0
                     + (1 - b2k) * torch.square(g.float()),
                     state["v"], grads)
        return _update(params, m, v, t, k), {"count": t, "m": m, "v": v}

    return Optimizer(init, step, "adam", step_k)


def ogd_sqrt_t(eta0: float) -> Optimizer:
    """Online gradient descent with eta_t = eta0 / sqrt(t) (no-regret)."""
    def init(params):
        return {"count": _count0(params)}

    def step(params, grads, state):
        t = state["count"] + 1
        eta = eta0 * torch.rsqrt(t.float())
        return (_apply(params, tree_map(lambda g: -eta * g.float(), grads)),
                {"count": t})

    def step_k(params, grads, state, k):
        t0 = state["count"].float()
        # total step size of k sequential steps at eta0/sqrt(t), via the
        # midpoint integral:  sum_{j=1..k} (t0+j)^-1/2
        #   ~= 2 (sqrt(t0+k+1/2) - sqrt(t0+1/2))
        eta = eta0 * 2.0 * (torch.sqrt(t0 + k + 0.5) - torch.sqrt(t0 + 0.5))
        return (_apply(params, tree_map(lambda g: -eta * g.float(), grads)),
                {"count": state["count"] + k.to(torch.int32)})

    return Optimizer(init, step, "ogd", step_k)
