"""Functional optimizers over dict parameter trees (port of
``repro.optim.optimizers``: ``clip_by_global_norm``, ``sgd``,
``momentum``, ``adam``, ``adamw`` and ``ogd_sqrt_t``).

Interface, as in the reference:
  opt = adamw(lr=1e-3)
  state = opt.init(params)
  params, state = opt.step(params, grads, state)
  params, state = opt.step_k(params, grads, state, k)

States keep the reference's layout — ``{"count": int32}`` for SGD and
OGD, ``{"count", "m"}`` for momentum, ``{"count", "m", "v"}`` for the
Adams — so a reference state tree exported as numpy installs directly
(``repro_torch.bridge``).  ``count`` is a 0-d int32 tensor on the
parameters' device, and the bias corrections ``b ** t`` are computed in
float32 from it, so a step never syncs with the host.  ``torch.optim``
is deliberately not used: its Adam orders the operations differently
and has no ``step_k``.  Updates are applied in float32 and cast back to
each parameter's dtype; the Adams keep their moments in ``state_dtype``
(bfloat16 moments are the memory knob of the reference's largest
fits).  ``clip=`` scales the gradients to a global l2 norm first, in
float32, cast back to each gradient's dtype as in the reference.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Optional

import torch

from repro_torch.tree import tree_leaves, tree_map, tree_unflatten


@dataclass(frozen=True)
class Optimizer:
    """A first-order optimizer as an (init, step, step_k) triple.

    ``step_k(params, grads, state, k)`` collapses k sequential steps on
    the same gradient into one application (EMA decays raised to k,
    schedule counters advanced by k; the parameter update k times one
    step's, exact for SGD and OGD); ``k`` is a 0-d float32 tensor.  The
    batched engine's ``updates_per_tick="scaled"`` mode uses it."""

    init: Callable[[Any], Any]
    step: Callable[[Any, Any, Any], tuple]
    name: str = "opt"
    step_k: Optional[Callable] = None


def _clip_scale(grads, max_norm: float):
    """(scale, pre-clip norm), float32: the factor that brings the global
    l2 norm of ``grads`` to at most ``max_norm``."""
    norm = torch.sqrt(sum(torch.sum(torch.square(g.float()))
                          for g in tree_leaves(grads)))
    return torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0), norm


def _clip_leaf(g, scale):
    return (g.float() * scale).to(g.dtype)


def clip_by_global_norm(grads, max_norm: float):
    """Scale ``grads`` so their global l2 norm is at most ``max_norm``.

    Returns ``(clipped_grads, pre_clip_norm)``; the norm and the scaling
    are float32, each clipped leaf is cast back to its dtype."""
    scale, norm = _clip_scale(grads, max_norm)
    return tree_map(lambda g: _clip_leaf(g, scale), grads), norm


def _clipped(grads, clip: Optional[float]):
    return grads if clip is None else clip_by_global_norm(grads, clip)[0]


def _apply(params, updates):
    return tree_map(lambda p, u: (p.float() + u).to(p.dtype),
                    params, updates)


def _count0(params) -> torch.Tensor:
    leaf = params
    while isinstance(leaf, (dict, list, tuple)):
        leaf = next(iter(leaf.values())) if isinstance(leaf, dict) else leaf[0]
    return torch.zeros((), dtype=torch.int32, device=leaf.device)


def _pow(b: float, t: torch.Tensor) -> torch.Tensor:
    """b ** t in float32 for a 0-d tensor t, on t's device."""
    return torch.pow(torch.tensor(b, dtype=torch.float32, device=t.device),
                     t.float())


def sgd(lr: float, clip: Optional[float] = None) -> Optimizer:
    """Plain SGD (optional global-norm clip); exact ``step_k``."""
    def init(params):
        return {"count": _count0(params)}

    def step(params, grads, state):
        grads = _clipped(grads, clip)
        updates = tree_map(lambda g: -lr * g.float(), grads)
        return _apply(params, updates), {"count": state["count"] + 1}

    def step_k(params, grads, state, k):
        grads = _clipped(grads, clip)
        updates = tree_map(lambda g: -lr * k * g.float(), grads)
        return _apply(params, updates), {
            "count": state["count"] + k.to(torch.int32)}

    return Optimizer(init, step, "sgd", step_k)


def momentum(lr: float, beta: float = 0.9,
             clip: Optional[float] = None) -> Optimizer:
    """Heavy-ball momentum; ``step_k`` is the exact k-fold composition."""
    def init(params):
        return {"count": _count0(params),
                "m": tree_map(lambda p: torch.zeros(
                    p.shape, dtype=torch.float32, device=p.device), params)}

    def step(params, grads, state):
        grads = _clipped(grads, clip)
        m = tree_map(lambda m0, g: beta * m0 + g.float(), state["m"], grads)
        updates = tree_map(lambda m_: -lr * m_, m)
        return _apply(params, updates), {"count": state["count"] + 1, "m": m}

    def step_k(params, grads, state, k):
        grads = _clipped(grads, clip)
        bk = _pow(beta, k)
        # the exact k-step composition with a repeated gradient:
        #   m_j = beta^j m_0 + g (1-beta^j)/(1-beta)
        #   sum_{j=1..k} m_j = m_0 A + g (k - A)/(1-beta),
        #   A = beta (1-beta^k)/(1-beta)
        A = beta * (1.0 - bk) / (1.0 - beta)
        m = tree_map(lambda m0, g: bk * m0 + g.float() * (1.0 - bk)
                     / (1.0 - beta), state["m"], grads)
        updates = tree_map(lambda m0, g: -lr * (A * m0 + g.float()
                                                * (k - A) / (1.0 - beta)),
                           state["m"], grads)
        return _apply(params, updates), {
            "count": state["count"] + k.to(torch.int32), "m": m}

    return Optimizer(init, step, "momentum", step_k)


# elements an Adam leaf update covers at once: a larger leaf is updated
# slice by slice (the same elementwise arithmetic), so the float32
# temporaries of a multi-GB expert weight stay small beside the two
# copies of the optimizer state a functional step holds
_SLICE = 1 << 26


def _sliced(fn, *leaves):
    """``fn(*leaves)`` -> a tuple of tensors shaped like ``leaves[0]``,
    computed over flat slices of ``_SLICE`` elements when the leaf is
    larger (``fn`` is elementwise, so the numbers are the same)."""
    n = leaves[0].numel()
    if n <= _SLICE:
        return fn(*leaves)
    flat = [t.reshape(-1) for t in leaves]
    outs = None
    for s0 in range(0, n, _SLICE):
        part = fn(*(t[s0:s0 + _SLICE] for t in flat))
        if outs is None:
            outs = tuple(torch.empty(n, dtype=o.dtype, device=o.device)
                         for o in part)
        for o, r in zip(outs, part):
            o[s0:s0 + _SLICE] = r
    return tuple(o.view(leaves[0].shape) for o in outs)


def _adam_like(lr, b1, b2, eps, weight_decay, clip, state_dtype, name):
    sdt = getattr(torch, state_dtype)

    def init(params):
        def z(p):
            return torch.zeros(p.shape, dtype=sdt, device=p.device)
        return {"count": _count0(params),
                "m": tree_map(z, params), "v": tree_map(z, params)}

    def apply(params, grads, state, t, d1, d2, scale):
        """One leaf at a time: the EMAs at decays d1 / d2 and the
        parameter step (``scale`` k for ``step_k``, None for ``step``)."""
        bc1 = 1 - _pow(b1, t)
        bc2 = 1 - _pow(b2, t)
        step_lr = lr if scale is None else lr * scale
        clip_scale = _clip_scale(grads, clip)[0] if clip is not None \
            else None

        def leaf(p, g, m0, v0):
            if clip_scale is not None:
                g = _clip_leaf(g, clip_scale)
            m = (d1 * m0.float() + (1 - d1) * g.float()).to(sdt)
            v = (d2 * v0.float() + (1 - d2) * torch.square(g.float())
                 ).to(sdt)
            mh = m.float() / bc1
            vh = v.float() / bc2
            u = -step_lr * mh / (torch.sqrt(vh) + eps)
            if weight_decay:
                u = u - step_lr * weight_decay * p.float()
            return (p.float() + u).to(p.dtype), m, v

        outs = [_sliced(leaf, *x) for x in zip(
            tree_leaves(params), tree_leaves(grads),
            tree_leaves(state["m"]), tree_leaves(state["v"]))]
        new = [tree_unflatten(like, [o[i] for o in outs])
               for i, like in enumerate((params, state["m"], state["v"]))]
        return new[0], {"count": t, "m": new[1], "v": new[2]}

    def step(params, grads, state):
        return apply(params, grads, state, state["count"] + 1, b1, b2, None)

    def step_k(params, grads, state, k):
        # the k-fold EMA recurrence with a repeated gradient
        return apply(params, grads, state,
                     state["count"] + k.to(torch.int32), _pow(b1, k),
                     _pow(b2, k), k)

    return Optimizer(init, step, name, step_k)


def adam(lr: float, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
         clip: Optional[float] = None,
         state_dtype: str = "float32") -> Optimizer:
    """Adam (no weight decay); ``step_k`` composes the EMAs exactly and
    scales the parameter step by k."""
    return _adam_like(lr, b1, b2, eps, 0.0, clip, state_dtype, "adam")


def adamw(lr: float, b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
          weight_decay: float = 0.1, clip: Optional[float] = 1.0,
          state_dtype: str = "float32") -> Optimizer:
    """AdamW (decoupled weight decay); ``step_k`` composes the EMAs
    exactly."""
    return _adam_like(lr, b1, b2, eps, weight_decay, clip, state_dtype,
                      "adamw")


def ogd_sqrt_t(eta0: float, clip: Optional[float] = None) -> Optimizer:
    """Online gradient descent with eta_t = eta0 / sqrt(t) (no-regret)."""
    def init(params):
        return {"count": _count0(params)}

    def step(params, grads, state):
        grads = _clipped(grads, clip)
        t = state["count"] + 1
        eta = eta0 * torch.rsqrt(t.float())
        return (_apply(params, tree_map(lambda g: -eta * g.float(), grads)),
                {"count": t})

    def step_k(params, grads, state, k):
        grads = _clipped(grads, clip)
        t0 = state["count"].float()
        # total step size of k sequential steps at eta0/sqrt(t), via the
        # midpoint integral:  sum_{j=1..k} (t0+j)^-1/2
        #   ~= 2 (sqrt(t0+k+1/2) - sqrt(t0+1/2))
        eta = eta0 * 2.0 * (torch.sqrt(t0 + k + 0.5) - torch.sqrt(t0 + 0.5))
        return (_apply(params, tree_map(lambda g: -eta * g.float(), grads)),
                {"count": state["count"] + k.to(torch.int32)})

    return Optimizer(init, step, "ogd", step_k)
