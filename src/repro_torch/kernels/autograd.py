"""Kernel forwards that carry the plain composition's gradient.

The CUDA kernels compute forwards only, as the TPU kernels they replace
do (``pallas_call`` has no VJP, and the reference's training
differentiates its plain ``jnp`` composition).  ``with_twin_grad`` keeps
that contract on the card: when autograd needs a gradient through the
op, it goes through ``TwinGrad``, whose forward launches the kernel and
saves the inputs, and whose backward re-runs the op's plain twin
(``ref.py``) on those inputs and returns ``torch.autograd.grad`` of it.
Every other call launches the kernel directly.  Either way the forward
is the kernel's: nothing falls back to the twin.

Under ``torch.utils.checkpoint`` the recompute re-enters the forward,
so the kernel launches a second time, and the backward runs the twin:
three forwards' worth of the op in a step.
"""
from __future__ import annotations

from typing import Callable

import torch


def needs_grad(*inputs) -> bool:
    """Whether autograd would record an op on ``inputs`` (tensors or
    None): grad mode is on and one of them requires a gradient."""
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in inputs)


class TwinGrad(torch.autograd.Function):
    """``kernel(*inputs)`` forward, ``twin(*inputs)``'s gradient.

    ``kernel`` and ``twin`` take the same inputs (tensors or None) and
    return a tensor or a tuple of tensors of the same shapes and dtypes.
    """

    @staticmethod
    def forward(ctx, kernel: Callable, twin: Callable, *inputs):
        ctx.twin = twin
        ctx.save_for_backward(*inputs)
        ctx.set_materialize_grads(False)
        return kernel(*inputs)

    @staticmethod
    def backward(ctx, *grads):
        inputs = ctx.saved_tensors
        want = [i for i, t in enumerate(inputs)
                if t is not None and ctx.needs_input_grad[2 + i]]
        with torch.enable_grad():
            xs = [None if t is None else t.detach().requires_grad_(
                i in want) for i, t in enumerate(inputs)]
            outs = ctx.twin(*xs)
            outs = outs if isinstance(outs, tuple) else (outs,)
            pairs = [(o, g) for o, g in zip(outs, grads)
                     if g is not None and o.requires_grad]
            got = (torch.autograd.grad([o for o, _ in pairs],
                                       [xs[i] for i in want],
                                       [g for _, g in pairs],
                                       allow_unused=True)
                   if pairs and want else [None] * len(want))
        out = [None] * len(inputs)
        for i, g in zip(want, got):
            out[i] = g
        return (None, None, *out)


def with_twin_grad(kernel: Callable, twin: Callable, *inputs):
    """``kernel(*inputs)``, through ``TwinGrad`` when a gradient is
    needed (``needs_grad``), so that the output stays on the autograd
    graph with the twin's gradient."""
    if needs_grad(*inputs):
        return TwinGrad.apply(kernel, twin, *inputs)
    return kernel(*inputs)
