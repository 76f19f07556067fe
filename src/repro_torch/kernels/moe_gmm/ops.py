"""Public grouped-matmul op (port of ``repro.kernels.moe_gmm.ops``):
``moe_gmm``.

A CUDA tensor launches the hand-written kernel (or raises), through
``kernels.autograd`` when the call needs a gradient, whose backward is
the twin's; a CPU tensor runs the plain twin ``ref.gmm_ref``.  There is
no fall-back from one to the other.  A ``meta`` tensor (the dry-run's
count) goes the CUDA tensor's way, through the kernel's shape function
``kernel.moe_gmm_meta``: it holds no data, so this is no fall-back, and
its backward is the twin's on ``meta`` as on the card.  The reference's
``block_*`` arguments are TPU tiling and ``interpret`` is Pallas's
switch, so neither is taken here.  The expert SwiGLU FFN built from
three of these products is ``models/moe.py`` ``_expert_ffn``.
"""
from __future__ import annotations

from repro_torch.kernels.autograd import with_twin_grad
from repro_torch.kernels.moe_gmm.kernel import moe_gmm_cuda, moe_gmm_meta
from repro_torch.kernels.moe_gmm.ref import gmm_ref


def moe_gmm(x, w):
    """Grouped matmul over capacity-bucketed expert tokens:
    x (E, C, D) x w (E, D, F) -> (E, C, F) in x's dtype."""
    if x.device.type != "cpu":
        kernel = moe_gmm_meta if x.is_meta else moe_gmm_cuda
        return with_twin_grad(kernel, gmm_ref, x, w)
    return gmm_ref(x, w)
