"""Plain PyTorch grouped-matmul twin (written from
``repro.kernels.moe_gmm.ref``): ``gmm_ref``.

The CPU path of ``ops.moe_gmm``, the backward of its CUDA path
(``kernels.autograd``) and the version ``chip_smoke.py`` holds the CUDA
kernel against on the card."""
from __future__ import annotations

import torch


def gmm_ref(x, w) -> torch.Tensor:
    """x: (E, C, D); w: (E, D, F) -> (E, C, F), fp32 products, x's dtype."""
    return torch.einsum("ecd,edf->ecf", x.float(), w.float()).to(x.dtype)
