"""Functional optimizers (port of ``repro.optim``)."""
from repro_torch.optim.optimizers import Optimizer, adam, ogd_sqrt_t

__all__ = ["Optimizer", "adam", "ogd_sqrt_t"]
