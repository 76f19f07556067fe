"""Functional optimizers (port of ``repro.optim``)."""
from repro_torch.optim.optimizers import (
    Optimizer, adam, adamw, clip_by_global_norm, momentum, ogd_sqrt_t, sgd)

__all__ = ["Optimizer", "sgd", "momentum", "adam", "adamw", "ogd_sqrt_t",
           "clip_by_global_norm"]
