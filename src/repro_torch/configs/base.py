"""Model configuration (the subset of ``repro.configs.base`` that
``models/ssm.py`` reads: a Mamba2 stack's widths and its SSD settings).
The zoo's attention, MoE and encoder configs wait for the model-zoo
slice (ROADMAP)."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch


@dataclass(frozen=True)
class SSMConfig:
    """Mamba2 block settings (n_groups = 1)."""

    d_state: int = 128
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64
    chunk: int = 256


@dataclass(frozen=True)
class ModelConfig:
    """A model's widths; only the fields the ported modules read."""

    name: str
    n_layers: int
    d_model: int
    vocab: int
    ssm: Optional[SSMConfig] = None
    dtype: str = "float32"

    @property
    def torch_dtype(self) -> torch.dtype:
        """The parameter/activation dtype as a ``torch.dtype``."""
        return getattr(torch, self.dtype)
