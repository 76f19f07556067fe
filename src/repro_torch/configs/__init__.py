"""Model configuration dataclasses (subset of ``repro.configs``)."""
from repro_torch.configs.base import ModelConfig, SSMConfig

__all__ = ["ModelConfig", "SSMConfig"]
