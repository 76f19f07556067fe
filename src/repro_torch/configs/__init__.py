"""Model configurations (port of ``repro.configs``; the eight
decoder-only architectures are registered)."""
from repro_torch.configs.base import (
    ATTN, CROSS, MAMBA,
    AttnConfig, ModelConfig, MoEConfig, SSMConfig,
    get_config, get_smoke_config, list_architectures, register,
)

__all__ = [
    "ATTN", "CROSS", "MAMBA",
    "AttnConfig", "ModelConfig", "MoEConfig", "SSMConfig",
    "get_config", "get_smoke_config", "list_architectures", "register",
]
