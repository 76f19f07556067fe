"""Model configurations (port of ``repro.configs``; all ten of the
zoo's architectures are registered)."""
from repro_torch.configs.base import (
    ATTN, CROSS, MAMBA,
    AttnConfig, EncoderConfig, ModelConfig, MoEConfig, SSMConfig,
    get_config, get_smoke_config, list_architectures, register,
)

__all__ = [
    "ATTN", "CROSS", "MAMBA",
    "AttnConfig", "EncoderConfig", "ModelConfig", "MoEConfig", "SSMConfig",
    "get_config", "get_smoke_config", "list_architectures", "register",
]
