"""Unified model configuration (port of ``repro.configs.base``).

Every architecture is a ``ModelConfig``: a repeating ``period`` of block
kinds, applied ``n_periods`` times, with optional attention, MoE and
Mamba2 settings.  The ported zoo serves all ten architectures:
``ATTN``, ``MAMBA`` and ``CROSS`` blocks with dense-MLP or MoE FFNs, the
encoder of the encoder-decoder model (``EncoderConfig``) and the vision
model's image memory (``vision_stub``).  The kernel ladder's ``ssm``
student drives ``models/ssm.py`` through the same class.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import torch

# Block kinds usable inside a period.
ATTN = "attn"            # self-attention (causal unless encoder)
MAMBA = "mamba"          # Mamba2 / SSD block
CROSS = "cross"          # self-attention + cross-attention (enc-dec / VLM)


@dataclass(frozen=True)
class AttnConfig:
    """Self-attention widths, RoPE and window."""

    n_heads: int
    n_kv_heads: int
    head_dim: int
    qk_norm: bool = False
    window: Optional[int] = None          # sliding-window size; None = full
    rope_theta: float = 500_000.0
    causal: bool = True


@dataclass(frozen=True)
class MoEConfig:
    """Top-k MoE with GShard capacity dispatch."""

    num_experts: int
    top_k: int
    d_ff_expert: int
    capacity_factor: float = 1.25
    load_balance_weight: float = 0.01
    router_z_weight: float = 1e-3


@dataclass(frozen=True)
class SSMConfig:
    """Mamba2 block settings (n_groups = 1)."""

    d_state: int = 128
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64
    chunk: int = 256


@dataclass(frozen=True)
class EncoderConfig:
    """Encoder stack for enc-dec models (seamless-m4t).

    The modality frontend (mel-spectrogram + conv feature extractor) is a
    sanctioned stub: the batch's ``frames`` are precomputed frame
    embeddings of shape (batch, frames, d_model).
    """

    n_layers: int = 12
    frontend: str = "audio"  # 'audio' (frame embeddings) | 'text'


@dataclass(frozen=True)
class ModelConfig:
    """A zoo model: widths, block pattern and numerics."""

    name: str
    family: str                      # dense | moe | hybrid | ssm | encdec | vlm
    n_layers: int
    d_model: int
    d_ff: int
    vocab: int
    attn: Optional[AttnConfig] = None
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    # Repeating block pattern; len(period) must divide n_layers.
    period: Tuple[str, ...] = (ATTN,)
    # Indices within the period whose FFN is MoE (others use dense MLP).
    moe_period_idx: Tuple[int, ...] = ()
    encoder: Optional[EncoderConfig] = None
    # VLM: patch-embedding stub frontend (precomputed patch embeddings).
    vision_stub: bool = False
    n_image_tokens: int = 1024
    norm: str = "rmsnorm"            # rmsnorm | layernorm
    act: str = "swiglu"              # swiglu | gelu
    tie_embeddings: bool = False
    dtype: str = "bfloat16"
    source: str = ""                 # citation

    def __post_init__(self):
        assert self.n_layers % len(self.period) == 0, (
            f"{self.name}: n_layers={self.n_layers} not divisible by "
            f"period {len(self.period)}")

    @property
    def n_periods(self) -> int:
        """How many times the period repeats."""
        return self.n_layers // len(self.period)

    @property
    def torch_dtype(self) -> torch.dtype:
        """The parameter/activation dtype as a ``torch.dtype``."""
        return getattr(torch, self.dtype)


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------
_REGISTRY: dict = {}


def register(config: ModelConfig, smoke: ModelConfig) -> ModelConfig:
    """Record a full config and its smoke-sized twin under its name."""
    _REGISTRY[config.name] = (config, smoke)
    return config


def get_config(name: str) -> ModelConfig:
    """The full config registered under ``name``."""
    if name not in _REGISTRY:
        _load_all()
    return _REGISTRY[name][0]


def get_smoke_config(name: str) -> ModelConfig:
    """The smoke-sized config registered under ``name``."""
    if name not in _REGISTRY:
        _load_all()
    return _REGISTRY[name][1]


def list_architectures() -> list:
    """Names of the registered (ported) architectures."""
    _load_all()
    return sorted(_REGISTRY.keys())


_ARCH_MODULES = [
    "seamless_m4t_medium", "mixtral_8x22b", "jamba_1_5_large_398b",
    "internlm2_1_8b", "h2o_danube_3_4b", "llama_3_2_vision_11b",
    "qwen3_8b", "llama3_405b", "mamba2_370m", "dbrx_132b",
]


def _load_all():
    import importlib
    for mod in _ARCH_MODULES:
        importlib.import_module(f"repro_torch.configs.{mod}")
