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

import dataclasses
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
    # 'tensor'  : experts replicated, d_ff_expert sharded over 'model'
    # 'expert'  : expert dim sharded over 'model' (requires divisibility)
    sharding_mode: str = "tensor"
    # 'gshard'  : one-hot capacity dispatch einsums (dense, GSPMD friendly)
    # 'ragged'  : sort + lax.ragged_dot grouped matmul (lower dispatch FLOPs)
    dispatch_mode: str = "gshard"


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
    # Sliding-window override applied to *full-attention* layers for the
    # long_500k shape (the assignment's sub-quadratic variant).
    long_context_window: int = 8192
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

    def with_window(self, window: int) -> "ModelConfig":
        """Return a copy whose attention layers use a sliding window."""
        if self.attn is None:
            return self
        return dataclasses.replace(
            self, attn=dataclasses.replace(self.attn, window=window))

    def param_count(self) -> int:
        """Total parameters (embedding + blocks + head + encoder)."""
        d, f, v = self.d_model, self.d_ff, self.vocab
        total = v * d                      # embedding
        if not self.tie_embeddings:
            total += v * d                 # lm head
        per_period = 0
        for i, kind in enumerate(self.period):
            if kind in (ATTN, CROSS):
                a = self.attn
                qkv = (d * a.n_heads * a.head_dim
                       + 2 * d * a.n_kv_heads * a.head_dim)
                out = a.n_heads * a.head_dim * d
                per_period += qkv + out
                if kind == CROSS:          # second attention projection set
                    per_period += qkv + out
            elif kind == MAMBA:
                s = self.ssm
                d_in = s.expand * d
                n_h = d_in // s.head_dim
                # in_proj -> [z, x, B, C, dt], conv, A, D, out_proj
                per_period += d * (2 * d_in + 2 * s.d_state + n_h)
                per_period += s.d_conv * (d_in + 2 * s.d_state)
                per_period += 2 * n_h
                per_period += d_in * d
            # FFN
            if i in self.moe_period_idx and self.moe is not None:
                m = self.moe
                per_period += m.num_experts * (3 * d * m.d_ff_expert)
                per_period += d * m.num_experts          # router
            elif f > 0:
                n_mats = 3 if self.act == "swiglu" else 2
                per_period += n_mats * d * f
            per_period += 2 * d                          # norms
        total += per_period * self.n_periods
        if self.encoder is not None:
            # encoder blocks: self-attn + ffn
            a = self.attn
            enc_block = (d * a.n_heads * a.head_dim
                         + 2 * d * a.n_kv_heads * a.head_dim
                         + a.n_heads * a.head_dim * d
                         + (3 if self.act == "swiglu" else 2) * d * f + 2 * d)
            total += enc_block * self.encoder.n_layers
        return total

    def active_param_count(self) -> int:
        """Parameters active per token (MoE: top_k of num_experts)."""
        if self.moe is None:
            return self.param_count()
        m = self.moe
        inactive_per_moe_layer = ((m.num_experts - m.top_k) * 3
                                  * self.d_model * m.d_ff_expert)
        n_moe_layers = len(self.moe_period_idx) * self.n_periods
        return self.param_count() - inactive_per_moe_layer * n_moe_layers


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
