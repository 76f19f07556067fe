"""FLOP cost model for the cascade (port of ``repro.metrics.costs``): the
students' analytic FLOPs (``lr``, ``mlp``, ``tinytf``, ``tinytf_flash``,
``ssm``), the expert LLM's prefill and decode FLOPs from its zoo config,
and the deferral penalties built from them (``relative_costs``).

Inference cost is counted in "model cost units" where logistic regression
= 1; ``core.cascade.kernel_cascade_config`` derives the deferral
penalties c_i from these analytic counts, so the port gets the same c_i
as the reference.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

from repro_torch.configs.base import ModelConfig
from repro_torch.models.kernel_students import SSMStudentSpec, TinyTFFlashSpec
from repro_torch.models.students import LRSpec, MLPSpec, TinyTFSpec


def lr_flops(spec: LRSpec, train: bool = False) -> float:
    """Analytic FLOPs of one logistic-regression forward (per item)."""
    f = 2.0 * spec.n_features * spec.n_classes
    return 2.0 * f if train else f     # paper C.1: training ~ 2x inference


def mlp_flops(spec: MLPSpec, train: bool = False) -> float:
    """Analytic FLOPs of one deep-MLP student forward (per item)."""
    h, nl = spec.hidden, spec.n_layers
    f = 2.0 * (spec.n_features * h + (nl - 1) * h * h
               + h * spec.n_classes)
    return 2.0 * f if train else f


def tinytf_flops(spec: TinyTFSpec, train: bool = False) -> float:
    """Analytic FLOPs of one dense tiny-transformer forward (per item)."""
    L, d, f = spec.max_len, spec.d_model, spec.d_ff
    per_layer = (8.0 * L * d * d          # qkvo projections
                 + 4.0 * L * L * d        # scores + AV
                 + 4.0 * L * d * f)       # mlp
    total = per_layer * spec.n_layers + 2.0 * L * d * spec.vocab / spec.vocab
    total += 2.0 * d * spec.n_classes
    return 2.0 * total if train else total


def tinytf_flash_flops(spec: TinyTFFlashSpec, train: bool = False) -> float:
    """Analytic FLOPs of one ``tinytf_flash`` forward (per item): causal
    attention counts ~L^2/2 pairs; the decode readout adds its k/v
    projections and one (1 x L) attention row."""
    L, d, f = spec.max_len, spec.d_model, spec.d_ff
    per_layer = (8.0 * L * d * d          # qkvo projections
                 + 2.0 * L * L * d        # causal scores + AV (~L^2/2 pairs)
                 + 4.0 * L * d * f)       # mlp
    total = per_layer * spec.n_layers
    total += 4.0 * L * d * d              # readout k/v projections
    total += 4.0 * L * d                  # decode readout scores + AV
    total += 2.0 * d * spec.n_classes
    return 2.0 * total if train else total


def ssm_student_flops(spec: SSMStudentSpec, train: bool = False) -> float:
    """Analytic FLOPs of one ``ssm`` student forward (per item): in_proj,
    depthwise conv, intra-chunk scores + outputs, chunk-state build +
    inter-chunk read, gate + out_proj."""
    L, d = spec.max_len, spec.d_model
    d_in = spec.expand * d
    N = spec.d_state
    H = d_in // spec.head_dim
    Lc = min(spec.chunk, L)
    per_block = (2.0 * L * d * (2 * d_in + 2 * N + H)   # in_proj
                 + 2.0 * L * spec.d_conv * (d_in + 2 * N)  # causal conv
                 + 2.0 * L * Lc * (N + d_in)            # intra-chunk SSD
                 + 4.0 * L * N * d_in                   # chunk states in/out
                 + 2.0 * L * d_in * d)                  # out_proj
    total = per_block * spec.n_layers + 2.0 * d * spec.n_classes
    return 2.0 * total if train else total


def _attn_flops(cfg: ModelConfig, q_tokens: float, kv_tokens: float) -> float:
    a = cfg.attn
    if a is None:
        return 0.0
    n_attn = sum(1 for k in cfg.period if k in ("attn", "cross")) \
        * cfg.n_periods
    return 4.0 * q_tokens * kv_tokens * a.n_heads * a.head_dim * n_attn


def expert_prefill_flops(cfg: ModelConfig, length: int) -> float:
    """First-token cost of a classification call (paper App. B.1: prefill
    dominates): 2 * N_active * L plus the attention term (causal: the
    mean kv length of full attention is ~L/2)."""
    a = cfg.attn
    dense = 2.0 * cfg.active_param_count() * length
    if a is None:
        return dense
    kv = min(length, a.window) if a.window else length
    kv_eff = kv if a.window else length / 2.0
    return dense + _attn_flops(cfg, length, kv_eff)


def expert_decode_flops(cfg: ModelConfig, cache_len: int) -> float:
    """Per-token decode cost of the expert at KV-cache length ``cache_len``."""
    a = cfg.attn
    dense = 2.0 * cfg.active_param_count()
    if a is None:
        return dense
    kv = min(cache_len, a.window) if a.window else cache_len
    return dense + _attn_flops(cfg, 1.0, kv)


@dataclass(frozen=True)
class CostModel:
    """Deferral penalties c_i for the MDP, normalized to c_1 (LR) = 1."""
    units: Dict[str, float]

    def cost(self, level_name: str) -> float:
        """The deferral penalty c_i of ``level_name`` in LR units."""
        return self.units[level_name]


def relative_costs(lr_spec: LRSpec, tf_spec: TinyTFSpec,
                   expert_cfg: Optional[ModelConfig] = None,
                   doc_len: int = 256,
                   mlp_spec: Optional[MLPSpec] = None,
                   tf_flash_spec: Optional[TinyTFFlashSpec] = None,
                   ssm_spec: Optional[SSMStudentSpec] = None,
                   extra: Optional[Dict[str, float]] = None) -> CostModel:
    """Build the c_i table (LR = 1) from the analytic per-model FLOPs;
    optional specs add their level kind to the table."""
    base = lr_flops(lr_spec)
    units = {"lr": 1.0, "tinytf": tinytf_flops(tf_spec) / base}
    if mlp_spec is not None:
        units["mlp"] = mlp_flops(mlp_spec) / base
    if tf_flash_spec is not None:
        units["tinytf_flash"] = tinytf_flash_flops(tf_flash_spec) / base
    if ssm_spec is not None:
        units["ssm"] = ssm_student_flops(ssm_spec) / base
    if expert_cfg is not None:
        units["expert"] = expert_prefill_flops(expert_cfg, doc_len) / base
    if extra:
        units.update(extra)
    return CostModel(units=units)
