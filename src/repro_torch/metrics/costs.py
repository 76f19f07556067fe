"""FLOP cost model for the cascade's students (port of the student
entries of ``repro.metrics.costs``: ``lr``, ``mlp``, ``tinytf``,
``tinytf_flash`` and ``ssm``).

Inference cost is counted in "model cost units" where logistic regression
= 1; ``core.cascade.kernel_cascade_config`` derives the deferral
penalties c_i from these analytic counts, so the port gets the same c_i
as the reference.
"""
from __future__ import annotations

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
