"""Kernel-backed cascade students (port of
``repro.models.kernel_students``).

* ``tinytf_flash`` — a causal tiny-transformer classifier whose per-layer
  attention runs through ``kernels.flash_attention`` and whose readout is
  a learned-query attention pool through ``kernels.decode_attention``
  (the ring-cache ``pos`` mask excludes pads; position 0 stays valid).
* ``ssm`` — an embedded Mamba2 stack (``models.ssm``) whose inner SSD
  scan runs through ``kernels.ssd_scan``.

``use_kernels=True`` (the serving route pass, ``*_predict``) calls the
public ops, which launch the CUDA kernels on a CUDA tensor and run their
plain twins on a CPU tensor; ``use_kernels=False`` (the imitation loss,
``*_loss_weighted``) runs the differentiable plain composition, as the
reference does — the CUDA kernels have no backward (an op that needs a
gradient on the card differentiates its twin, ``kernels.autograd``).

Shape/dtype contract (float32 activations):
  tokens : (B, L) int32 hashed ids from ``data.features.hash_ids``;
           0 = pad, pads only at the end; L = spec.max_len.
  logits : (B, n_classes) float32.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F

from repro_torch.configs.base import MAMBA, ModelConfig, SSMConfig
from repro_torch.kernels.decode_attention import decode_attention
from repro_torch.kernels.decode_attention.ref import decode_attention_ref
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.flash_attention.ref import attention_ref
from repro_torch.kernels.ssd_scan import ssd_scan
from repro_torch.models.layers import dense_init
from repro_torch.models.ssm import init_mamba, mamba_forward, ssd_chunked
from repro_torch.models.students import _ln, _to, _weighted_xent


@dataclass(frozen=True)
class TinyTFFlashSpec:
    """Causal tiny transformer on the flash/decode kernel path."""

    vocab: int = 4096          # hashed token ids (0 = pad)
    max_len: int = 128
    d_model: int = 128
    n_heads: int = 4
    n_layers: int = 2
    d_ff: int = 256
    n_classes: int = 2
    block_q: int = 64          # reference tiling (kept for the signature)
    block_kv: int = 64


@dataclass(frozen=True)
class SSMStudentSpec:
    """Embedded Mamba2 classifier on the ``ssd_scan`` kernel path."""

    vocab: int = 4096
    max_len: int = 128
    d_model: int = 192
    d_state: int = 32          # N, the SSD state width
    d_conv: int = 4
    expand: int = 2            # d_inner = expand * d_model
    head_dim: int = 64
    chunk: int = 64            # SSD chunk length
    n_layers: int = 2
    n_classes: int = 2


# CI-sized specs, identical to the reference's (the CPU parity tests and
# ``serve --ladder kernel-ci`` run these).
TINY_TF_CI = TinyTFFlashSpec(vocab=256, max_len=32, d_model=32, n_heads=2,
                             n_layers=1, d_ff=64, block_q=16, block_kv=16)
TINY_SSM_CI = SSMStudentSpec(vocab=256, max_len=32, d_model=16, d_state=8,
                             expand=2, head_dim=16, chunk=16, n_layers=1)


# ---------------------------------------------------------------------------
# tinytf_flash: causal transformer, flash-attention layers, decode readout
# ---------------------------------------------------------------------------
def tinytf_flash_init(gen: torch.Generator, spec: TinyTFFlashSpec,
                      device: torch.device):
    """Initialize params from ``gen`` (reference distributions): embed /
    pos tables, per-layer attention + FF, the learned readout query with
    its k/v projections, and a zero classifier head."""
    d, f, H = spec.d_model, spec.d_ff, spec.n_heads
    hd = d // H
    params = {
        "embed": torch.randn((spec.vocab, d), generator=gen) * 0.02,
        "pos": torch.randn((spec.max_len, d), generator=gen) * 0.02,
        "ro_q": torch.randn((H, hd), generator=gen) * 0.02,
        "ro_wk": dense_init(gen, d, d),
        "ro_wv": dense_init(gen, d, d),
        "ln_f": torch.ones((d,)),
        "cls_w": torch.zeros((d, spec.n_classes)),
        "cls_b": torch.zeros((spec.n_classes,)),
        "layers": [{
            "wq": dense_init(gen, d, d),
            "wk": dense_init(gen, d, d),
            "wv": dense_init(gen, d, d),
            "wo": dense_init(gen, d, d),
            "w1": dense_init(gen, d, f),
            "w2": dense_init(gen, f, d),
            "ln1": torch.ones((d,)),
            "ln2": torch.ones((d,)),
        } for _ in range(spec.n_layers)],
    }
    return _to(params, device)


def _causal_attend(q, k, v, spec: TinyTFFlashSpec, use_kernels: bool):
    """One causal attention, (B, L, H, hd) in and out."""
    if use_kernels:
        return flash_attention(q, k, v, causal=True,
                               block_q=spec.block_q, block_kv=spec.block_kv)
    out = attention_ref(q.transpose(1, 2), k.transpose(1, 2),
                        v.transpose(1, 2), causal=True)
    return out.transpose(1, 2)


def _pool_readout(hf, pos_ids, params, spec: TinyTFFlashSpec,
                  use_kernels: bool):
    """Learned-query attention pool over valid positions -> (B, d)."""
    B, L, d = hf.shape
    H = spec.n_heads
    hd = d // H
    k = (hf @ params["ro_wk"]).reshape(B, L, H, hd)
    v = (hf @ params["ro_wv"]).reshape(B, L, H, hd)
    q = params["ro_q"][None, None].expand(B, 1, H, hd)
    if use_kernels:
        pooled = decode_attention(q, k, v, pos_ids,
                                  block_kv=spec.block_kv)[:, 0]
    else:
        pooled = decode_attention_ref(
            q[:, 0].reshape(B, H, 1, hd), k, v, pos_ids).reshape(B, H, hd)
    return pooled.reshape(B, d)


def tinytf_flash_logits(params, tokens, spec: TinyTFFlashSpec,
                        use_kernels: bool = True):
    """tokens: (B, L) int32, 0 = pad (pads at the end) -> (B, C) logits."""
    B, L = tokens.shape
    mask = tokens > 0
    h = params["embed"][tokens.long()] + params["pos"][None, :L]
    H = spec.n_heads
    hd = spec.d_model // H
    for lp in params["layers"]:
        x = _ln(h, lp["ln1"])
        q = (x @ lp["wq"]).reshape(B, L, H, hd)
        k = (x @ lp["wk"]).reshape(B, L, H, hd)
        v = (x @ lp["wv"]).reshape(B, L, H, hd)
        att = _causal_attend(q, k, v, spec, use_kernels)
        h = h + att.reshape(B, L, spec.d_model) @ lp["wo"]
        x = _ln(h, lp["ln2"])
        h = h + F.gelu(x @ lp["w1"], approximate="tanh") @ lp["w2"]
    hf = _ln(h, params["ln_f"])
    # position 0 stays valid even for an empty doc so the readout
    # softmax never sees an all-masked row
    ar = torch.arange(L, device=tokens.device)
    pos_ids = torch.where(mask | (ar == 0)[None], ar[None],
                          torch.full_like(ar, -1)[None])
    pos_ids = pos_ids.expand(B, L).to(torch.int32)
    pooled = _pool_readout(hf, pos_ids, params, spec, use_kernels)
    return pooled @ params["cls_w"] + params["cls_b"]


def tinytf_flash_predict(params, tokens, spec: TinyTFFlashSpec):
    """Softmax class probabilities via the kernel path (route pass)."""
    return torch.softmax(
        tinytf_flash_logits(params, tokens, spec, use_kernels=True), dim=-1)


def tinytf_flash_loss_weighted(params, tokens, labels, w,
                               spec: TinyTFFlashSpec):
    """Per-item-weighted xent on the differentiable plain path."""
    logits = tinytf_flash_logits(params, tokens, spec, use_kernels=False)
    return _weighted_xent(logits, labels, w)


# ---------------------------------------------------------------------------
# ssm: embedded Mamba2 stack on the ssd_scan kernel path
# ---------------------------------------------------------------------------
def ssm_model_config(spec: SSMStudentSpec) -> ModelConfig:
    """The internal ``ModelConfig`` driving ``models.ssm`` for this
    student (one mamba block per layer, float32)."""
    return ModelConfig(
        name="ssm-student", family="ssm", n_layers=spec.n_layers,
        d_model=spec.d_model, d_ff=0, vocab=spec.vocab, period=(MAMBA,),
        ssm=SSMConfig(d_state=spec.d_state, d_conv=spec.d_conv,
                      expand=spec.expand, head_dim=spec.head_dim,
                      chunk=spec.chunk),
        dtype="float32")


def _ssd_kernel_impl(x, adt, dt, B, C, chunk, init_state=None):
    """``ssd_chunked``-shaped adapter over ``kernels.ssd_scan``
    (forward-only: the student never resumes or reads a state)."""
    assert init_state is None, "kernel SSD path is forward-only"
    return ssd_scan(x, adt, dt, B, C, chunk=chunk), None


def ssm_student_init(gen: torch.Generator, spec: SSMStudentSpec,
                     device: torch.device):
    """Initialize params from ``gen``: embed table, per-layer mamba blocks
    + norms, final norm, zero classifier head."""
    cfg = ssm_model_config(spec)
    d = spec.d_model
    params = {
        "embed": torch.randn((spec.vocab, d), generator=gen) * 0.02,
        "blocks": [init_mamba(gen, cfg) for _ in range(spec.n_layers)],
        "norms": [torch.ones((d,)) for _ in range(spec.n_layers)],
        "ln_f": torch.ones((d,)),
        "cls_w": torch.zeros((d, spec.n_classes)),
        "cls_b": torch.zeros((spec.n_classes,)),
    }
    return _to(params, device)


def ssm_student_logits(params, tokens, spec: SSMStudentSpec,
                       use_kernels: bool = True):
    """tokens: (B, L) int32, 0 = pad (pads at the end) -> (B, C) logits.

    Masked-mean pooling over valid positions; the recurrence is causal,
    so trailing pads never feed a valid position's state."""
    cfg = ssm_model_config(spec)
    impl = _ssd_kernel_impl if use_kernels else ssd_chunked
    mask = tokens > 0
    h = params["embed"][tokens.long()]                       # (B, L, d)
    for blk, scale in zip(params["blocks"], params["norms"]):
        h = h + mamba_forward(blk, _ln(h, scale), cfg, ssd_impl=impl)
    hf = _ln(h, params["ln_f"])
    m = mask.to(torch.float32)[..., None]
    pooled = torch.sum(hf * m, dim=1) / torch.clamp(torch.sum(m, dim=1),
                                                    min=1.0)
    return pooled @ params["cls_w"] + params["cls_b"]


def ssm_student_predict(params, tokens, spec: SSMStudentSpec):
    """Softmax class probabilities via the kernel path (route pass)."""
    return torch.softmax(
        ssm_student_logits(params, tokens, spec, use_kernels=True), dim=-1)


def ssm_student_loss_weighted(params, tokens, labels, w,
                              spec: SSMStudentSpec):
    """Per-item-weighted xent on the differentiable plain path."""
    logits = ssm_student_logits(params, tokens, spec, use_kernels=False)
    return _weighted_xent(logits, labels, w)
