"""Assigned input shapes and their ``meta`` stand-ins (port of
``repro.launch.shapes``; ``meta`` tensors take the place of the
reference's ``ShapeDtypeStruct``s: shapes and dtypes, no storage).

Shapes (assignment):
  train_4k      seq=4096    global_batch=256   (training)
  prefill_32k   seq=32768   global_batch=32    (inference prefill)
  decode_32k    seq=32768   global_batch=128   (decode ONE token, cache=seq)
  long_500k     seq=524288  global_batch=1     (long-context decode)

Decode shapes run ``decode_step`` (one new token against a KV cache of
seq_len), never a training step.  ``long_500k`` applies the
sliding-window override (cfg.long_context_window) to full-attention
layers, the assignment's sub-quadratic variant, so every architecture,
pure-attention ones included, takes it.

Enc-dec note: the audio encoder consumes ``seq`` frames; the text decoder
sees seq_len tokens for train, seq//8 for prefill prompts (speech-to-text
length ratio), and the full seq-sized self+cross caches for decode.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer as tf_model


@dataclass(frozen=True)
class InputShape:
    """One dry-run workload: step kind + (batch, seq) dims."""

    name: str
    kind: str          # train | prefill | decode
    seq: int
    batch: int


INPUT_SHAPES: Dict[str, InputShape] = {
    "train_4k": InputShape("train_4k", "train", 4_096, 256),
    "prefill_32k": InputShape("prefill_32k", "prefill", 32_768, 32),
    "decode_32k": InputShape("decode_32k", "decode", 32_768, 128),
    "long_500k": InputShape("long_500k", "decode", 524_288, 1),
}


def needs_long_context_override(cfg: ModelConfig, shape: InputShape) -> bool:
    """long_500k on archs whose attention is full -> apply SWA override."""
    return (shape.name == "long_500k" and cfg.attn is not None
            and cfg.attn.window is None)


def resolve_config(cfg: ModelConfig, shape: InputShape) -> ModelConfig:
    """Apply shape-dependent config overrides (long-context window)."""
    if needs_long_context_override(cfg, shape):
        return cfg.with_window(cfg.long_context_window)
    return cfg


def _meta(shape, dtype):
    return torch.empty(shape, dtype=dtype, device="meta")


def _tok(b, s):
    return _meta((b, s), torch.int32)


def input_specs(cfg: ModelConfig, shape: InputShape) -> dict:
    """``meta`` stand-ins for every model input of this shape.

    Returns kwargs for the step function chosen by ``shape.kind``:
      train   -> {'batch': {...}}
      prefill -> {'batch': {...}}
      decode  -> {'cache': ..., 'tokens': ..., 'pos': ...}
    ``pos`` is a 0-d int32 stand-in, as in the reference; the port's
    ``decode_step`` takes the position as a Python int, which the
    dry-run hands it (``shape.seq - 1``)."""
    cfg = resolve_config(cfg, shape)
    B, S = shape.batch, shape.seq
    dt = cfg.torch_dtype

    def extras(batch, seq):
        out = {}
        if cfg.encoder is not None:
            out["frames"] = _meta((batch, seq, cfg.d_model), dt)
        if cfg.vision_stub:
            out["image_embeds"] = _meta(
                (batch, cfg.n_image_tokens, cfg.d_model), dt)
        return out

    if shape.kind == "train":
        batch = {"tokens": _tok(B, S), "targets": _tok(B, S),
                 **extras(B, S)}
        return {"batch": batch}
    if shape.kind == "prefill":
        dec_len = max(S // 8, 128) if cfg.encoder is not None else S
        batch = {"tokens": _tok(B, dec_len), **extras(B, S)}
        return {"batch": batch}
    if shape.kind == "decode":
        mem_len = cfg.n_image_tokens if cfg.vision_stub else \
            (S if cfg.encoder is not None else 0)
        cache = tf_model.cache_struct(cfg, B, S, memory_len=mem_len)
        return {"cache": cache, "tokens": _tok(B, 1),
                "pos": _meta((), torch.int32)}
    raise ValueError(shape.kind)
