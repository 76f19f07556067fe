"""seamless-m4t-medium — enc-dec multimodal (audio) [arXiv:2308.11596].

Spec: 12L d_model=1024 16H (GQA kv=16) d_ff=4096 vocab=256206, read as
12 encoder + 12 decoder layers (the M4T text decoder is symmetric with
its speech encoder).  The conformer/mel frontend is the sanctioned stub:
the batch's ``frames`` are precomputed frame embeddings.  Decoder layers
carry self + cross attention (the CROSS block kind).
"""
from repro_torch.configs.base import (CROSS, AttnConfig, EncoderConfig,
                                      ModelConfig, register)

CONFIG = register(
    ModelConfig(
        name="seamless-m4t-medium",
        family="encdec",
        n_layers=12,
        d_model=1024,
        d_ff=4096,
        vocab=256206,
        attn=AttnConfig(n_heads=16, n_kv_heads=16, head_dim=64,
                        rope_theta=10_000.0),
        period=(CROSS,),
        encoder=EncoderConfig(n_layers=12, frontend="audio"),
        norm="layernorm",
        act="gelu",
        source="arXiv:2308.11596",
    ),
    smoke=ModelConfig(
        name="seamless-m4t-medium-smoke",
        family="encdec",
        n_layers=2,
        d_model=128,
        d_ff=256,
        vocab=512,
        attn=AttnConfig(n_heads=4, n_kv_heads=4, head_dim=32,
                        rope_theta=10_000.0),
        period=(CROSS,),
        encoder=EncoderConfig(n_layers=2, frontend="audio"),
        norm="layernorm",
        act="gelu",
        source="arXiv:2308.11596",
    ),
)
