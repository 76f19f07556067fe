"""internlm2-1.8b — dense GQA [arXiv:2403.17297].

Spec: 24L d_model=2048 16H (GQA kv=8) d_ff=8192 vocab=92544.
"""
from repro_torch.configs.base import (ATTN, AttnConfig, ModelConfig,
                                      register)

CONFIG = register(
    ModelConfig(
        name="internlm2-1.8b",
        family="dense",
        n_layers=24,
        d_model=2048,
        d_ff=8192,
        vocab=92544,
        attn=AttnConfig(n_heads=16, n_kv_heads=8, head_dim=128,
                        rope_theta=1_000_000.0),
        period=(ATTN,),
        source="arXiv:2403.17297",
    ),
    smoke=ModelConfig(
        name="internlm2-1.8b-smoke",
        family="dense",
        n_layers=2,
        d_model=128,
        d_ff=512,
        vocab=512,
        attn=AttnConfig(n_heads=4, n_kv_heads=2, head_dim=32,
                        rope_theta=1_000_000.0),
        period=(ATTN,),
        source="arXiv:2403.17297",
    ),
)
