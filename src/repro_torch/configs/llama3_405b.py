"""llama3-405b — dense GQA with 128k vocab [arXiv:2407.21783].

Spec: 126L d_model=16384 128H (GQA kv=8) d_ff=53248 vocab=128256: 16
query heads share each kv head, (H/K) * hd = 2048 in decode attention.
"""
from repro_torch.configs.base import (ATTN, AttnConfig, ModelConfig,
                                      register)

CONFIG = register(
    ModelConfig(
        name="llama3-405b",
        family="dense",
        n_layers=126,
        d_model=16384,
        d_ff=53248,
        vocab=128256,
        attn=AttnConfig(n_heads=128, n_kv_heads=8, head_dim=128,
                        rope_theta=500_000.0),
        period=(ATTN,),
        source="arXiv:2407.21783",
    ),
    smoke=ModelConfig(
        name="llama3-405b-smoke",
        family="dense",
        n_layers=2,
        d_model=256,
        d_ff=512,
        vocab=512,
        attn=AttnConfig(n_heads=8, n_kv_heads=2, head_dim=32,
                        rope_theta=500_000.0),
        period=(ATTN,),
        source="arXiv:2407.21783",
    ),
)
