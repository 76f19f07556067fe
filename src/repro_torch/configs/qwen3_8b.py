"""qwen3-8b — dense GQA with qk-norm [hf:Qwen/Qwen3-8B].

Spec: 36L d_model=4096 32H (GQA kv=8) d_ff=12288 vocab=151936, qk_norm.
"""
from repro_torch.configs.base import (ATTN, AttnConfig, ModelConfig,
                                      register)

CONFIG = register(
    ModelConfig(
        name="qwen3-8b",
        family="dense",
        n_layers=36,
        d_model=4096,
        d_ff=12288,
        vocab=151936,
        attn=AttnConfig(n_heads=32, n_kv_heads=8, head_dim=128,
                        qk_norm=True, rope_theta=1_000_000.0),
        period=(ATTN,),
        source="hf:Qwen/Qwen3-8B",
    ),
    smoke=ModelConfig(
        name="qwen3-8b-smoke",
        family="dense",
        n_layers=2,
        d_model=128,
        d_ff=256,
        vocab=512,
        attn=AttnConfig(n_heads=4, n_kv_heads=2, head_dim=32,
                        qk_norm=True, rope_theta=1_000_000.0),
        period=(ATTN,),
        source="hf:Qwen/Qwen3-8B",
    ),
)
