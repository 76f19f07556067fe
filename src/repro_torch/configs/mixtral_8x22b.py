"""mixtral-8x22b — sparse MoE with sliding-window attention [arXiv:2401.04088].

Assigned spec: 56L d_model=6144 48H (GQA kv=8) d_ff=16384 vocab=32768,
MoE 8 experts top-2, SWA.  Every layer's FFN is MoE (Mixtral style).
"""
from repro_torch.configs.base import (ATTN, AttnConfig, ModelConfig,
                                      MoEConfig, register)

CONFIG = register(
    ModelConfig(
        name="mixtral-8x22b",
        family="moe",
        n_layers=56,
        d_model=6144,
        d_ff=16384,
        vocab=32768,
        attn=AttnConfig(n_heads=48, n_kv_heads=8, head_dim=128,
                        window=4096, rope_theta=1_000_000.0),
        moe=MoEConfig(num_experts=8, top_k=2, d_ff_expert=16384),
        period=(ATTN,),
        moe_period_idx=(0,),
        source="arXiv:2401.04088",
    ),
    smoke=ModelConfig(
        name="mixtral-8x22b-smoke",
        family="moe",
        n_layers=2,
        d_model=128,
        d_ff=256,
        vocab=512,
        attn=AttnConfig(n_heads=4, n_kv_heads=2, head_dim=32,
                        window=64, rope_theta=1_000_000.0),
        moe=MoEConfig(num_experts=4, top_k=2, d_ff_expert=256),
        period=(ATTN,),
        moe_period_idx=(0,),
        source="arXiv:2401.04088",
    ),
)
