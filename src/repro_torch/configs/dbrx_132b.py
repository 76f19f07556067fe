"""dbrx-132b — fine-grained MoE, 16 experts top-4 [hf:databricks/dbrx-base].

Spec: 40L d_model=6144 48H (GQA kv=8) d_ff=10752 vocab=100352, MoE 16
experts top-4, layernorm.
"""
from repro_torch.configs.base import (ATTN, AttnConfig, MoEConfig,
                                      ModelConfig, register)

CONFIG = register(
    ModelConfig(
        name="dbrx-132b",
        family="moe",
        n_layers=40,
        d_model=6144,
        d_ff=10752,
        vocab=100352,
        attn=AttnConfig(n_heads=48, n_kv_heads=8, head_dim=128,
                        rope_theta=500_000.0),
        moe=MoEConfig(num_experts=16, top_k=4, d_ff_expert=10752),
        period=(ATTN,),
        moe_period_idx=(0,),
        norm="layernorm",
        source="hf:databricks/dbrx-base",
    ),
    smoke=ModelConfig(
        name="dbrx-132b-smoke",
        family="moe",
        n_layers=2,
        d_model=128,
        d_ff=256,
        vocab=512,
        attn=AttnConfig(n_heads=4, n_kv_heads=2, head_dim=32,
                        rope_theta=500_000.0),
        moe=MoEConfig(num_experts=4, top_k=2, d_ff_expert=256),
        period=(ATTN,),
        moe_period_idx=(0,),
        norm="layernorm",
        source="hf:databricks/dbrx-base",
    ),
)
