"""jamba-1.5-large-398b — hybrid Mamba+attention with MoE [arXiv:2403.19887].

Spec: 72L d_model=8192 64H (GQA kv=8) d_ff=24576 vocab=65536, MoE 16
experts top-2, Mamba:attn 1:7 interleave.  The period is 8 blocks — 7
Mamba + 1 attention (index 3) — with MoE replacing the MLP on every other
block, giving 9 periods x 8 = 72 layers and 36 MoE layers (the
reference's configuration, field for field).
"""
from repro_torch.configs.base import (
    ATTN, MAMBA, AttnConfig, MoEConfig, ModelConfig, SSMConfig, register)

_PERIOD = (MAMBA, MAMBA, MAMBA, ATTN, MAMBA, MAMBA, MAMBA, MAMBA)

CONFIG = register(
    ModelConfig(
        name="jamba-1.5-large-398b",
        family="hybrid",
        n_layers=72,
        d_model=8192,
        d_ff=24576,
        vocab=65536,
        attn=AttnConfig(n_heads=64, n_kv_heads=8, head_dim=128,
                        rope_theta=1_000_000.0),
        moe=MoEConfig(num_experts=16, top_k=2, d_ff_expert=24576),
        ssm=SSMConfig(d_state=128, d_conv=4, expand=2, head_dim=64, chunk=256),
        period=_PERIOD,
        moe_period_idx=(1, 3, 5, 7),
        source="arXiv:2403.19887",
    ),
    smoke=ModelConfig(
        name="jamba-1.5-large-398b-smoke",
        family="hybrid",
        n_layers=2,
        d_model=128,
        d_ff=256,
        vocab=512,
        attn=AttnConfig(n_heads=4, n_kv_heads=2, head_dim=32,
                        rope_theta=1_000_000.0),
        moe=MoEConfig(num_experts=4, top_k=2, d_ff_expert=256),
        ssm=SSMConfig(d_state=16, d_conv=4, expand=2, head_dim=32, chunk=32),
        period=(MAMBA, ATTN),
        moe_period_idx=(1,),
        source="arXiv:2403.19887",
    ),
)
