"""h2o-danube-3-4b — dense GQA, llama+mistral mix with SWA [arXiv:2401.16818].

Spec: 24L d_model=3840 32H (GQA kv=8) d_ff=10240 vocab=32000, SWA 4096.
head_dim = 3840/32 = 120, kept faithful: the bf16 prefill takes the
flash kernel's scalar variant (its tensor-core one takes 64 and 128).
"""
from repro_torch.configs.base import (ATTN, AttnConfig, ModelConfig,
                                      register)

CONFIG = register(
    ModelConfig(
        name="h2o-danube-3-4b",
        family="dense",
        n_layers=24,
        d_model=3840,
        d_ff=10240,
        vocab=32000,
        attn=AttnConfig(n_heads=32, n_kv_heads=8, head_dim=120,
                        window=4096, rope_theta=10_000.0),
        period=(ATTN,),
        source="arXiv:2401.16818",
    ),
    smoke=ModelConfig(
        name="h2o-danube-3-4b-smoke",
        family="dense",
        n_layers=2,
        d_model=128,
        d_ff=256,
        vocab=512,
        attn=AttnConfig(n_heads=4, n_kv_heads=2, head_dim=32,
                        window=64, rope_theta=10_000.0),
        period=(ATTN,),
        source="arXiv:2401.16818",
    ),
)
