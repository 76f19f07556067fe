"""mamba2-370m — attention-free SSM via state-space duality [arXiv:2405.21060].

Spec: 48L d_model=1024 (attn-free) d_ff=0 vocab=50280, ssm_state=128,
chunk 256.  Pure Mamba2 blocks (no FFN), tied embeddings.
"""
from repro_torch.configs.base import (MAMBA, ModelConfig, SSMConfig,
                                      register)

CONFIG = register(
    ModelConfig(
        name="mamba2-370m",
        family="ssm",
        n_layers=48,
        d_model=1024,
        d_ff=0,
        vocab=50280,
        ssm=SSMConfig(d_state=128, d_conv=4, expand=2, head_dim=64, chunk=256),
        period=(MAMBA,),
        tie_embeddings=True,
        source="arXiv:2405.21060",
    ),
    smoke=ModelConfig(
        name="mamba2-370m-smoke",
        family="ssm",
        n_layers=2,
        d_model=128,
        d_ff=0,
        vocab=512,
        ssm=SSMConfig(d_state=16, d_conv=4, expand=2, head_dim=32, chunk=32),
        period=(MAMBA,),
        tie_embeddings=True,
        source="arXiv:2405.21060",
    ),
)
