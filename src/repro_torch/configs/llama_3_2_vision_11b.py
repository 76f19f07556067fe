"""llama-3.2-vision-11b — VLM with cross-attention image layers
[hf:meta-llama/Llama-3.2-11B-Vision].

Spec: 40L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=128256, a
cross-attention image layer every 5th layer (8 of 40).  The ViT vision
encoder + projector is the sanctioned stub: the batch's ``image_embeds``
are precomputed patch embeddings (batch, n_image_tokens, d_model).
"""
from repro_torch.configs.base import (ATTN, CROSS, AttnConfig, ModelConfig,
                                      register)

CONFIG = register(
    ModelConfig(
        name="llama-3.2-vision-11b",
        family="vlm",
        n_layers=40,
        d_model=4096,
        d_ff=14336,
        vocab=128256,
        attn=AttnConfig(n_heads=32, n_kv_heads=8, head_dim=128,
                        rope_theta=500_000.0),
        period=(ATTN, ATTN, ATTN, ATTN, CROSS),
        vision_stub=True,
        n_image_tokens=1600,
        source="hf:meta-llama/Llama-3.2-11B-Vision",
    ),
    smoke=ModelConfig(
        name="llama-3.2-vision-11b-smoke",
        family="vlm",
        n_layers=2,
        d_model=128,
        d_ff=256,
        vocab=512,
        attn=AttnConfig(n_heads=4, n_kv_heads=2, head_dim=32,
                        rope_theta=500_000.0),
        period=(ATTN, CROSS),
        vision_stub=True,
        n_image_tokens=16,
        source="hf:meta-llama/Llama-3.2-11B-Vision",
    ),
)
