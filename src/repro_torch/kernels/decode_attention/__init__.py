from repro_torch.kernels.decode_attention.ops import (
    decode_attention, decode_attention_partial)

__all__ = ["decode_attention", "decode_attention_partial"]
