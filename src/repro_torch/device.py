"""Device resolution and float32 numerics for the port.

Every entry point takes a ``device`` argument and resolves it here: the
default is the CUDA card, and a missing card is an error, never a silent
fall-back to the CPU.  ``"cpu"`` runs only when asked for explicitly (the
CPU parity tests do).

The reference computes in IEEE float32, and the port's tolerances assume
the same, so TF32 is switched off for matrix products and for cuDNN when
this module is imported.
"""
from __future__ import annotations

from typing import Optional, Union

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

DeviceLike = Union[None, str, torch.device]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """The device an entry point runs on.

    ``None`` means the CUDA card and raises when CUDA is unavailable;
    any explicit device is honoured as given (a CUDA one is still
    checked for availability)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available: the port runs on the GPU by default; "
            "pass device='cpu' (or --device cpu) to run on the CPU")
    return dev


def canonical_device(device: torch.device) -> torch.device:
    """``device`` with its index: a bare ``cuda`` names the current
    card, so two spellings of one card compare equal."""
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


def sync(device: Optional[torch.device]) -> None:
    """Wait for queued work on ``device`` (a no-op on the CPU)."""
    if device is not None and torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
