"""Featurizers for cascade students (pure numpy, host-side).

A verbatim copy of ``repro.data.features``: the port may not import the
reference package, and the tests pin the two bit-for-bit."""
from __future__ import annotations

import numpy as np

_HASH_PRIME = 2654435761


def hash_bow(tokens: np.ndarray, n_features: int = 2048) -> np.ndarray:
    """Hashed bag-of-words counts, l2-normalized.  tokens: (L,) int."""
    idx = (tokens.astype(np.int64) * _HASH_PRIME % (1 << 31)) % n_features
    feats = np.bincount(idx, minlength=n_features).astype(np.float32)
    norm = np.linalg.norm(feats)
    return feats / norm if norm > 0 else feats


def hash_ids(tokens: np.ndarray, vocab: int = 4096,
             max_len: int = 128) -> np.ndarray:
    """Hashed token ids for the tiny-transformer student; 0 is pad.

    Only the first ``max_len`` tokens are hashed — everything past the
    truncation point is dropped anyway, and this runs per item in the
    serving hot path."""
    tokens = tokens[:max_len]
    ids = (tokens.astype(np.int64) * _HASH_PRIME % (1 << 31)) % (vocab - 1) + 1
    out = np.zeros((max_len,), np.int32)
    out[:len(ids)] = ids
    return out
